"""The on-disk face-crop dataset (counterpart of
``mintime_tpu/data/dataset.py:55-508``).

Reads the reference's layout
(``faces/<split>/<class>/<video>/<identity_k>/<frame>_<face>.png``, with
unclustered crops loose in the video folder) or one ``crops.pack`` shard a
video (:mod:`mintime_torch.data.crop_store`), and gives the reference's
sample contract: fixed-shape frames and side tensors from the host-side
plan of :mod:`mintime_torch.data.assembler`.

A sample is made in two steps, so that a loader's workers do the file work
and the card does the resize: :meth:`DeepfakesDataset.load` (index, plan,
crop reads, size buckets; numpy only) and
:meth:`DeepfakesDataset.transform_crops` (the evaluation transform of
:mod:`mintime_torch.data.augment`, torch on the dataset's ``device``).
``dataset[i]`` does both. The module imports torch only inside the
transform and ``collate`` of frames, so a spawned worker that only loads
starts without it.

As in the JAX package:

* the mask is 0 for dummy slots;
* an identity's mean face size comes from the crop files' headers;
* the original video's frame size, which the size buckets divide by, comes
  from (in this order) an explicit ``video_dims`` mapping, the pack header,
  a ``video_dims.json`` sidecar written by
  :mod:`mintime_torch.preprocessing.extract_crops`, the ``.mp4`` under
  ``video_path`` (the reference's ``<root>/<mode>/<video_id>.mp4`` layout
  with its val → train fallback), then ``default_video_dims``; with none of
  them a sample raises, since a wrong frame size corrupts the size
  embedding.

Only modes ``"val"`` and ``"test"`` exist here: the train-mode
augmentations are ROADMAP.md queue 1 item 4.
"""

from __future__ import annotations

import os
import random as _random
import re
from dataclasses import dataclass
from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np

from mintime_torch.data.assembler import (
    NUM_SIZE_BUCKETS,
    SIZE_EMB_RANGES,
    IdentityFaces,
    build_sequence_plan,
)
from mintime_torch.data.crop_store import CropPack, find_pack, image_dims_header

if TYPE_CHECKING:
    import torch

_FRAME_RE = re.compile(r"^(\d+)_(\d+)")
_CROP_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
DIMS_SIDECAR = "video_dims.json"
MODES = ("train", "val", "test")


def _frame_of(path: str) -> int:
    m = _FRAME_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else 0


def _frame_face_of(name: str) -> tuple[int, int]:
    """(frame_idx, face_idx) from a ``<frame>_<face>.png`` crop name."""
    m = _FRAME_RE.match(os.path.basename(name))
    return (int(m.group(1)), int(m.group(2))) if m else (0, 0)


def read_sidecar_json(video_dir: str) -> dict | None:
    """The ``video_dims.json`` sidecar's dict, or None."""
    import json

    p = os.path.join(video_dir, DIMS_SIDECAR)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_dims_sidecar(video_dir: str) -> tuple[int, int] | None:
    """(width, height) from the ``video_dims.json`` sidecar."""
    d = read_sidecar_json(video_dir)
    if not d:
        return None
    try:
        return int(d["width"]), int(d["height"])
    except (KeyError, ValueError, TypeError):
        return None


def resolve_original_video(video_root: str, faces_dir: str) -> str | None:
    """The original ``.mp4`` of a faces folder, the reference's way:
    ``<video_root>/<mode>/<video_id>[.mp4]`` where ``video_id`` is the part
    of the faces path after the split folder, falling back from val to
    train (deepfakes_dataset.py:194-206)."""
    norm = faces_dir.replace("\\", os.sep)
    mode = next((m for m in MODES if m + os.sep in norm or norm.startswith(m + os.sep)), None)
    if mode is None:
        candidates = [os.path.join(video_root, norm)]
    else:
        video_id = norm.split(mode + os.sep, 1)[1]
        candidates = [os.path.join(video_root, mode, video_id)]
        if mode == "val":
            candidates.append(os.path.join(video_root, "train", video_id))
    for c in candidates:
        for p in (c if c.endswith(".mp4") else c + ".mp4", c):
            if os.path.exists(p) and not os.path.isdir(p):
                return p
    return None


def probe_video_dims(video_file: str) -> tuple[int, int] | None:
    """(width, height) from the container header (deepfakes_dataset.py:250-252)."""
    import cv2

    capture = cv2.VideoCapture(video_file)
    try:
        w = capture.get(cv2.CAP_PROP_FRAME_WIDTH)
        h = capture.get(cv2.CAP_PROP_FRAME_HEIGHT)
    finally:
        capture.release()
    if not w or not h:
        return None
    return int(w), int(h)


@dataclass
class VideoFaces:
    """All face crops of one video, grouped by identity.

    A face *ref* is a crop-image path (PNG layout) or an entry index into
    the video's :class:`~mintime_torch.data.crop_store.CropPack`.
    """

    video_dir: str
    identities: list[IdentityFaces]
    #: face refs per identity, time-sorted to align with IdentityFaces.frames
    faces: dict[str, list]
    #: (frame_idx, ref) of unclustered crops loose in the video folder
    discarded: list


def _image_width(path: str) -> int | None:
    """Crop width from the file header; a full decode only for a header
    that does not parse."""
    dims = image_dims_header(path)
    if dims is not None:
        return dims[0]
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img.shape[1] if img is not None else None


def scan_video_dir(video_dir: str) -> VideoFaces:
    """One video folder as identity groups and loose (discarded) crops
    (deepfakes_dataset.py:123-139). ``mean_side`` is the mean header width
    over the identity's crops; crops sort by frame, then file name."""
    identities: list[IdentityFaces] = []
    faces: dict[str, list] = {}
    discarded: list = []
    for entry in sorted(os.listdir(video_dir)):
        p = os.path.join(video_dir, entry)
        if not os.path.isdir(p):
            if entry.lower().endswith(_CROP_EXTS):
                discarded.append((_frame_of(entry), p))
            continue
        crops = sorted(
            (os.path.join(p, f) for f in os.listdir(p) if f.lower().endswith(_CROP_EXTS)),
            key=lambda c: (_frame_of(c), os.path.basename(c)),
        )
        if not crops:
            continue
        sides = [w for c in crops if (w := _image_width(c)) is not None]
        identities.append(IdentityFaces(
            key=entry,
            frames=[_frame_of(c) for c in crops],
            mean_side=float(np.mean(sides)) if sides else 0.0,
        ))
        faces[entry] = crops
    if not identities and discarded:
        # no clustered identities: the loose crops are one identity
        crops = sorted((p for _, p in discarded),
                       key=lambda c: (_frame_of(c), os.path.basename(c)))
        identities.append(IdentityFaces(key=os.path.basename(video_dir),
                                        frames=[_frame_of(c) for c in crops], mean_side=0.0))
        faces[identities[0].key] = crops
        discarded = []
    return VideoFaces(video_dir, identities, faces, discarded)


def video_faces_from_pack(pack: CropPack, video_dir: str) -> VideoFaces:
    """The identity index from a ``crops.pack`` header: no directory walk and
    no image header reads (the widths are in the header)."""
    groups: dict[str, list[tuple[int, int, int]]] = {}  # key → (frame, idx, w)
    discarded: list = []
    for i, (ident, frame, face, h, w, off) in enumerate(pack.entries):
        if ident is None:
            discarded.append((int(frame), i))
        else:
            groups.setdefault(ident, []).append((int(frame), i, int(w)))
    identities: list[IdentityFaces] = []
    faces: dict[str, list] = {}
    for key in sorted(groups):
        items = sorted(groups[key], key=lambda t: t[0])
        identities.append(IdentityFaces(key=key, frames=[t[0] for t in items],
                                        mean_side=float(np.mean([t[2] for t in items]))))
        faces[key] = [t[1] for t in items]
    if not identities and discarded:
        items = sorted(discarded, key=lambda t: t[0])
        identities.append(IdentityFaces(key=os.path.basename(video_dir),
                                        frames=[t[0] for t in items], mean_side=0.0))
        faces[identities[0].key] = [t[1] for t in items]
        discarded = []
    return VideoFaces(video_dir, identities, faces, discarded)


def merge_discarded(vf: VideoFaces) -> VideoFaces:
    """Merge loose crops into identity 0 for the frames it lacks, one crop a
    missing frame, the first in frame order (deepfakes_dataset.py:227-235)."""
    if not vf.discarded or not vf.identities:
        return vf
    first = vf.identities[0]
    have = set(first.frames)
    extra = []
    for f, r in vf.discarded:
        if f not in have:
            extra.append((f, r))
            have.add(f)
    if not extra:
        return vf
    pairs = sorted(list(zip(first.frames, vf.faces[first.key])) + extra, key=lambda t: t[0])
    new_first = IdentityFaces(key=first.key, frames=[f for f, _ in pairs],
                              mean_side=first.mean_side)
    faces = dict(vf.faces)
    faces[first.key] = [r for _, r in pairs]
    return VideoFaces(vf.video_dir, [new_first] + vf.identities[1:], faces, vf.discarded)


@dataclass
class VideoIndex:
    """One video's cached state: the identity index (loose crops merged),
    the crop pack if any, and the original frame size. Built once a video
    and reused across epochs."""

    vf: VideoFaces
    pack: CropPack | None
    dims: tuple[int, int] | None

    def read(self, identity_key: str, face_index: int) -> np.ndarray | None:
        ref = self.vf.faces[identity_key][face_index]
        if isinstance(ref, int):
            return self.pack.read(ref)
        import cv2

        return cv2.imread(ref)


class DeepfakesDataset:
    """Map-style dataset with the reference's sample contract
    (deepfakes_dataset.py:338-341): ``dataset[i]`` is a dict of

    ``frames (F, S, S, 3)`` uint8 tensor on ``device``, ``size_embedding
    (F,) int32``, ``mask (F,) bool``, ``identities_mask (F, F) bool``,
    ``positions (1 + F*P,) int32``, ``labels`` float32, plus ``video_id``,
    ``tokens_per_identity`` and ``multiclass_label`` in test mode (numpy
    and Python values).

    ``device`` is where the evaluation transform runs (default the card,
    which raises without one). It is kept as a string, so that the dataset
    unpickles without torch in a loader's spawned worker.
    """

    def __init__(
        self,
        videos: Sequence[str],
        labels: Sequence[float],
        data_path: str = "",
        image_size: int = 224,
        num_frames: int = 16,
        num_patches: int = 49,
        max_identities: int = 2,
        mode: str = "test",
        identities_ordering: int = 0,
        multiclass_labels: Sequence[float] | None = None,
        video_dims: Mapping[str, tuple[int, int]] | None = None,
        video_path: str | None = None,
        default_video_dims: tuple[int, int] | None = None,
        seed: int = 42,
        device: str | torch.device = "cuda",
    ):
        if mode == "train":
            raise ValueError(
                "mode 'train' needs the train-mode augmentations "
                "(mintime_tpu/data/augment.py:713-760), which are not ported yet: ROADMAP.md "
                "queue 1 item 4; modes 'val' and 'test' run the evaluation transform")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
        self.videos = list(videos)
        self.labels = list(labels)
        self.multiclass_labels = multiclass_labels
        self.data_path = data_path
        self.image_size = image_size
        self.num_frames = num_frames
        self.num_patches = num_patches
        self.max_identities = max_identities
        self.mode = mode
        self.identities_ordering = identities_ordering
        self.video_dims = dict(video_dims or {})
        self.video_path = video_path
        self.default_video_dims = default_video_dims
        self.seed = seed
        self.device = str(device)
        #: per-video index, built lazily or by preload_index, reused across epochs
        self._index: dict[int, VideoIndex] = {}

    def __len__(self):
        return len(self.videos)

    def _build_index(self, index: int) -> VideoIndex:
        video_rel = self.videos[index]
        video_dir = os.path.join(self.data_path, video_rel)
        pack_path = find_pack(video_dir)
        pack = CropPack(pack_path) if pack_path else None
        vf = video_faces_from_pack(pack, video_dir) if pack is not None else scan_video_dir(video_dir)
        # the original frame size: mapping → pack header → sidecar → .mp4 → default
        dims = self.video_dims.get(video_rel)
        if dims is None and pack is not None and pack.dims:
            dims = (int(pack.dims["width"]), int(pack.dims["height"]))
        if dims is None:
            dims = read_dims_sidecar(video_dir)
        if dims is None and self.video_path:
            orig = resolve_original_video(self.video_path, video_rel)
            if orig is not None:
                dims = probe_video_dims(orig)
        if dims is None:
            dims = self.default_video_dims
        if dims is not None:
            self.video_dims[video_rel] = dims
        return VideoIndex(vf=merge_discarded(vf), pack=pack, dims=dims)

    def get_index(self, index: int) -> VideoIndex:
        vi = self._index.get(index)
        if vi is None:
            vi = self._index[index] = self._build_index(index)
        return vi

    def preload_index(self, workers: int = 8) -> None:
        """Build every video's index up front on a thread pool (listdir and
        header reads), so a loader's workers receive it with the dataset."""
        from concurrent.futures import ThreadPoolExecutor

        missing = [i for i in range(len(self.videos)) if i not in self._index]
        if not missing:
            return
        with ThreadPoolExecutor(max(1, workers)) as pool:
            for i, vi in zip(missing, pool.map(self._build_index, missing)):
                self._index[i] = vi

    def _video_area(self, video_rel: str, vi: VideoIndex) -> float:
        """w * h / 2 of the original video (deepfakes_dataset.py:253)."""
        if vi.dims is None:
            raise ValueError(
                f"unknown original video dimensions for {video_rel!r}: size "
                "embeddings need the frame area (deepfakes_dataset.py:250-253)."
                " Provide video_dims, a video_dims.json sidecar (written by"
                " extract_crops), --video_path to the original videos, or"
                " default_video_dims to opt into a fixed assumption."
            )
        return float(vi.dims[0]) * float(vi.dims[1]) / 2.0

    def load(self, index: int) -> dict:
        """The sample with ``crops`` (``F`` BGR uint8 arrays of any size, a
        black ``S`` x ``S`` square in each dummy slot) in place of
        ``frames``: the file work only, no torch."""
        video_rel = self.videos[index]
        vi = self.get_index(index)
        rng = np.random.default_rng((self.seed, index))
        plan = build_sequence_plan(
            vi.vf.identities,
            num_frames=self.num_frames,
            num_patches=self.num_patches,
            max_identities=self.max_identities,
            ordering=self.identities_ordering,
            parity=index,
            rng=_random.Random(int(rng.integers(2**31))),
        )
        blank = np.zeros((self.image_size, self.image_size, 3), np.uint8)
        crops = []
        size_embeddings = np.zeros(self.num_frames, np.int32)
        video_area = None
        for slot in range(self.num_frames):
            fi = plan.face_index[slot]
            if fi < 0:
                crops.append(blank)
                continue
            img = vi.read(plan.identity_keys[plan.identity_index[slot]], fi)
            if img is None:
                img = blank
            if video_area is None:
                video_area = self._video_area(video_rel, vi)
            # size bucket of the face / frame area ratio (deepfakes_dataset.py:250-263)
            face_area = img.shape[0] * img.shape[1] / 2.0
            size_embeddings[slot] = _bucket_of(int(face_area * 100.0 / video_area))
            crops.append(img)
        sample = {
            "crops": crops,
            "size_embedding": size_embeddings,
            "mask": plan.mask,
            "identities_mask": plan.identities_mask,
            "positions": plan.positions,
            "labels": np.float32(self.labels[index]),
        }
        if self.mode == "test":
            sample["video_id"] = video_rel.replace("/", "_")
            sample["tokens_per_identity"] = plan.tokens_per_identity
            if self.multiclass_labels is not None:
                sample["multiclass_label"] = self.multiclass_labels[index]
        return sample

    def transform_crops(self, crops: Sequence[Sequence[np.ndarray]]) -> torch.Tensor:
        """``B`` samples' crops through the evaluation transform in one call:
        ``(B, F, S, S, 3)`` uint8 on the dataset's device."""
        from mintime_torch.data.augment import create_val_transform

        flat = [c for sample in crops for c in sample]
        out = create_val_transform(self.image_size)(flat, self.device)
        return out.reshape((len(crops), -1) + out.shape[1:])

    def __getitem__(self, index: int) -> dict:
        sample = self.load(index)
        sample["frames"] = self.transform_crops([sample.pop("crops")])[0]
        return sample


def _bucket_of(ratio: int) -> int:
    """1-based 5%-bucket of an integer percentage ratio (SIZE_EMB_DICT)."""
    for i, (lo, hi) in enumerate(SIZE_EMB_RANGES):
        if lo <= ratio <= hi:
            return i + 1
    return NUM_SIZE_BUCKETS


def collate(samples: Sequence[dict]) -> dict:
    """Stack samples into a batch dict: ``frames`` tensors with
    ``torch.stack``, ``crops`` as a list of each sample's list, the side
    arrays with ``np.stack``."""
    batch = {k: np.stack([s[k] for s in samples])
             for k in ("size_embedding", "mask", "identities_mask", "positions")
             if k in samples[0]}
    if "frames" in samples[0]:
        import torch

        frames = [s["frames"] for s in samples]
        batch["frames"] = (torch.stack(frames) if isinstance(frames[0], torch.Tensor)
                           else np.stack(frames))
    if "crops" in samples[0]:
        batch["crops"] = [s["crops"] for s in samples]
    batch["labels"] = np.asarray([s["labels"] for s in samples], np.float32)
    if "video_id" in samples[0]:
        batch["video_id"] = [s["video_id"] for s in samples]
        batch["tokens_per_identity"] = [s["tokens_per_identity"] for s in samples]
    if "multiclass_label" in samples[0]:
        batch["multiclass_label"] = np.asarray([s["multiclass_label"] for s in samples],
                                               np.float32)
    return batch
