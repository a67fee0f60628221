"""Packed crop store: one binary shard per video instead of many PNGs
(copy of ``mintime_tpu/data/crop_store.py:48-223``, the same on-disk
format, so a pack written by either package reads in the other).

Format (``crops.pack`` inside each video's faces folder, little-endian)::

    b"MTCP" | u8 version | u64 header_len | header JSON | raw uint8 data

Header JSON::

    {"dims": {"width": W, "height": H, "fps": F} | null,
     "entries": [[identity|null, frame, face, h, w, offset], ...]}

``identity`` is the identity-folder name (``null`` for unclustered crops
loose in the video folder), ``offset`` is into the data section, and each
crop is ``h*w*3`` bytes of BGR uint8 (what ``cv2.imread`` returns on the
PNG path, so the two paths give the same pixels).

Writers: :func:`write_pack` (in-memory crops) and :func:`pack_video_dir`
(an existing PNG folder; ``python -m mintime_torch.preprocessing.pack_crops``
maps it over a dataset). Reader: :class:`CropPack`, whose memmap is opened
lazily in each process and which pickles as its path, so loader workers
reopen it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterable, Sequence

import numpy as np

MAGIC = b"MTCP"
VERSION = 1
PACK_NAME = "crops.pack"


def write_pack(
    path: str,
    crops: Iterable[tuple[str | None, int, int, np.ndarray]],
    dims: dict | None = None,
) -> int:
    """Write ``(identity_key|None, frame_idx, face_idx, crop_bgr_uint8)``
    tuples as one pack. Returns the number of crops written."""
    entries = []
    blobs = []
    offset = 0
    for identity, frame, face, crop in crops:
        crop = np.ascontiguousarray(crop, dtype=np.uint8)
        if crop.ndim != 3 or crop.shape[2] != 3:
            raise ValueError(f"crop must be (h, w, 3) uint8, got {crop.shape}")
        h, w = crop.shape[:2]
        entries.append([identity, int(frame), int(face), int(h), int(w), offset])
        blobs.append(crop)
        offset += h * w * 3
    header = json.dumps({"dims": dims, "entries": entries}).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<BQ", VERSION, len(header)))
        f.write(header)
        for blob in blobs:
            f.write(blob.tobytes())
    os.replace(tmp, path)  # atomic: readers never see a half-written pack
    return len(entries)


class CropPack:
    """Read side of the pack. ``entries`` is the raw header list; crops are
    fetched by entry index with :meth:`read` (one memmap slice, no decode)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != MAGIC:
                raise ValueError(f"{path}: not a crop pack (magic {magic!r})")
            version, hlen = struct.unpack("<BQ", f.read(9))
            if version != VERSION:
                raise ValueError(f"{path}: unsupported pack version {version}")
            header = json.loads(f.read(hlen))
        self.dims: dict | None = header["dims"]
        self.entries: list = header["entries"]
        self._data_offset = 4 + 9 + hlen
        self._mm: np.memmap | None = None
        self._mm_pid: int | None = None

    def _data(self) -> np.memmap:
        # lazy + per-process: a memmap created before fork() would share
        # pages safely, but opening per process keeps pickling (spawn mode)
        # and file-handle lifetimes trivial.
        pid = os.getpid()
        if self._mm is None or self._mm_pid != pid:
            self._mm = np.memmap(
                self.path, dtype=np.uint8, mode="r", offset=self._data_offset
            )
            self._mm_pid = pid
        return self._mm

    def __len__(self) -> int:
        return len(self.entries)

    def read(self, index: int) -> np.ndarray:
        """Crop ``index`` as a fresh (h, w, 3) BGR uint8 array."""
        _, _, _, h, w, offset = self.entries[index]
        data = self._data()
        return np.array(data[offset : offset + h * w * 3]).reshape(h, w, 3)

    def __reduce__(self):  # pickle = reopen by path (fork/spawn workers)
        return (CropPack, (self.path,))


def pack_video_dir(video_dir: str, remove_images: bool = False) -> str | None:
    """Convert one video's PNG crop folder (the reference on-disk layout,
    identity subfolders + loose discarded crops) into ``crops.pack``.

    Reads the ``video_dims.json`` sidecar into the pack header when present
    so the pack is self-contained for size buckets. Returns the pack path,
    or None if the folder holds no crops. Idempotent: an existing pack is
    left alone (delete it to re-pack).
    """
    import cv2

    from mintime_torch.data.dataset import (
        _CROP_EXTS,
        _frame_face_of,
        read_sidecar_json,
    )

    pack_path = os.path.join(video_dir, PACK_NAME)
    if os.path.exists(pack_path):
        return pack_path

    def _crops():
        for entry in sorted(os.listdir(video_dir)):
            p = os.path.join(video_dir, entry)
            if os.path.isdir(p):
                for fname in sorted(os.listdir(p)):
                    if fname.lower().endswith(_CROP_EXTS):
                        img = cv2.imread(os.path.join(p, fname))
                        if img is not None:
                            fr, fc = _frame_face_of(fname)
                            yield entry, fr, fc, img
            elif entry.lower().endswith(_CROP_EXTS):
                img = cv2.imread(p)
                if img is not None:
                    fr, fc = _frame_face_of(entry)
                    yield None, fr, fc, img

    sidecar = read_sidecar_json(video_dir)
    dims_dict = None
    if sidecar and "width" in sidecar and "height" in sidecar:
        dims_dict = {"width": int(sidecar["width"]), "height": int(sidecar["height"])}
        if sidecar.get("fps"):
            dims_dict["fps"] = sidecar["fps"]
    n = write_pack(pack_path, _crops(), dims=dims_dict)
    if n == 0:
        os.remove(pack_path)
        return None
    if remove_images:
        for entry in list(os.listdir(video_dir)):
            p = os.path.join(video_dir, entry)
            if os.path.isdir(p):
                for fname in list(os.listdir(p)):
                    if fname.lower().endswith(_CROP_EXTS):
                        os.remove(os.path.join(p, fname))
                if not os.listdir(p):
                    os.rmdir(p)
            elif entry.lower().endswith(_CROP_EXTS):
                os.remove(p)
    return pack_path


def find_pack(video_dir: str) -> str | None:
    p = os.path.join(video_dir, PACK_NAME)
    return p if os.path.exists(p) else None


def image_dims_header(path: str) -> tuple[int, int] | None:
    """(width, height) from the image file header alone, in place of the
    reference's libmagic sniff (deepfakes_dataset.py:114): a few bytes read
    per file, no decode. PNG/BMP/JPEG; None if unparsable.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(32)
            if head[:8] == b"\x89PNG\r\n\x1a\n":  # IHDR at fixed offset
                w, h = struct.unpack(">II", head[16:24])
                return int(w), int(h)
            if head[:2] == b"BM":  # BITMAPINFOHEADER
                w, h = struct.unpack("<ii", head[18:26])
                return int(w), abs(int(h))
            if head[:2] == b"\xff\xd8":  # JPEG: walk markers to SOFn
                f.seek(2)
                while True:
                    marker = f.read(2)
                    if len(marker) < 2 or marker[0] != 0xFF:
                        return None
                    code = marker[1]
                    if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:
                        continue
                    seg = f.read(2)
                    if len(seg) < 2:
                        return None
                    (seglen,) = struct.unpack(">H", seg)
                    if 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8, 0xCC):
                        body = f.read(5)
                        h, w = struct.unpack(">xHH", body)
                        return int(w), int(h)
                    f.seek(seglen - 2, 1)
    except OSError:
        return None
    return None
