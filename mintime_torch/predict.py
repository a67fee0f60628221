"""End-to-end video inference, the product API (counterpart of
``mintime_tpu/predict.py:50-582``).

decode → detect → square crops (one a second) → embed and cluster into
identities → adaptive sequence assembly → classifier forward with the last
layer's CLS attentions → sigmoid probability and per-identity attention.
The detector and embedder are the caller's: the port's own are
:class:`mintime_torch.preprocessing.mtcnn.MTCNNDetector` (its
``input_scale`` and ``channel_order`` choose the decode) and
:class:`mintime_torch.preprocessing.cluster_faces.FaceEmbedder`.

``model`` is a :class:`mintime_torch.models.classifier.MintimeVideoClassifier`
built with ``require_attention=True``; ``state`` is an optional mapping of
parameter and buffer names to tensors on the model's device, used through
``torch.func.functional_call`` in place of the model's own (the counterpart
of the JAX package's ``variables``), or None for the model's own weights.

:func:`predict_videos` pipelines detection across videos as the JAX
package does (:func:`_stage_videos_pipelined`): video i+1 is decoded and its
stage 1 enqueued on the device before video i's host stages run. Each
batch's forward runs as soon as the batch is staged, so at most one batch of
assembled videos and one video of lookahead are held at once; the JAX package
stages the whole run before the first forward.

:func:`stage_decoded` takes a video's frames already decoded, so everything
after the decode (detection, crops, clustering, the evaluation transform on
the device) runs without cv2; :func:`stage_decoded_pipelined` is its
pipelined form over a stream of videos, and :func:`predict_staged` the batch
logic of :func:`predict_videos` over either. ``python -m
mintime_torch.predict`` is the reference's predict CLI (:func:`main`).
"""

from __future__ import annotations

import functools
import itertools
import os
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from mintime_torch.config import MintimeConfig
from mintime_torch.data.assembler import IdentityFaces, build_sequence_plan, size_bucket
from mintime_torch.data.augment import create_val_transform
from mintime_torch.device import resolve_device
from mintime_torch.preprocessing.cluster_faces import connected_components
from mintime_torch.preprocessing.detect_faces import _validate_channel_order
from mintime_torch.preprocessing.extract_crops import pick_detection_frame, square_crop
from mintime_torch.preprocessing.mtcnn import one_ahead
from mintime_torch.utils import profiling
from mintime_torch.utils.attention_viz import aggregate_attentions_batch, draw_border
from mintime_torch.utils.profiling import span

_INPUT_KEYS = ("frames", "mask", "identities_mask", "size_embedding", "positions")
#: numbers :func:`predict_assembled`'s calls, for their root spans
_calls = itertools.count()


@dataclass
class PredictionResult:
    probability: float  # sigmoid fake-probability
    identity_attentions: list[float]
    aggregated_attentions: list[np.ndarray]
    identities: dict  # identity key → list[(frame_idx, face_idx, crop, bbox)]
    frames_per_identity: list[int]
    plan: Any = None


def decode_for_predict(video_path: str, crop_step: int | None = None,
                       channel_order: str = "rgb", resize_on_device: bool = False):
    """One decode pass for both stages: half-res frames for detection (RGB or
    BGR as the detector declares; full-res BGR with ``resize_on_device``)
    and the full-res BGR frames one crop step apart.

    Returns ``(det_frames, full_frames: dict[idx → BGR], fps)``.
    """
    import cv2

    _validate_channel_order(channel_order)
    if resize_on_device and channel_order != "bgr":
        raise ValueError("resize_on_device implies the device-side channel swap too; "
                         "construct the detector with channel_order='bgr'")
    cap = cv2.VideoCapture(video_path)
    fps = int(cap.get(cv2.CAP_PROP_FPS)) or 30
    step = max(crop_step or fps, 1)
    half, full = [], {}
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % step == 0:
            full[i] = frame
        if resize_on_device:
            half.append(frame)
        else:
            small = cv2.resize(frame, (frame.shape[1] // 2, frame.shape[0] // 2))
            if channel_order == "rgb":
                small = cv2.cvtColor(small, cv2.COLOR_BGR2RGB)
            half.append(small)
        i += 1
    cap.release()
    return half, full, fps


def _boxes(indices: Sequence[int], per_frame: Sequence[np.ndarray]) -> dict:
    """The boxes dict of the detections ``per_frame`` of frames ``indices``."""
    return {str(i): det[:, :4].tolist() if len(det) else None
            for i, det in zip(indices, per_frame)}


def detect_on_frames(frames: Sequence[np.ndarray], detector, every_n: int = 1) -> dict:
    """Run the detector over every ``every_n``-th frame → boxes dict."""
    indices = list(range(0, len(frames), every_n))
    if hasattr(detector, "detect_batch"):
        per_frame = detector.detect_batch([frames[i] for i in indices])
    else:
        per_frame = [detector.detect(frames[i]) for i in indices]
    return _boxes(indices, per_frame)


def detect_video_faces(video_path: str, detector, every_n: int = 1) -> tuple[dict, int, tuple]:
    """Half-resolution detection over a video file's frames. Returns
    ``(boxes dict, fps, (width, height))``: the boxes in half-resolution
    coordinates, the width and height twice the half-resolution frame's."""
    from mintime_torch.preprocessing.detect_faces import decode_half_res

    frames, fps = decode_half_res(video_path,
                                  channel_order=getattr(detector, "channel_order", "rgb"))
    if not frames:
        raise ValueError(f"could not decode {video_path}")
    boxes = detect_on_frames(frames, detector, every_n)
    if not any(v for v in boxes.values()):
        raise ValueError("No faces found.")
    h, w = frames[0].shape[:2]
    return boxes, fps, (w * 2, h * 2)


def crops_from_frames(full_frames: dict, boxes: dict, fps: int):
    """One square crop a second per face, from pre-decoded full-res frames."""
    crops = []  # (frame_idx, face_idx, crop_bgr, bbox_half_res)
    step = max(fps, 1)
    for i in sorted(full_frames):
        det = pick_detection_frame(boxes, i, step)
        if det is None:
            continue
        for j, bbox in enumerate(boxes[str(det)] or []):
            crop = square_crop(full_frames[i], bbox)
            if crop.size:
                crops.append((i, j, crop, bbox))
    return crops


def extract_video_crops(video_path: str, boxes: dict, fps: int):
    """Square crops of a video file given its (half-res) boxes; only the
    frames one crop step apart are retrieved after decoding."""
    import cv2

    capture = cv2.VideoCapture(video_path)
    step = max(fps, 1)
    full: dict[int, np.ndarray] = {}
    i = 0
    while capture.grab():
        if i % step == 0:
            ok, frame = capture.retrieve()
            if ok:
                full[i] = frame
        i += 1
    capture.release()
    return crops_from_frames(full, boxes, fps)


def cluster_crops(crops, embedder, threshold: float = 0.45):
    """Identity clustering of one video's crops: embeddings → dot-product
    similarity → connected components over edges above ``threshold``."""
    if not crops:
        return {}, []
    embeddings = embedder([c[2] for c in crops])
    sims = embeddings @ embeddings.T
    components = connected_components(sims, threshold)
    identities = {k: [crops[i] for i in comp] for k, comp in enumerate(components)}
    clustered = {i for comp in components for i in comp}
    discarded = [crops[i] for i in range(len(crops)) if i not in clustered]
    if not identities:  # no clusters: everything becomes identity 0
        identities = {0: list(crops)}
        discarded = []
    return identities, discarded


def assemble_inputs(identities: dict, video_dims, cfg: MintimeConfig,
                    device: str | torch.device = "cuda"):
    """Fixed-shape model inputs (batch axis 1) from one video's identity
    crops: the frames through the evaluation transform on ``device`` (a uint8
    tensor there; the model casts), the rest numpy."""
    m = cfg.model
    infos, crop_store = [], {}
    for key, items in identities.items():
        items = sorted(items, key=lambda t: (t[0], t[1]))
        infos.append(IdentityFaces(
            key=str(key), frames=[t[0] for t in items],
            mean_side=float(np.mean([t[2].shape[1] for t in items])),  # mean crop width
        ))
        crop_store[str(key)] = items
    plan = build_sequence_plan(infos, num_frames=m.num_frames, num_patches=m.num_patches,
                               max_identities=m.max_identities, ordering=0, parity=1)

    transform = create_val_transform(m.image_size)
    frames = []
    size_embeddings = np.zeros(m.num_frames, np.int32)
    vw, vh = video_dims
    for slot in range(m.num_frames):
        fi = plan.face_index[slot]
        if fi < 0:
            frames.append(np.zeros((m.image_size, m.image_size, 3), np.uint8))
            continue
        key = plan.identity_keys[plan.identity_index[slot]]
        crop = crop_store[key][fi][2]
        # the predict path halves the video area but not the face area
        size_embeddings[slot] = size_bucket(crop.shape[0], crop.shape[1], vh, vw,
                                            legacy_predict_double_ratio=True)
        frames.append(crop)
    return {
        "frames": transform(frames, device)[None],
        "mask": plan.mask[None],
        "identities_mask": plan.identities_mask[None],
        "size_embedding": size_embeddings[None],
        "positions": plan.positions[None],
    }, plan, crop_store


def stage_decoded(half: Sequence[np.ndarray], full: dict, fps: int, detector, embedder,
                  cfg: MintimeConfig, similarity_threshold: float = 0.45, every_n: int = 1,
                  device: str | torch.device = "cuda"):
    """The stages after the decode for one video: detect on ``half`` (as
    :func:`decode_for_predict` returns them for the detector) → crops from
    the full-resolution frames ``full`` → identities → inputs assembled on
    ``device``. Returns what :func:`assemble_inputs` returns."""
    if not half:
        raise ValueError("the video has no frames")
    return _stage_detected(detect_on_frames(half, detector, every_n), half[0].shape, full, fps,
                           detector, embedder, cfg, similarity_threshold, device)


def _stage_detected(boxes: dict, frame_shape, full: dict, fps: int, detector, embedder,
                    cfg: MintimeConfig, similarity_threshold: float,
                    device: str | torch.device):
    """The stages after detection for one video whose detector frames have
    ``frame_shape``: crops from ``full`` → identities → inputs assembled on
    ``device``."""
    if not any(v for v in boxes.values()):
        raise ValueError("No faces found.")
    scale = getattr(detector, "input_scale", 1)
    h = frame_shape[0] // scale  # detection (half-res) dims
    w = frame_shape[1] // scale
    crops = crops_from_frames(full, boxes, fps)
    identities, _ = cluster_crops(crops, embedder, similarity_threshold)
    return assemble_inputs(identities, (w * 2, h * 2), cfg, device)


def stage_decoded_pipelined(decoded: Iterable, detector, embedder, cfg: MintimeConfig,
                            similarity_threshold: float = 0.45, every_n: int = 1,
                            device: str | torch.device = "cuda") -> Iterator:
    """:func:`stage_decoded` over a stream of decoded videos ``(half, full,
    fps)`` with one video of lookahead (:func:`~mintime_torch.preprocessing.
    mtcnn.one_ahead`): video i+1 is pulled from ``decoded`` and its stage 1
    enqueued on the device before video i's host stages (NMS, stages 2-3,
    crops, clustering, assembly) run, so the device computes the one while
    the host does the other. Yields what :func:`assemble_inputs` returns, a
    video at a time, the same as :func:`stage_decoded`. An item may instead
    be a function that stages its video without detection (a video with
    precomputed boxes), called in its turn. A detector without the stage-1
    split takes :func:`stage_decoded` in each video's turn."""
    # MTCNNDetector enqueues stage 1 apart from the rest of its cascade; a
    # detector with only ``detect`` or ``detect_batch`` cannot
    split = hasattr(detector, "_dispatch_stage1") and hasattr(detector, "_finish_detect")

    def start(item) -> Callable:
        if callable(item):
            return item
        half, full, fps = item
        if not split:
            return functools.partial(stage_decoded, half, full, fps, detector, embedder, cfg,
                                     similarity_threshold, every_n, device)
        if not half:
            raise ValueError("the video has no frames")
        indices = range(0, len(half), every_n)
        sel = [half[i] for i in indices]
        pre = detector._dispatch_stage1(sel)
        return lambda: _stage_detected(_boxes(indices, detector._finish_detect(sel, pre)),
                                       sel[0].shape, full, fps, detector, embedder, cfg,
                                       similarity_threshold, device)
    return one_ahead(map(start, decoded))


def _stage_videos_pipelined(video_paths: Sequence[str], detector, embedder, cfg: MintimeConfig,
                            similarity_threshold: float, every_n: int,
                            boxes_per_video: Sequence[dict | None] | None,
                            device: str | torch.device = "cuda") -> Iterator:
    """:func:`stage_decoded_pipelined` over video files, each decoded by
    :func:`decode_for_predict` when it is pulled: video i+1 is decoded and
    its stage 1 enqueued before video i is finished. A video with
    precomputed boxes takes :func:`_stage_video` in its turn. Yields what
    :func:`assemble_inputs` returns, a video at a time."""
    def decoded():
        for i, path in enumerate(video_paths):
            boxes = boxes_per_video[i] if boxes_per_video else None
            if boxes is not None:
                yield functools.partial(_stage_video, path, detector, embedder, cfg,
                                        similarity_threshold, every_n, boxes, device)
                continue
            half, full, fps = decode_for_predict(
                path, channel_order=getattr(detector, "channel_order", "rgb"),
                resize_on_device=getattr(detector, "input_scale", 1) > 1)
            if not half:
                raise ValueError(f"could not decode {path}")
            yield half, full, fps
    return stage_decoded_pipelined(decoded(), detector, embedder, cfg, similarity_threshold,
                                   every_n, device)


def _stage_video(video_path: str, detector, embedder, cfg: MintimeConfig,
                 similarity_threshold: float, every_n: int, boxes: dict | None,
                 device: str | torch.device = "cuda"):
    """All stages of one video before the forward: decode, then
    :func:`stage_decoded`; or, with precomputed ``boxes``, the crops they
    give."""
    if boxes is None:
        half, full, fps = decode_for_predict(
            video_path, channel_order=getattr(detector, "channel_order", "rgb"),
            resize_on_device=getattr(detector, "input_scale", 1) > 1,
        )
        if not half:
            raise ValueError(f"could not decode {video_path}")
        return stage_decoded(half, full, fps, detector, embedder, cfg, similarity_threshold,
                             every_n, device)
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = int(cap.get(cv2.CAP_PROP_FPS)) or 30
    video_dims = (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    crops = extract_video_crops(video_path, boxes, fps)
    identities, _ = cluster_crops(crops, embedder, similarity_threshold)
    return assemble_inputs(identities, video_dims, cfg, device)


def stack_inputs(staged: Sequence, pad: int = 0) -> dict:
    """One batch from assembled videos ``[(inputs, plan, crop_store), ...]``,
    ``pad`` copies of the first appended: the frames stay a tensor on their
    device, the rest numpy."""
    rows = [s[0] for s in staged] + [staged[0][0]] * pad
    with span(profiling.SERVE_STACK):
        return {k: torch.cat([r[k] for r in rows]) if isinstance(rows[0][k], torch.Tensor)
                else np.concatenate([r[k] for r in rows]) for k in _INPUT_KEYS}


@torch.inference_mode()
def forward_batch(model, state: Mapping[str, torch.Tensor] | None, batch: Mapping[str, Any]):
    """Run the classifier on one stacked batch (numpy arrays, or tensors
    already on the model's device, which are not copied again); returns
    ``(logits (B,) numpy, [space, time] maps numpy)``. A host mask counts
    its faces (``faces_valid``); after the fetch's wait the device timers
    are resolved (``profiling.resolve_timers``)."""
    dev = model.device
    if isinstance(batch["mask"], np.ndarray):
        profiling.count(profiling.FACES_VALID, np.count_nonzero(batch["mask"]))
    with span(profiling.SERVE_UPLOAD):
        args = [torch.as_tensor(np.ascontiguousarray(batch[k]) if isinstance(batch[k], np.ndarray)
                                else batch[k]).to(dev, non_blocking=True)
                for k in _INPUT_KEYS]
    if state is None:
        logits, attns = model(*args)
    else:
        logits, attns = torch.func.functional_call(model, dict(state), tuple(args))
    with span(profiling.SERVE_FETCH):
        out = logits.float().cpu().numpy().reshape(-1), [a.float().cpu().numpy() for a in attns]
    profiling.resolve_timers()
    return out


def _result(logit, agg, id_attn, fpi, plan, crop_store) -> PredictionResult:
    return PredictionResult(
        probability=float(1.0 / (1.0 + np.exp(-float(logit)))),
        identity_attentions=id_attn,
        aggregated_attentions=list(agg),
        identities={k: crop_store[k] for k in plan.identity_keys},
        frames_per_identity=fpi,
        plan=plan,
    )


def predict_assembled(staged: Sequence, model, state, cfg: MintimeConfig,
                      pad_to: int = 0) -> list[PredictionResult]:
    """One forward over assembled videos ``[(batch, plan, crop_store), ...]``
    (as :func:`assemble_inputs` returns them), padded to ``pad_to`` rows by
    repeating the first; pad outputs are discarded. The videos' attention
    maps, ``heads`` rows each, are aggregated in one pass."""
    heads, pad = cfg.model.heads, max(pad_to - len(staged), 0)
    with span(profiling.SERVE_CALL, call=next(_calls), videos=len(staged), padded=pad):
        logits, attns = forward_batch(model, state, stack_inputs(staged, pad))
        with span(profiling.SERVE_AGGREGATE, videos=len(staged)):
            fpis = [[int(t / cfg.model.num_patches) for _, t in plan.tokens_per_identity]
                    for _, plan, _ in staged]
            agg, id_attn = aggregate_attentions_batch([a[:len(staged) * heads] for a in attns],
                                                      heads, cfg.model.num_frames, fpis)
            return [_result(logits[b], agg[b], id_attn[b], fpis[b], plan, crop_store)
                    for b, (_, plan, crop_store) in enumerate(staged)]


def predict_video(video_path: str, model, state, cfg: MintimeConfig, detector, embedder,
                  similarity_threshold: float = 0.45, every_n: int = 1,
                  boxes: dict | None = None) -> PredictionResult:
    """The full pipeline for one video. ``boxes``: optional precomputed
    half-res detections, which skip the detector."""
    staged = _stage_video(video_path, detector, embedder, cfg, similarity_threshold, every_n,
                          boxes, model.device)
    return predict_assembled([staged], model, state, cfg)[0]


def _batch_rows(n_videos: int, batch_size: int, mesh) -> list[range]:
    """This data rank's videos of each batch of ``batch_size`` (the whole
    batch without a mesh)."""
    from mintime_torch.parallel.mesh import axis_rank, axis_size, shard_rows

    world = axis_size(mesh)
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must divide by the mesh data axis ({world})")
    out = []
    for start in range(0, n_videos, batch_size):
        rows = shard_rows(min(start + batch_size, n_videos) - start, axis_rank(mesh), world)
        out.append(range(start + rows.start, start + rows.stop))
    return out


def predict_staged(staged: Iterable, n_videos: int, model, state, cfg: MintimeConfig,
                   batch_size: int = 8, mesh=None) -> list[PredictionResult]:
    """The batch logic of :func:`predict_videos` over ``staged``, which yields
    what :func:`assemble_inputs` returns for this rank's videos of every batch
    (:func:`_batch_rows`), in order. A batch's forward runs as soon as its
    videos are pulled, so a lazy ``staged`` holds no more than one batch of
    assembled videos and what it stages ahead. When the run has more videos
    than ``batch_size``, every batch is padded to ``batch_size`` (over the
    data ranks) by repeating its first row, so every forward has one shape.
    With a ``mesh`` the results are gathered batch by batch, so every rank
    ends with the whole list in order."""
    from mintime_torch.parallel.mesh import axis_size, gather_rows, replicated

    batches = _batch_rows(n_videos, batch_size, mesh)
    if mesh is not None:
        replicated(mesh, model)  # every rank serves rank 0's weights
    pad_to = batch_size // axis_size(mesh) if n_videos > batch_size else 0
    staged = iter(staged)
    results: list[PredictionResult] = []
    for rows in batches:
        chunk = list(itertools.islice(staged, len(rows)))
        out = predict_assembled(chunk, model, state, cfg, pad_to) if chunk else []
        del chunk  # its assembled inputs, before the next batch is staged
        results.extend(gather_rows(mesh, [out])[0])
    return results


def predict_videos(video_paths: Sequence[str], model, state, cfg: MintimeConfig, detector,
                   embedder, similarity_threshold: float = 0.45, every_n: int = 1,
                   batch_size: int = 8,
                   boxes_per_video: Sequence[dict | None] | None = None,
                   mesh=None) -> list[PredictionResult]:
    """Batched serving: the host stages run per video, pipelined across videos
    (:func:`_stage_videos_pipelined`), and ``batch_size`` assembled videos
    share one forward, which runs as soon as they are staged
    (:func:`predict_staged`). So at most ``batch_size`` videos' assembled
    inputs, and one video's decoded frames and stage 1 beyond them, are held
    at once. When the run has more videos than ``batch_size``, the last batch
    is padded to ``batch_size`` by repeating its first row, so every forward
    has one shape.

    With a ``mesh`` (:func:`mintime_torch.parallel.mesh.make_mesh`) each data
    rank stages its contiguous rows of every batch, pipelined over its own
    rows, and scores them with rank 0's weights (``batch_size`` must divide
    by the data ranks, as in the JAX package); the results are gathered batch
    by batch, so every rank ends with the whole list in order.
    """
    mine = [i for rows in _batch_rows(len(video_paths), batch_size, mesh) for i in rows]
    staged = _stage_videos_pipelined(
        [video_paths[i] for i in mine], detector, embedder, cfg, similarity_threshold, every_n,
        [boxes_per_video[i] for i in mine] if boxes_per_video else None, model.device)
    return predict_staged(staged, len(video_paths), model, state, cfg, batch_size, mesh)


def generate_output_video(video_path: str, result: PredictionResult,
                          output_dir: str = "examples/preds") -> str:
    """The video annotated as the reference's (``predict.py:432-479``): each
    identity's face box in red to green by its attention (fake) or by the
    probability (pristine), with a label; written as XVID ``.avi`` into
    ``output_dir``. Host only (cv2)."""
    import cv2

    identities_bboxes: dict[int, list] = {}  # frame → a box per identity
    for identity_index, items in enumerate(result.identities.values()):
        for frame_idx, _, _, bbox in items:
            identities_bboxes.setdefault(frame_idx, [None] * len(result.identities))
            identities_bboxes[frame_idx][identity_index] = bbox
    available = sorted(identities_bboxes)

    cap = cv2.VideoCapture(video_path)
    width, height = int(cap.get(3)), int(cap.get(4))
    fps = int(cap.get(5)) or 30
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, os.path.basename(video_path).replace(".mp4", ".avi"))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"XVID"), fps, (width, height))
    pred = result.probability
    frame_index = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        nearest = min(available, key=lambda x: abs(x - frame_index))
        if nearest - frame_index <= fps:
            for identity_index, bbox in enumerate(identities_bboxes[nearest]):
                if bbox is None:
                    continue
                xmin, ymin, xmax, ymax = [int(b * 2) for b in bbox]
                if pred > 0.5:
                    red = 255 * result.identity_attentions[identity_index]
                    green = 255 - red
                    text = f"Fake {round(pred * 100, 2)}%" if red > green else "Pristine"
                else:
                    green = int(255 * (1 - pred))
                    red = 255 - green
                    text = f"Pristine {round((1 - pred) * 100, 2)}%"
                color = (0, int(green), int(red))
                frame = draw_border(frame, (xmin, ymin), (xmax, ymax), color, 2, 10, 20)
                cv2.putText(frame, text, (xmin, ymin - 10), cv2.FONT_HERSHEY_SIMPLEX, 0.9, color, 2)
        writer.write(frame)
        frame_index += 1
    writer.release()
    cap.release()
    return out_path


def load_predict_models(cfg: MintimeConfig, model_weights: str, mtcnn_weights: str,
                        facenet_weights: str, extractor_weights: str | None = None,
                        extractor_model: int = 0, device: str | torch.device = "cuda",
                        detector_options: Mapping[str, Any] | None = None):
    """What the CLI serves with, from weight files: the classifier
    (EfficientNet-B0 for ``extractor_model`` 0, Xception for 1; TimeSformer
    head with its attention maps; fp32 parameters computing in bf16 with the
    kernels, as the JAX CLI's bf16 model with its Pallas kernels) through
    :func:`load_model_state`; the MTCNN cascade from ``pnet.pt``, ``rnet.pt``
    and ``onet.pt`` in ``mtcnn_weights`` (BGR frames in, swapped on the
    device; ``detector_options`` are further :class:`MTCNNDetector` fields,
    which the CLI leaves at their defaults); the FaceNet embedder from
    ``facenet_weights``. Returns ``(model, detector, embedder)`` on
    ``device``."""
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.preprocessing.cluster_faces import FaceEmbedder
    from mintime_torch.preprocessing.mtcnn import NETS, MTCNNDetector
    from mintime_torch.utils.checkpoint import load_model_state

    dev = resolve_device(device)
    model = MintimeVideoClassifier(
        cfg.model, backbone="efficientnet-b0" if extractor_model == 0 else "xception",
        head="timesformer", require_attention=True, use_kernels=True, device=dev,
        dtype=torch.bfloat16, param_dtype=torch.float32)
    model.load_state_dict(load_model_state(model, cfg, model_weights, extractor_weights))
    nets = {name: torch.load(os.path.join(mtcnn_weights, f"{name}.pt"), map_location="cpu")
            for name in NETS}
    detector = MTCNNDetector(nets, channel_order="bgr", device=dev, **(detector_options or {}))
    embedder = FaceEmbedder(torch.load(facenet_weights, map_location="cpu"), device=dev)
    return model, detector, embedder


def main(argv=None):
    """The reference's predict CLI: one video → fake probability, and
    optionally the attention plots and the annotated video."""
    import argparse

    from mintime_torch.config import load_config
    from mintime_torch.utils.attention_viz import save_attention_plots

    p = argparse.ArgumentParser("mintime-torch predict (predict.py parity)")
    p.add_argument("--video_path", required=True)
    p.add_argument("--config", default="configs/size_invariant_timesformer.yaml")
    p.add_argument("--model_weights", required=True)
    p.add_argument("--extractor_weights", default=None)
    p.add_argument("--extractor_model", type=int, default=0, help="0 EfficientNet-B0 | 1 Xception")
    p.add_argument("--mtcnn_weights", default=None)
    p.add_argument("--facenet_weights", default=None)
    p.add_argument("--output_type", type=int, default=0, help="0 prob | 1 video")
    p.add_argument("--save_attentions", action="store_true")
    # the reference's flags: FacenetDetector is its only detector, and the
    # prediction is deterministic and single-video, so seed and workers are
    # accepted and have no effect
    p.add_argument("--detector_type", default="FacenetDetector", choices=["FacenetDetector"])
    p.add_argument("--random_state", type=int, default=42,
                   help="(reference CLI compatibility; prediction is deterministic)")
    p.add_argument("--workers", type=int, default=1, help="(reference CLI compatibility; unused)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)

    # a random cascade detects nothing and a random embedder clusters at
    # random: real weights are required, before any model is built
    if not opt.mtcnn_weights or not opt.facenet_weights:
        p.error("--mtcnn_weights (dir with pnet.pt/rnet.pt/onet.pt) and --facenet_weights "
                "(InceptionResnetV1 vggface2 state_dict) are required: the facenet-pytorch "
                "pretrained weights the reference loads implicitly (face_detector.py:42-46, "
                "preprocessing/utils.py:32-34) cannot be auto-downloaded here.")
    if not os.path.exists(opt.model_weights):
        p.error(f"--model_weights not found: {opt.model_weights}")

    cfg = load_config(opt.config)
    model, detector, embedder = load_predict_models(
        cfg, opt.model_weights, opt.mtcnn_weights, opt.facenet_weights,
        extractor_weights=opt.extractor_weights, extractor_model=opt.extractor_model,
        device=opt.device)
    result = predict_video(opt.video_path, model, None, cfg, detector, embedder)
    print(f"fake probability: {result.probability:.4f}")
    if opt.save_attentions:
        save_attention_plots(result.aggregated_attentions, list(result.identities.keys()),
                             result.frames_per_identity, cfg.model.num_frames,
                             os.path.basename(opt.video_path))
    if opt.output_type == 1:
        print("annotated video:", generate_output_video(opt.video_path, result))
    return result


if __name__ == "__main__":
    main()
