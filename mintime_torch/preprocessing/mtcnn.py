"""MTCNN face detector: the P-Net / R-Net / O-Net cascade (counterpart of
``mintime_tpu/preprocessing/mtcnn.py``).

The nets are ``nn.Module``s in NCHW under facenet-pytorch's module names
(``conv1``, ``prelu1``, ..., ``dense6_3``), so a facenet-pytorch
``state_dict`` (``pnet.pt``, ``rnet.pt``, ``onet.pt``) loads with
``load_state_dict`` and the same dict feeds the JAX package through its
``mtcnn_params_from_torch``.

:class:`MTCNNDetector` runs the reference's cascade (facenet-pytorch
``detect_face``; thresholds (0.85, 0.95, 0.95), minimum face 20, pyramid
factor 0.709). Stage 1 is one pass over a video's frames on the device: the
BGR swap and ``input_scale`` shrink, the area-resized pyramid, P-Net at every
level, a top-``pnet_topk`` a level and a global top-``k_fetch`` across the
levels, of which only a head of ``pnet_head_k`` cells comes back unless
above-threshold cells reach the tail. NMS and the box bookkeeping run on the
host in float32, with the greedy recurrence in C (:mod:`mintime_torch.native`).
Stages 2 and 3 crop and resize every candidate of every frame, on the host or
(``device_crops``) on the device as two products a candidate, and run R-Net
or O-Net over all of them in one call. Products and convolutions run in fp32
without TF32. Nothing pads the frame or candidate counts: eager PyTorch keeps
no compiled program a shape.

:meth:`MTCNNDetector.detect_videos_iter` keeps one video of lookahead: video
i+1's stage 1 is enqueued on the device before the host finishes video i.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Iterator, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mintime_torch.device import exact_fp32, resolve_device
from mintime_torch.native import greedy_nms

NETS = ("pnet", "rnet", "onet")
#: frames' pixels a stage-1 chunk holds at once (fp32 copies of the frames
#: and their first pyramid levels stay near 2 GiB at 1920 x 1080)
_STAGE1_PIXELS = 2**27
#: candidates a stage-2/3 crop product holds at once
_CROP_CHUNK = 512


# ------------------------------------------------------------------- the nets
class PNet(nn.Module):
    """Proposal net: fully convolutional 12 x 12 cell scorer. Returns the
    face probability map ``(N, 2, h', w')`` and the box regression
    ``(N, 4, h', w')``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.pool1 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        return torch.softmax(self.conv4_1(x), dim=1), self.conv4_2(x)


def _flatten_wh(x):
    """facenet-pytorch's flatten before a dense layer: ``(N, W, H, C)`` order
    (``permute(0, 3, 2, 1)``), the order the dense weights were trained in."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class RNet(nn.Module):
    """Refine net over 24 x 24 crops: ``(prob (N, 2), reg (N, 4))``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(_flatten_wh(x)))
        return torch.softmax(self.dense5_1(x), dim=1), self.dense5_2(x)


class ONet(nn.Module):
    """Output net over 48 x 48 crops: ``(prob (N, 2), reg (N, 4),
    landmarks (N, 10))``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.pool3 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.pool3(self.prelu3(self.conv3(x)))
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.dense5(_flatten_wh(x)))
        return torch.softmax(self.dense6_1(x), dim=1), self.dense6_2(x), self.dense6_3(x)


# --------------------------------------------------------------- host helpers
# Copies of ``mintime_tpu/preprocessing/mtcnn.py:121-320``, same numerics.
def nms_tv(boxes: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    """torchvision.ops.nms semantics (facenet-pytorch's ``batched_nms``, the
    per-scale 0.5, cross-scale 0.7 and stage-2 0.7 passes): areas without
    the MATLAB +1, suppress IoU > threshold, stable descending-score order."""
    if len(boxes) == 0:
        return np.zeros(0, dtype=int)
    order = np.argsort(-scores, kind="stable")
    return greedy_nms(boxes, order, threshold, method_min=False, plus_one=False)


def nms(boxes: np.ndarray, scores: np.ndarray, threshold: float, method: str = "union"):
    """Greedy NMS with MATLAB +1 areas (facenet-pytorch's ``nms_numpy``, its
    stage-3 pass with ``method='min'``); the unstable reversed argsort is the
    reference's tie rule."""
    if len(boxes) == 0:
        return np.zeros(0, dtype=int)
    order = scores.argsort()[::-1]
    return greedy_nms(boxes, order, threshold, method_min=method == "min", plus_one=True)


def rerec(boxes: np.ndarray) -> np.ndarray:
    """Boxes to squares around their centres."""
    out = boxes.copy()
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out[:, 0] = boxes[:, 0] + w * 0.5 - side * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def apply_regression(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    """facenet-pytorch ``bbreg`` (stages 2-3): +1 width and height."""
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    out = boxes.copy()
    out[:, 0] += reg[:, 0] * w
    out[:, 1] += reg[:, 1] * h
    out[:, 2] += reg[:, 2] * w
    out[:, 3] += reg[:, 3] * h
    return out


def apply_regression_stage1(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    """Stage-1 regression after the cross-scale NMS: ``detect_face`` inlines
    it without the +1."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    out = boxes.copy()
    out[:, 0] += reg[:, 0] * w
    out[:, 1] += reg[:, 1] * h
    out[:, 2] += reg[:, 2] * w
    out[:, 3] += reg[:, 3] * h
    return out


def _area_resize_hw(img: np.ndarray, size: int) -> np.ndarray:
    """(h, w, c) → (size, size, c) with torch ``interpolate(mode='area')``
    semantics (facenet-pytorch's ``imresample`` for the R/O-Net crops), as
    two BLAS products with the memoised area matrices."""
    h, w = img.shape[:2]
    out = np.tensordot(_area_matrix(h, size), img, axes=(1, 0))  # (size, w, c)
    return np.tensordot(_area_matrix(w, size), out, axes=(1, 1)).transpose(1, 0, 2)


def _crop_resize(img: np.ndarray, boxes: np.ndarray, size: int, scale: int = 1) -> tuple:
    """facenet-pytorch's crop (``pad`` + slice + ``imresample``): boxes are
    truncated to int and clipped to the 1-based image extent, and the clipped
    region is area-resized to (size, size). Returns (crops, valid): a box
    whose clipped region is empty is invalid and dropped by the caller.

    ``scale > 1``: boxes are in downscaled coordinates and ``img`` is the
    full-resolution frame; the slice is the x``scale`` image of the
    downscaled region, so one area resize does the shrink and the resample."""
    H = img.shape[0] // scale
    W = img.shape[1] // scale
    n = len(boxes)
    out = np.zeros((n, size, size, 3), np.float32)
    valid = np.ones(n, dtype=bool)
    ib = np.trunc(boxes[:, :4]).astype(int)
    for i, (x, y, ex, ey) in enumerate(ib):
        x, y = max(x, 1), max(y, 1)
        ex, ey = min(ex, W), min(ey, H)
        if not (ey > y - 1 and ex > x - 1):
            valid[i] = False
            continue
        region = img[(y - 1) * scale : ey * scale, (x - 1) * scale : ex * scale]
        out[i] = _area_resize_hw(region.astype(np.float32), size)
    return out, valid


@lru_cache(maxsize=2048)
def _area_matrix(si: int, so: int) -> np.ndarray:
    """Row-stochastic (so, si) matrix of torch ``interpolate(mode='area')``:
    output pixel i averages input pixels [floor(i*si/so), ceil((i+1)*si/so)).
    Memoised and read-only, so no caller can change a cached entry."""
    a = np.zeros((so, si), np.float32)
    for i in range(so):
        lo = (i * si) // so
        hi = -(-((i + 1) * si) // so)
        a[i, lo:hi] = 1.0 / (hi - lo)
    a.setflags(write=False)
    return a


def _pnet_grid(sh: int, sw: int) -> tuple[int, int]:
    """P-Net output grid of an (sh, sw) input: 3 x 3 VALID conv, 2/2 ceil
    max-pool, two more 3 x 3 VALID convs."""
    return -(-(sh - 2) // 2) - 4, -(-(sw - 2) // 2) - 4


def _pyramid_scales(h: int, w: int, min_face_size: int, factor: float) -> list[float]:
    """facenet-pytorch's scale list: accumulated in Python floats, each
    checked before it is appended (``detect_face``: ``minl *= factor``)."""
    m = 12.0 / min_face_size
    minl = min(h, w) * m
    scales: list[float] = []
    scale_i = m
    while minl >= 12:
        scales.append(scale_i)
        scale_i *= factor
        minl *= factor
    return scales


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row, score-descending with ties to the lower index
    (``lax.top_k``'s order, which the candidate order and with it the NMS
    rely on); ``torch.topk`` promises no order among equal values."""
    values, index = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


def _axis_weights(start1, end1, length: int, size: int, scale: int) -> torch.Tensor:
    """(K, size, length) area weights of each candidate's region rows
    [(start1-1)*scale, end1*scale), from the integer window arithmetic of
    :func:`_area_matrix`; a zero-length region gets zero weights."""
    r0 = (start1 - 1) * scale
    span = (end1 - start1 + 1) * scale
    i = torch.arange(size, device=span.device)
    lo = (i[None, :] * span[:, None]) // size
    hi = -((-(i[None, :] + 1) * span[:, None]) // size)
    den = (hi - lo).clamp(min=1).float()
    r = torch.arange(length, device=span.device)
    rel = r[None, None, :] - r0[:, None, None]
    inside = (rel >= lo[..., None]) & (rel < hi[..., None]) & (span > 0)[:, None, None]
    return torch.where(inside, 1.0 / den[..., None], 0.0)


def _device_crops(frame: torch.Tensor, boxes: torch.Tensor, size: int, scale: int,
                  bgr: bool) -> torch.Tensor:
    """Crops of one frame ``(H, W, 3)`` uint8 at ``boxes`` (K, 4) int64
    [x, y, ex, ey] (1-based, clipped) → (K, 3, size, size) fp32: per
    candidate ``Wy @ frame @ Wx^T`` with the weights of :func:`_axis_weights`."""
    H, W = frame.shape[:2]
    x = (frame.flip(-1) if bgr else frame).float()
    wy = _axis_weights(boxes[:, 1], boxes[:, 3], H, size, scale)  # (K, size, H)
    wx = _axis_weights(boxes[:, 0], boxes[:, 2], W, size, scale)  # (K, size, W)
    k = len(boxes)
    rows = (wy.reshape(k * size, H) @ x.reshape(H, W * 3)).reshape(k, size, W, 3)
    return torch.einsum("ktw,kswc->kcst", wx, rows)


def _copy_to_host(t: torch.Tensor):
    """Start copying ``t`` to the host; returns ``(host tensor, event or
    None)``. On the card the copy lands in pinned memory behind the work
    already enqueued, and the event marks it, so a later wait on it does not
    also wait for the next video's stage 1."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def one_ahead(started: Iterator[Callable]) -> Iterator:
    """Call each function of ``started`` in order, pulling the next one before
    calling the current one: where pulling a function starts a video's work
    on the device, video i+1 runs there while video i is finished. The current
    one is let go before its result is yielded, so one video at most is held
    beyond those yielded."""
    pending = next(started, None)
    while pending is not None:
        nxt = next(started, None)
        out = pending()
        pending = nxt
        yield out


def _copy_after(t: torch.Tensor, after) -> np.ndarray:
    """``t`` on the host, copied once the work before event ``after`` is done
    and not waiting for what the current stream took since: the copy runs on
    a side stream that waits on ``after`` alone. ``after`` None: ``t`` is on
    the host already."""
    if after is None:
        return t.numpy()
    side = torch.cuda.Stream(device=t.device)
    side.wait_event(after)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
    t.record_stream(side)
    side.synchronize()
    return host.numpy()


def _valid_box_coords(b: np.ndarray, W: int, H: int) -> tuple[np.ndarray, np.ndarray]:
    """The host half of the device crop: ``pad``'s trunc-and-clip coords and
    the valid flags; an invalid box becomes the zero-length [1, 1, 0, 0]."""
    ib = np.trunc(b[:, :4]).astype(np.int64)
    x = np.maximum(ib[:, 0], 1)
    y = np.maximum(ib[:, 1], 1)
    ex = np.minimum(ib[:, 2], W)
    ey = np.minimum(ib[:, 3], H)
    v = (ey > y - 1) & (ex > x - 1)
    coords = np.stack([np.where(v, x, 1), np.where(v, y, 1), np.where(v, ex, 0),
                       np.where(v, ey, 0)], axis=1)
    return coords, v


# ------------------------------------------------------------------ the cascade
@dataclass(eq=False)
class MTCNNDetector:
    """The three-stage cascade. ``state_dicts`` maps ``"pnet"``, ``"rnet"``
    and ``"onet"`` to facenet-pytorch state_dicts. The nets are built on
    ``device`` (default ``"cuda"``, which raises without a card)."""

    state_dicts: Mapping[str, Mapping[str, torch.Tensor]] = field(repr=False)
    thresholds: tuple = (0.85, 0.95, 0.95)
    min_face_size: int = 20
    factor: float = 0.709
    #: final boxes ordered by area, largest first (MTCNN(select_largest=True))
    select_largest: bool = True
    #: P-Net cells kept a frame and pyramid level; a warning says when this
    #: cap clipped an above-threshold cell (raise it for low thresholds or a
    #: small ``min_face_size``)
    pnet_topk: int = 512
    #: cells of the per-level survivors kept a frame across all levels
    #: (None: ``pnet_topk``)
    pnet_fetch_k: int | None = None
    #: score-descending cells always copied to the host; the rest of the
    #: ``pnet_fetch_k`` cells are copied only when the head's last score is
    #: still above the stage-1 threshold (what the host would discard anyway)
    pnet_head_k: int = 128
    #: channel order of the input frames; ``"bgr"`` takes cv2's frames and
    #: swaps on the device (the cascade's numerics are defined on RGB)
    channel_order: str = "rgb"
    #: integer shrink on the device before the pyramid: full-resolution
    #: frames in, boxes in 1/input_scale coordinates out. Frames are floored
    #: to a multiple of ``input_scale`` first, so the shrink is a whole
    #: input_scale x input_scale mean (a host ``cv2.resize`` of an even frame
    #: to half gives the same means, rounded to uint8)
    input_scale: int = 1
    #: crop and resize the R/O-Net candidates on the device from the frames
    #: already there (two products a candidate); the host then sends only
    #: integer box coordinates. Equal to the host crops up to fp rounding
    device_crops: bool = False
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.input_scale < 1:
            raise ValueError(f"input_scale must be >= 1, got {self.input_scale}")
        if self.channel_order not in ("rgb", "bgr"):
            # any other spelling would run the cascade on wrong-colour frames
            raise ValueError(f"channel_order must be 'rgb' or 'bgr', got {self.channel_order!r}")
        self.device = resolve_device(self.device)
        self.nets = {}
        for name, cls in zip(NETS, (PNet, RNet, ONet)):
            net = cls()
            net.load_state_dict(self.state_dicts[name], strict=True)
            self.nets[name] = net.to(self.device).eval().requires_grad_(False)

    @staticmethod
    def init_state_dicts(seed: int = 0) -> dict:
        """Random-init state_dicts (tests and structural runs), from ``seed``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return {name: cls().state_dict() for name, cls in zip(NETS, (PNet, RNet, ONet))}

    # ------------------------------------------------------------- public API
    def detect(self, img: np.ndarray) -> np.ndarray:
        """Faces in one uint8 image → ``(N, 5)`` [x1, y1, x2, y2, score]."""
        return self.detect_batch([img])[0]

    def stage_frames(self, frames: Sequence[np.ndarray]) -> torch.Tensor:
        """A video's frames on the device once, ``(T, H, W, 3)`` uint8; pass it
        as ``staged=`` to skip the copy in :meth:`detect_batch`."""
        first = np.asarray(frames[0])
        out = torch.empty((len(frames),) + first.shape, dtype=torch.uint8, device=self.device)
        for i, f in enumerate(frames):  # one frame at a time: no second host copy
            out[i].copy_(torch.from_numpy(np.ascontiguousarray(f)), non_blocking=True)
        return out

    def detect_batch(self, frames: Sequence[np.ndarray], staged=None) -> list[np.ndarray]:
        """Same-shape frames (a video) → per frame ``(N, 5)`` boxes. One
        stage-1 pass over all frames, one R-Net and one O-Net call over all
        candidates; NMS and bookkeeping per frame on the host."""
        frames = [np.asarray(f) for f in frames]
        return self._finish_detect(frames, self._dispatch_stage1(frames, staged=staged))

    def detect_videos(self, videos: Sequence[Sequence[np.ndarray]]) -> list[list[np.ndarray]]:
        """:meth:`detect_batch` over several videos with one video of
        lookahead; the same results as one call a video."""
        return list(self.detect_videos_iter(iter(videos)))

    def detect_videos_iter(self, videos):
        """Streaming :meth:`detect_videos`: pulls video i+1 from the iterator
        and enqueues its stage 1 before finishing video i (:func:`one_ahead`),
        so at most two videos' frames are held."""
        def start(fs):
            fs = [np.asarray(f) for f in fs]
            pre = self._dispatch_stage1(fs)
            return lambda: self._finish_detect(fs, pre)
        return one_ahead(map(start, videos))

    # ---------------------------------------------------------------- stage 1
    def _dispatch_stage1(self, frames: Sequence[np.ndarray], staged=None):
        """Enqueue stage 1 for a video without waiting for it: returns
        ``(scales, (head's host copy, tail), device frames or None)`` for
        :meth:`_finish_detect`, or None for no frames."""
        if len(frames) == 0:
            return None
        H = frames[0].shape[0] // self.input_scale
        W = frames[0].shape[1] // self.input_scale
        scales = _pyramid_scales(H, W, self.min_face_size, self.factor)
        if not scales:  # image smaller than the minimum face
            return (tuple(), None, None)
        batch = staged if staged is not None else self.stage_frames(frames)
        head, tail = self._pnet_pyramid(batch, tuple(scales))
        return (tuple(scales), (_copy_to_host(head), tail), batch if self.device_crops else None)

    @torch.inference_mode()
    def _pnet_pyramid(self, batch: torch.Tensor, scales: tuple) -> tuple:
        """Stage 1 on the device over ``batch`` (T, H, W, 3) uint8, in chunks of
        frames. Returns the head ``(T, hk*7 + levels)`` and tail
        ``(T, (k_fetch - hk)*7)`` float64 buffers: per cell [score, index in
        the level's grid, level, reg4] (float64 holds the indices exactly),
        score-descending, and after the head each level's lowest kept score
        (the probe for a clipped level). Nothing is copied to the host."""
        T, Hf, Wf = batch.shape[:3]
        chunk = max(1, _STAGE1_PIXELS // (Hf * Wf))
        heads, tails = [], []
        with exact_fp32():
            for t0 in range(0, T, chunk):
                head, tail = self._pyramid_chunk(batch[t0:t0 + chunk], scales)
                heads.append(head)
                tails.append(tail)
        return torch.cat(heads), torch.cat(tails)

    def _pyramid_chunk(self, frames: torch.Tensor, scales: tuple) -> tuple:
        x = frames.permute(0, 3, 1, 2)
        if self.channel_order == "bgr":
            x = x.flip(1)
        x = x.float()
        s = self.input_scale
        if s > 1:  # floor to a multiple of s, then the s x s mean
            x = F.avg_pool2d(x[:, :, : x.shape[2] // s * s, : x.shape[3] // s * s], s)
        h, w = x.shape[2:]
        k = self.pnet_topk
        scores_all, idx_all, lvl_all, reg_all, bounds = [], [], [], [], []
        for li, sc in enumerate(scales):
            # facenet-pytorch's level size: int(dim * scale + 1)
            lvl = F.interpolate(x, size=(int(h * sc + 1), int(w * sc + 1)), mode="area")
            prob, reg = self.nets["pnet"]((lvl - 127.5) * 0.0078125)
            t, _, gh, gw = prob.shape
            top, idx = _top_k(prob[:, 1].reshape(t, gh * gw), min(k, gh * gw))
            scores_all.append(top)
            idx_all.append(idx)
            lvl_all.append(torch.full_like(idx, li))
            reg_all.append(torch.gather(reg.reshape(t, 4, gh * gw), 2,
                                        idx[:, None, :].expand(t, 4, idx.shape[1])))
            bounds.append(top[:, -1])
        scores = torch.cat(scores_all, dim=1)
        kf = min(self.pnet_fetch_k or k, scores.shape[1])
        # score-descending, ties to the concatenation index: within a level
        # that is the level's own top-k order, so the host sees each level's
        # cells in the order a full fetch would give them
        g_scores, g_pos = _top_k(scores, kf)
        g_idx = torch.gather(torch.cat(idx_all, dim=1), 1, g_pos)
        g_lvl = torch.gather(torch.cat(lvl_all, dim=1), 1, g_pos)
        g_reg = torch.gather(torch.cat(reg_all, dim=2), 2,
                             g_pos[:, None, :].expand(t, 4, kf)).transpose(1, 2)
        cells = torch.cat([g_scores[..., None].double(), g_idx[..., None].double(),
                           g_lvl[..., None].double(), g_reg.double()], dim=2)  # (t, kf, 7)
        hk = min(self.pnet_head_k, kf)
        head = torch.cat([cells[:, :hk].reshape(t, hk * 7),
                          torch.stack(bounds, dim=1).double()], dim=1)
        return head, cells[:, hk:].reshape(t, (kf - hk) * 7)

    # ------------------------------------------------------------ stages 1-3
    def _finish_detect(self, frames, pre) -> list[np.ndarray]:
        """Host NMS and stages 2-3 for one video's enqueued stage 1."""
        T = len(frames)
        if pre is None:
            return []
        scales, handles, dev_frames = pre
        if not scales:
            return [np.zeros((0, 5)) for _ in range(T)]
        H = frames[0].shape[0] // self.input_scale
        W = frames[0].shape[1] // self.input_scale
        per_frame: list[list] = [[] for _ in range(T)]
        head_copy, tail_h = handles
        L = len(scales)

        def unpack(buf, k):  # (T, k*7) float64 -> float32 scores, idx, lvl, float32 reg4
            cells = buf[:, : k * 7].reshape(buf.shape[0], k, 7)
            return (cells[..., 0].astype(np.float32), cells[..., 1].astype(np.int64),
                    cells[..., 2].astype(np.int32), cells[..., 3:7].astype(np.float32))

        head_buf = self._head(head_copy)
        hk = (head_buf.shape[1] - L) // 7
        head = unpack(head_buf, hk)
        bounds = head_buf[:, hk * 7:].astype(np.float32)
        tail_k = tail_h.shape[1] // 7
        if tail_k and (hk == 0 or (head[0][:, -1] >= self.thresholds[0]).any()):
            # above-threshold cells may reach the tail: copy it too. Otherwise
            # every tail score is at most the head's last one, below the
            # threshold, and the first host mask would discard it. The copy
            # waits for this video's stage 1 only (the head's event), not for
            # the next video's, enqueued on the stream since
            tail = unpack(_copy_after(tail_h, head_copy[1]), tail_k)
            all_scores, all_idx, all_lvl, all_reg = (
                np.concatenate([a, b], axis=1) for a, b in zip(head, tail))
        else:
            all_scores, all_idx, all_lvl, all_reg = head
        grids = [_pnet_grid(int(H * s + 1), int(W * s + 1)) for s in scales]
        # the warning asks whether the fetch budget (head + tail) clipped
        # above-threshold cells; with the tail skipped, the last score is the
        # head's, below the threshold, so it cannot fire
        n_fetched = hk + tail_k
        n_slots = sum(min(self.pnet_topk, gh * gw) for gh, gw in grids)
        for li, s in enumerate(scales):
            gh, gw = grids[li]
            if self.pnet_topk < gh * gw and (bounds[:, li] >= self.thresholds[0]).any():
                warnings.warn(f"P-Net top-{self.pnet_topk} truncated above-threshold cells at"
                              f" scale {s:.3f}; raise MTCNNDetector.pnet_topk", stacklevel=2)
        if n_fetched < n_slots and (all_scores[:, -1] >= self.thresholds[0]).any():
            warnings.warn(f"P-Net global fetch top-{n_fetched} truncated above-threshold cells;"
                          " raise MTCNNDetector.pnet_fetch_k", stacklevel=2)
        for t in range(T):
            keep_t = all_scores[t] >= self.thresholds[0]
            if not keep_t.any():
                continue
            lv_t, idx_t = all_lvl[t][keep_t], all_idx[t][keep_t]
            sc_t, rg_t = all_scores[t][keep_t], all_reg[t][keep_t]
            for li, s in enumerate(scales):
                # generateBoundingBox: q1 = floor((2*cell + 1)/scale), q2 =
                # floor((2*cell + 12)/scale); the per-scale NMS 0.5 runs on
                # the unregressed boxes. float32 throughout, as the
                # reference's tensors: floor() differs between f32 and f64
                # at some cells (3/0.6 is 4.9999998f but 5.000...09 in f64)
                keep_k = lv_t == li
                if not keep_k.any():
                    continue
                gw = grids[li][1]
                stride, cell = np.float32(2), np.float32(12)
                score = sc_t[keep_k]
                ys, xs = np.divmod(idx_t[keep_k], gw)
                xy = np.stack([xs, ys], axis=1).astype(np.float32) * stride
                s32 = np.float32(s)
                q1 = np.floor((xy + np.float32(1)) / s32)
                q2 = np.floor((xy + cell) / s32)
                boxes = np.concatenate([q1, q2, score[:, None], rg_t[keep_k]], axis=1)
                keep = nms_tv(boxes[:, :4], boxes[:, 4], 0.5)
                per_frame[t].append(boxes[keep])

        cand: list[np.ndarray] = []
        for t in range(T):
            if per_frame[t]:
                b = np.concatenate(per_frame[t])
                b = b[nms_tv(b[:, :4], b[:, 4], 0.7)]
                # regression (no +1), then squares; boxes stay float (only the
                # crop truncates)
                out5 = np.concatenate(
                    [apply_regression_stage1(b[:, :4], b[:, 5:9]), b[:, 4:5]], axis=1)
                b = rerec(out5)
            else:
                b = np.zeros((0, 5))
            cand.append(b)

        # stage 2: NMS 0.7 on the boxes before regression, then bbreg (+1), rerec
        cand = self._run_stage(frames, cand, 24, "rnet", self.thresholds[1], dev_frames)
        for t in range(T):
            b, mv = cand[t]
            if len(b):
                keep = nms_tv(b[:, :4], b[:, 4], 0.7)
                b, mv = b[keep], mv[keep]
                b[:, :4] = apply_regression(b[:, :4], mv)[:, :4]
                b = rerec(b)
            cand[t] = b

        # stage 3: bbreg first, then the 'min' NMS with MATLAB +1 areas
        cand = self._run_stage(frames, cand, 48, "onet", self.thresholds[2], dev_frames)
        out = []
        for b, mv in cand:
            if len(b):
                b[:, :4] = apply_regression(b[:, :4], mv)[:, :4]
                b = b[nms(b[:, :4], b[:, 4], 0.7, method="min")]
            if len(b) and self.select_largest:
                area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                b = b[np.argsort(area)[::-1]]
            out.append(b)
        return out

    @staticmethod
    def _head(head_copy) -> np.ndarray:
        """Wait for a video's stage-1 head on the host (only for its own copy,
        not for work enqueued after it) and return it."""
        host, ready = head_copy
        if ready is not None:
            ready.synchronize()
        return host.numpy()

    def _run_stage(self, frames, cand, size, name, threshold, dev_frames):
        """R-Net or O-Net over every frame's candidates in one call. Returns
        per frame ``(boxes5, reg4)``: the candidates that pass, with the net's
        score in column 4, and the raw regression for the caller to apply in
        the stage's order."""
        empty = (np.zeros((0, 5)), np.zeros((0, 4)))
        if sum(len(b) for b in cand) == 0:
            return [empty for _ in cand]
        if self.device_crops and dev_frames is not None:
            H = dev_frames.shape[1] // self.input_scale
            W = dev_frames.shape[2] // self.input_scale
            coords, valids = zip(*(_valid_box_coords(b, W, H) for b in cand))
            prob, reg = self._stage_net_device(dev_frames, coords, size, name)
        else:
            crops, valids = [], []
            bgr = self.channel_order == "bgr"
            for t, b in enumerate(cand):
                # BGR: a view of the frame; the resize's product copies it anyway
                img = frames[t][..., ::-1] if bgr else frames[t]
                c, v = _crop_resize(img, b, size, scale=self.input_scale)
                crops.append(c)
                valids.append(v)
            prob, reg = self._stage_net_host(np.concatenate(crops), name)
        results = []
        off = 0
        for b, v in zip(cand, valids):
            k = len(b)
            p, r = prob[off:off + k], reg[off:off + k]
            off += k
            keep = (p > threshold) & v  # strictly above the threshold
            if not keep.any():
                results.append(empty)
                continue
            new = b[keep].copy()
            new[:, 4] = p[keep]
            results.append((new, r[keep]))
        return results

    @torch.inference_mode()
    def _stage_net_host(self, crops: np.ndarray, name: str) -> tuple[np.ndarray, np.ndarray]:
        """The net over host crops (n, size, size, 3) → (score (n,), reg (n, 4))."""
        inp = torch.from_numpy((crops - 127.5) * 0.0078125).permute(0, 3, 1, 2)
        with exact_fp32():
            out = self.nets[name](inp.to(self.device))
        return out[0][:, 1].cpu().numpy(), out[1].cpu().numpy()

    @torch.inference_mode()
    def _stage_net_device(self, dev_frames: torch.Tensor, coords: Sequence[np.ndarray],
                          size: int, name: str) -> tuple[np.ndarray, np.ndarray]:
        """Device crops of every frame's candidates (``coords[t]`` (k_t, 4)
        int64) and the net over all of them in one call: only the coordinates
        go to the device and only the scores and regressions come back."""
        crops = []
        with exact_fp32():
            for t, c in enumerate(coords):
                if not len(c):
                    continue
                boxes = torch.from_numpy(c).to(self.device)
                for k0 in range(0, len(c), _CROP_CHUNK):
                    crops.append(_device_crops(dev_frames[t], boxes[k0:k0 + _CROP_CHUNK], size,
                                               self.input_scale, self.channel_order == "bgr"))
            out = self.nets[name]((torch.cat(crops) - 127.5) * 0.0078125)
        return out[0][:, 1].cpu().numpy(), out[1].cpu().numpy()
