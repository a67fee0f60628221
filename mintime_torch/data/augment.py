"""The evaluation transform without cv2 (counterpart of ``IsotropicResize``,
``PadIfNeeded``, ``Resize`` and ``create_val_transform`` from
``mintime_tpu/data/augment.py:116-184,763-771``).

``IsotropicResize`` scales a crop's longer side to ``size`` with cv2's
INTER_AREA when it shrinks and INTER_CUBIC when it grows; ``PadIfNeeded``
centres it on a black ``size`` x ``size`` square; ``Resize`` is then the
identity. Here the resize is computed with torch on any device, as cv2
computes it:

* INTER_AREA at a non-integer scale weights each source pixel by its
  fractional overlap with the output cell (float32 weights, summed in float32
  in source order, first along a row, then down the rows) and rounds half to
  even. At an integer scale cv2 averages whole blocks instead: a 2 x 2 block
  rounds half up, a larger one is ``sum * float32(1 / area)`` rounded half
  to even.
* INTER_CUBIC takes four taps a side with ``A = -0.75``, indices clamped at
  the border, rows first, in double precision, rounded half to even.

Against ``cv2.resize`` (OpenCV 5.0) on random uint8 crops the area path is
bit-exact and the cubic path differs by one level in about 1e-5 of the
pixels. Images stay uint8 0..255; the evaluation path draws nothing at
random, so the training augmentations are not here.
"""

from __future__ import annotations

import math
import sys
from typing import Sequence

import numpy as np
import torch

from mintime_torch.device import resolve_device

def isotropic_size(h: int, w: int, max_side: int) -> tuple[int, int]:
    """The size ``IsotropicResize`` gives an ``h`` x ``w`` crop (Python's
    ``round``, half to even, as the reference's)."""
    if max(h, w) == max_side:
        return h, w
    scale = max_side / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def _scale(src: int, dst: int) -> float:
    """cv2's source pixels an output pixel: ``1 / (dst / src)`` in double."""
    return 1.0 / (dst / src)


def area_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2's INTER_AREA table for one axis (``computeResizeAreaTab``):
    ``(dst, K)`` source indices and float32 weights in source order, padded
    with weight 0 (which adds an exact zero)."""
    scale = _scale(src, dst)
    rows = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(fsx2 - sx2, 1.0, cell) / cell))
        rows.append(taps)
    k = max(map(len, rows))
    idx = np.zeros((dst, k), np.int64)
    wt = np.zeros((dst, k), np.float32)
    for dx, taps in enumerate(rows):
        for j, (sx, a) in enumerate(taps):
            idx[dx, j], wt[dx, j] = sx, a
    return idx, wt


def cubic_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2's INTER_CUBIC table for one axis: ``(dst, 4)`` source indices
    (clamped at the border) and float64 weights of the ``A = -0.75`` kernel."""
    a = -0.75
    fx = (np.arange(dst) + 0.5) * _scale(src, dst) - 0.5
    sx = np.floor(fx)
    x = fx - sx
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    wt = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=1)
    idx = np.clip(sx[:, None].astype(np.int64) + np.arange(-1, 3), 0, src - 1)
    return idx, wt


def _apply_taps(x: torch.Tensor, axis: int, idx: np.ndarray, wt: np.ndarray) -> torch.Tensor:
    """Weighted sum of ``x``'s slices along ``axis`` (0 rows, 1 columns) by
    the table, tap after tap, in ``wt``'s dtype (no fused multiply-add, as
    cv2's uint8 loops)."""
    idx_t = torch.from_numpy(idx).to(x.device)
    wt_t = torch.from_numpy(wt).to(x.device)
    shape = [1, 1, 1]
    shape[axis] = -1
    out = None
    for j in range(idx.shape[1]):
        term = x.index_select(axis, idx_t[:, j]) * wt_t[:, j].reshape(shape)
        out = term if out is None else out + term
    return out


def _area_fast(x: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """cv2's integer-scale INTER_AREA: whole ``ky`` x ``kx`` block sums."""
    s = x.to(torch.int32).reshape(x.shape[0] // ky, ky, x.shape[1] // kx, kx, 3).sum((1, 3))
    if (ky, kx) == (2, 2):
        return torch.div(s + 2, 4, rounding_mode="floor")
    return torch.round(s.to(torch.float32) * torch.tensor(1.0 / (ky * kx), dtype=torch.float32,
                                                         device=x.device))


def resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``cv2.resize(img, (nw, nh))`` of a ``(h, w, 3)`` uint8 tensor with
    ``IsotropicResize``'s interpolation: INTER_AREA when neither side grows,
    else INTER_CUBIC."""
    h, w = img.shape[:2]
    if (nh, nw) == (h, w):
        return img
    if nh <= h and nw <= w:
        sy, sx = _scale(h, nh), _scale(w, nw)
        ky, kx = round(sy), round(sx)
        eps = sys.float_info.epsilon  # cv2's DBL_EPSILON test for a whole scale
        if abs(sy - ky) < eps and abs(sx - kx) < eps:
            out = _area_fast(img, ky, kx)
        else:
            out = _apply_taps(img.to(torch.float32), 1, *area_taps(w, nw))
            out = torch.round(_apply_taps(out, 0, *area_taps(h, nh)))
    else:
        out = _apply_taps(img.to(torch.float64), 1, *cubic_taps(w, nw))
        out = torch.round(_apply_taps(out, 0, *cubic_taps(h, nh)))
    return out.clamp(0, 255).to(torch.uint8)


class ValTransform:
    """``IsotropicResize(size)`` → ``PadIfNeeded(size, size)`` →
    ``Resize(size, size)`` on a device: uint8 crops ``(h, w, 3)`` of any
    size (numpy arrays or tensors) → one ``(F, size, size, 3)`` uint8
    tensor on ``device`` (default ``"cuda"``, which raises without a card)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, crops: Sequence, device: str | torch.device = "cuda") -> torch.Tensor:
        dev = resolve_device(device)
        s = self.size
        out = torch.zeros((len(crops), s, s, 3), dtype=torch.uint8, device=dev)
        for i, crop in enumerate(crops):
            img = torch.as_tensor(np.ascontiguousarray(crop) if isinstance(crop, np.ndarray)
                                  else crop).to(dev)
            img = resize(img, *isotropic_size(img.shape[0], img.shape[1], s))
            h, w = img.shape[:2]  # the longer side is s, so Resize is the identity
            top, left = (s - h) // 2, (s - w) // 2  # PadIfNeeded: zeros around the centre
            out[i, top:top + h, left:left + w] = img
        return out


def create_val_transform(size: int) -> ValTransform:
    """IsotropicResize → PadIfNeeded → Resize, the evaluation path."""
    return ValTransform(size)
