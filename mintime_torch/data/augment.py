"""The image transforms without cv2, in torch on any device: the evaluation
transform and the train-mode augmentations (counterparts of
``mintime_tpu/data/augment.py:116-771``), each computing what cv2 computes.

The resize chain runs crop by crop, since crops differ in size:
``IsotropicResize`` scales a crop's longer side to ``size`` (INTER_AREA or
the drawn ``down`` when it shrinks, INTER_CUBIC or the drawn ``up`` when it
grows), ``PadIfNeeded`` centres it on a black ``size`` x ``size`` square and
``Resize`` (INTER_LINEAR) is then the identity. The evaluation transform is
that chain with fixed steps (:func:`create_val_transform`). The resizes:

* INTER_AREA at a non-integer scale weights each source pixel by its
  fractional overlap with the output cell (float32 weights, summed in float32
  in source order, first along a row, then down the rows) and rounds half to
  even. At an integer scale cv2 averages whole blocks instead: a 2 x 2 block
  rounds half up, a larger one is ``sum * float32(1 / area)`` rounded half
  to even.
* INTER_CUBIC (``A = -0.75``, indices clamped at the border) is Intel IPP's
  when both sides of the crop are 4 or more, as OpenCV 5.0 hands it over:
  float32 weights and float32 fused multiply-adds in a fixed order. Below
  that it is OpenCV's own: 11-bit weights, integer rows, and its SSE loop's
  float32 columns.
* INTER_LINEAR is cv2's 11-bit fixed point.

Against ``cv2.resize`` (OpenCV 5.0) on random uint8 crops every path is
bit-exact.

The train-mode steps, drawn by :mod:`mintime_torch.data.augment_plan`, run
after the chain once over a video's ``(F, S, S, 3)`` uint8 stack
(:func:`train_transform`); statistics that cv2 takes frame by frame stay per
frame. Images stay uint8 0..255.
"""

from __future__ import annotations

import math
import sys
from typing import Sequence

import numpy as np
import torch

from mintime_torch.data import augment_plan as ap
from mintime_torch.data import colorspace, draw, jpeg
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


def _cubic_weight(t: np.ndarray, outer: bool) -> np.ndarray:
    """The ``A = -0.75`` cubic kernel at distances ``t`` (``0 <= t < 1``
    inner, ``1 <= t < 2`` outer), Horner's rule in double precision."""
    a = -0.75
    t = t.astype(np.float64)
    if outer:
        return ((a * t - 5 * a) * t + 8 * a) * t - 4 * a
    return ((a + 2) * t - (a + 3)) * t * t + 1


def cubic_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """IPP's INTER_CUBIC table for one axis (cv2 hands an 8-bit cubic resize
    to Intel IPP when both sides of the source are 4 or more): ``(dst, 4)``
    source indices clamped at the border and float32 weights. The fraction
    of ``(d + 0.5) * src / dst - 0.5`` is rounded to float32; the first
    tap's distance ``t = 1 + x`` is a float32 sum, the others ``t - 1``,
    ``2 - t`` and ``3 - t``, each weighed in double and rounded to float32."""
    fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx)
    t = (fx - sx).astype(np.float32) + np.float32(1)
    one = np.float32(1)
    wt = np.stack([_cubic_weight(t, True), _cubic_weight(t - one, False),
                   _cubic_weight(2 * one - t, False), _cubic_weight(3 * one - t, True)],
                  axis=1).astype(np.float32)
    idx = np.clip(sx[:, None].astype(np.int64) + np.arange(-1, 3), 0, src - 1)
    return idx, wt


def cubic_taps_fixed(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's own 8-bit INTER_CUBIC table (``interpolateCubic``), used when
    a side of the source is under 4: clamped indices and 11-bit weights,
    ``round(w * 2048)`` of float32 weights, the last ``1 - w0 - w1 - w2``."""
    f32 = np.float32
    fx = ((np.arange(dst) + 0.5) * _scale(src, dst) - 0.5).astype(f32)
    sx = np.floor(fx)
    x = (fx - sx).astype(f32)
    a, one = f32(-0.75), f32(1)
    c0 = ((a * (x + one) - f32(5) * a) * (x + one) + f32(8) * a) * (x + one) - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    c2 = ((a + f32(2)) * (one - x) - (a + f32(3))) * (one - x) * (one - x) + one
    wt = np.stack([c0, c1, c2, one - c0 - c1 - c2], axis=1).astype(f32)
    idx = np.clip(sx[:, None].astype(np.int64) + np.arange(-1, 3), 0, src - 1)
    return idx, np.rint(wt * f32(2048)).astype(np.int32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in double, the sum is rounded to odd (its error found
    by Knuth's two-sum), and then to float32, which makes the one rounding
    exact."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _cubic(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """cv2's 8-bit INTER_CUBIC on OpenCV 5.0, through IPP: along each row a
    chain of float32 fused multiply-adds from the first tap to the last,
    then down the columns ``fma(s0, w0, s1 * w1) + fma(s2, w2, s3 * w3)``,
    rounded half to even. The four taps are gathered in one call a side."""
    h, w = img.shape[:2]
    dev = img.device
    taps_x = cubic_taps(w, nw)
    ix, wx = (torch.from_numpy(t.T.copy()).to(dev) for t in taps_x)
    iy, wy = (torch.from_numpy(t.T.copy()).to(dev) for t in cubic_taps(h, nh))
    taps = img.to(torch.float64).index_select(1, ix.reshape(-1)).reshape(h, 4, nw, -1)
    # Along a row every product and partial sum is a multiple of 2**-43 (a
    # weight of 2**-20 or more times a whole level) under 2**10, so its
    # float64 sum is exact and needs no rounding to odd; a weight under
    # 2**-20 comes only from growing a side past ~700 px.
    nonzero = np.abs(taps_x[1][taps_x[1] != 0])
    if nonzero.min() >= 2.0 ** -20:
        prods = taps * wx.to(torch.float64)[:, :, None]
        rows = prods[:, 0].to(torch.float32)
        for j in range(1, 4):
            rows = (prods[:, j] + rows.to(torch.float64)).to(torch.float32)
    else:
        rows = taps[:, 0].to(torch.float32) * wx[0, :, None]
        for j in range(1, 4):
            rows = fma_f32(taps[:, j], wx[j, :, None], rows)
    cols = rows.index_select(0, iy.reshape(-1)).reshape(4, nh, nw, -1)
    b = wy[:, :, None, None]
    pair = fma_f32(cols[0::2], b[0::2], cols[1::2] * b[1::2])  # (s0, s1), (s2, s3)
    return torch.round(pair[0] + pair[1])


def _cubic_fixed(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """OpenCV's own 8-bit INTER_CUBIC: exact integer rows; down the columns
    its SSE loop, 8 values of a row at a time, in float32
    ``s0*b0 + (s1*b1 + (s2*b2 + s3*b3))`` with ``b = w / 2**22`` rounded
    half to even, and the values left over in integers, rounded half up."""
    h, w = img.shape[:2]
    dev = img.device
    ix, wx = (torch.from_numpy(t).to(dev) for t in cubic_taps_fixed(w, nw))
    iy, wy = (torch.from_numpy(t).to(dev) for t in cubic_taps_fixed(h, nh))
    x = img.to(torch.int32)
    rows = sum(x.index_select(1, ix[:, j]) * wx[:, j, None] for j in range(4))
    s = [rows.index_select(0, iy[:, j]) for j in range(4)]
    exact = sum(s[j] * wy[:, j, None, None] for j in range(4))
    exact = (exact + (1 << 21)) >> 22
    sf = [v.to(torch.float32) for v in s]
    b = [wy[:, j, None, None].to(torch.float32) * (2.0 ** -22) for j in range(4)]
    simd = torch.round(sf[0] * b[0] + (sf[1] * b[1] + (sf[2] * b[2] + sf[3] * b[3])))
    n = nw * img.shape[2]
    body = n // 8 * 8
    out = exact.to(torch.float32).reshape(nh, n)
    out[:, :body] = simd.reshape(nh, n)[:, :body]
    return out.reshape(nh, nw, -1)


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


def linear_taps(src: int, dst: int, clamp: bool) -> tuple:
    """cv2's 8-bit INTER_LINEAR table for one axis: the two source indices
    (clamped to the image) and their 11-bit weights. The float32 offset
    ``(d + 0.5) * scale - 0.5`` splits into an index and a fraction; along
    x (``clamp``) a tap left of the first or right of the last pixel is
    moved onto it with the fraction 0, along y only the index is clamped."""
    f = ((np.arange(dst) + 0.5) * _scale(src, dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    w0 = np.round((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.round(f * np.float32(2048)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _linear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """cv2's 8-bit INTER_LINEAR (11-bit fixed point): rows summed exactly,
    then each weighted row shifted down 4 bits, multiplied by its 11-bit
    weight keeping the high 16 bits, and the sum rounded off 2 bits."""
    h, w = img.shape[-3:-1]
    dev = img.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev) for t in linear_taps(w, nw, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev) for t in linear_taps(h, nh, False))
    x = img.to(torch.int32)
    rows = x.index_select(-2, x0) * a0[:, None] + x.index_select(-2, x1) * a1[:, None]
    v = (((rows.index_select(-3, y0) >> 4) * b0[:, None, None]) >> 16) \
        + (((rows.index_select(-3, y1) >> 4) * b1[:, None, None]) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


def resize(img: torch.Tensor, nh: int, nw: int, interpolation: str | None = None) -> torch.Tensor:
    """``cv2.resize(img, (nw, nh), interpolation=...)`` of a ``(h, w, 3)``
    uint8 tensor: ``"area"``, ``"cubic"`` or ``"linear"`` (``...`` leading
    dims too for ``"linear"``). The default is ``IsotropicResize``'s
    evaluation choice: INTER_AREA when neither side grows, else
    INTER_CUBIC."""
    h, w = img.shape[-3:-1]
    if (nh, nw) == (h, w):
        return img
    if interpolation is None:
        interpolation = "area" if nh <= h and nw <= w else "cubic"
    if interpolation == "linear":
        return _linear(img, nh, nw)
    if interpolation == "area":
        if not (nh <= h and nw <= w):
            raise ValueError("INTER_AREA is ported for shrinking only")
        sy, sx = _scale(h, nh), _scale(w, nw)
        ky, kx = round(sy), round(sx)
        eps = sys.float_info.epsilon  # cv2's DBL_EPSILON test for a whole scale
        if abs(sy - ky) < eps and abs(sx - kx) < eps:
            out = _area_fast(img, ky, kx)
        else:
            out = _apply_taps(img.to(torch.float32), 1, *area_taps(w, nw))
            out = torch.round(_apply_taps(out, 0, *area_taps(h, nh)))
    elif interpolation == "cubic":
        if nh < h or nw < w:
            raise ValueError("INTER_CUBIC is ported for growing only")
        out = _cubic(img, nh, nw) if min(h, w) >= 4 else _cubic_fixed(img, nh, nw)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    return out.clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------- train mode
# The train-mode augmentations (``mintime_tpu/data/augment.py:187-760``) on a
# device. A video's steps come from :mod:`mintime_torch.data.augment_plan`;
# the resize chain runs crop by crop, every other step once over the
# video's ``(F, S, S, 3)`` uint8 stack. Each step computes what cv2 computes
# frame by frame: statistics (FancyPCA's covariance, ColorJitter's mean,
# ISONoise's deviation) stay per frame, drawn arrays serve every frame.

def _dev_table(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)


def _lut(x: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """``cv2.LUT``: a ``(256,)`` table for every channel, a ``(256, 3)`` one
    per channel, or ``(F, 256, 3)`` per frame and channel."""
    t = _dev_table(table, x)
    if t.ndim == 1:
        return t[x.long()]
    idx = x.long() * 3 + torch.arange(3, device=x.device)
    if t.ndim == 3:
        idx = idx + (torch.arange(x.shape[0], device=x.device) * 768).reshape(-1, 1, 1, 1)
    return t.reshape(-1)[idx]


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``np.clip(x, 0, 255).astype(np.uint8)``: clipped, truncated."""
    return x.clamp(0, 255).to(torch.uint8)


def _border_index(n: int, before: int, after: int, mode: str) -> np.ndarray:
    """Source indices of a padded axis: cv2's BORDER_REFLECT_101 or
    BORDER_REPLICATE."""
    i = np.arange(-before, n + after)
    if mode == "replicate" or n == 1:
        return np.clip(i, 0, n - 1)
    period = 2 * n - 2
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def _padded(x: torch.Tensor, before: int, after: int, mode: str) -> torch.Tensor:
    """``(F, H, W, C)`` padded on both image axes."""
    dev = x.device
    rows = torch.from_numpy(_border_index(x.shape[1], before, after, mode)).to(dev)
    cols = torch.from_numpy(_border_index(x.shape[2], before, after, mode)).to(dev)
    return x.index_select(1, rows).index_select(2, cols)


def _sep_filter_int(x: torch.Tensor, kx: Sequence[int], ky: Sequence[int]) -> torch.Tensor:
    """Integer separable filter, BORDER_REFLECT_101, centred: rows by ``kx``,
    then columns by ``ky`` (int32 sums)."""
    r = len(kx) // 2
    p = _padded(x.to(torch.int32), r, r, "reflect101")
    h, w = x.shape[1:3]
    rows = sum(int(k) * p[:, :, j:j + w] for j, k in enumerate(kx))
    return sum(int(k) * rows[:, j:j + h] for j, k in enumerate(ky))


def gaussian_kernel_fixed(k: int, sigma: float) -> list[int]:
    """cv2's 8-bit GaussianBlur kernel: ``getGaussianKernelBitExact`` in
    double, then to 8 fraction bits with the error carried from tap to tap
    (``getGaussianKernelFixedPoint_ED``); the taps sum to 256."""
    if sigma <= 0 and k in (1, 3, 5, 7):
        return {1: [256], 3: [64, 128, 64], 5: [16, 64, 96, 64, 16],
                7: [8, 28, 56, 72, 56, 28, 8]}[k]
    s = sigma if sigma > 0 else k * 0.15 + 0.35
    scale2 = -0.125 / (s * s)
    half = (k - 1) // 2
    vals = [math.exp((x * x) * scale2) for x in range(1 - k, 1 - k + 2 * half, 2)]
    total = 2 * sum(vals) + 1.0
    mul = 1.0 / total
    taps, err, acc = [], 0.0, 0
    for v in vals:
        adj = v * mul * 256 + err
        v0 = int(np.round(adj))
        err = adj - v0
        taps.append(v0)
        acc += v0
    return taps + [256 - 2 * acc] + taps[::-1]


def gaussian_blur(x: torch.Tensor, k: int, sigma: float = 0.0) -> torch.Tensor:
    """``cv2.GaussianBlur`` of 8-bit frames, cv2's fixed-point path: the
    16-bit row sums times the column taps, rounded off 16 bits, half up."""
    if sigma > 0 and k <= 0:
        k = int(np.round(sigma * 3 * 2 + 1)) | 1
    taps = gaussian_kernel_fixed(k, sigma)
    return ((_sep_filter_int(x, taps, taps) + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def box_blur3(x: torch.Tensor) -> torch.Tensor:
    """``cv2.blur(x, (3, 3))``: 9-sums, divided as cv2's 8-bit column
    filter divides, ``((s + 4) * 7282) >> 16``."""
    s = _sep_filter_int(x, (1, 1, 1), (1, 1, 1))
    return (((s + 4) * 7282) >> 16).clamp(0, 255).to(torch.uint8)


def median_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur``: the exact median of the ``k`` x ``k`` window,
    BORDER_REPLICATE."""
    r = k // 2
    p = _padded(x, r, r, "replicate")
    h, w = x.shape[1:3]
    win = torch.stack([p[:, i:i + h, j:j + w] for i in range(k) for j in range(k)], dim=-1)
    return win.median(dim=-1).values


def filter2d(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """``cv2.filter2D(x, -1, kernel)`` of 8-bit frames with a float32 kernel:
    the kernel's non-zero taps in row order, each added by a float32 fused
    multiply-add, BORDER_REFLECT_101, anchor at ``k // 2``, rounded half to
    even."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = x.shape[1:3]
    dev = x.device
    rows = torch.from_numpy(_border_index(h, ay, kh - 1 - ay, "reflect101")).to(dev)
    cols = torch.from_numpy(_border_index(w, ax, kw - 1 - ax, "reflect101")).to(dev)
    p = x.index_select(1, rows).index_select(2, cols)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    for i, j in zip(*np.nonzero(kernel)):
        acc = colorspace.fma32(p[:, i:i + h, j:j + w], kernel[i, j], acc)
    return torch.round(acc).clamp(0, 255).to(torch.uint8)


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor | float,
                 beta: float) -> torch.Tensor:
    """``cv2.addWeighted(a, alpha, b, beta, 0)`` on 8-bit values: float32
    ``fma(a, alpha, b * beta)``, rounded half to even."""
    af, bf = np.float32(alpha), np.float32(beta)
    bb = (b.to(torch.float32) if isinstance(b, torch.Tensor)
          else torch.tensor(float(b), dtype=torch.float32, device=a.device)) * bf
    return torch.round(colorspace.fma32(a, af, bb)).clamp(0, 255).to(torch.uint8)


def np_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """numpy's float32 sum of each row of ``x`` ``(N, n)``, to the bit: the
    pairwise sums of 8192-element blocks (8 running sums up to 128
    elements, halves above), added in turn from 0."""
    n = x.shape[1]
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    full = n // 8192
    if full:
        blocks = _pairwise(x[:, :full * 8192].reshape(x.shape[0] * full, 8192))
        for s in blocks.reshape(x.shape[0], full).unbind(1):
            total = total + s
    if n % 8192:
        total = total + _pairwise(x[:, full * 8192:])
    return total


def _pairwise(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``pairwise_sum`` of each row."""
    n = x.shape[1]
    if n < 8:
        res = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for v in x.unbind(1):
            res = res + v
        return res
    if n <= 128:
        m = n - n % 8
        r = x[:, :8]
        for i in range(8, m, 8):
            r = r + x[:, i:i + 8]
        res = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3]))
               + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
        for v in x[:, m:].unbind(1):
            res = res + v
        return res
    n2 = n // 2
    n2 -= n2 % 8
    if n2 == n - n2:  # equal halves: one call for both
        halves = _pairwise(x.reshape(x.shape[0] * 2, n2)).reshape(x.shape[0], 2)
        return halves[:, 0] + halves[:, 1]
    return _pairwise(x[:, :n2]) + _pairwise(x[:, n2:])


def np_mean_std_f32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """numpy's float32 ``mean()`` and ``std()`` of each row of ``(N, n)``."""
    n = x.shape[1]
    mean = colorspace.div(np_sum_f32(x).double(), float(n)).to(torch.float32)
    d = x - mean[:, None]
    var = colorspace.div(np_sum_f32(d * d).double(), float(n)).to(torch.float32)
    return mean, torch.sqrt(var)


def _flip(x, t):
    return x.flip(2)


def _invert(x, t):
    return 255 - x


def _coarse_dropout(x, t, holes=()):
    x = x.clone()
    for y, x0, hh, ww in holes:
        x[:, y:y + hh, x0:x0 + ww] = 0
    return x


def _brightness_contrast(x, t, alpha=1.0, beta=0.0):
    return _lut(x, np.clip(np.arange(256, dtype=np.float32) * alpha + beta, 0, 255)
                .astype(np.uint8))


def _gamma(x, t, gamma=1.0):
    return _lut(x, (np.linspace(0, 1, 256) ** gamma * 255).astype(np.uint8))


def _rgb_shift(x, t, shift=None):
    return _lut(x, np.clip(np.arange(256, dtype=np.float32)[:, None] + np.asarray(shift)[None, :],
                           0, 255).astype(np.uint8))


def _gauss_noise(x, t, noise=None):
    return _to_u8(x.to(torch.float32) + _dev_table(noise, x))


def _mult_noise(x, t, m=None):
    return _to_u8(x.to(torch.float32) * _dev_table(m, x))


def _to_gray(x, t):
    return colorspace.bgr2gray(x)[..., None].expand(x.shape).to(torch.uint8)


_SEPIA = np.array([[0.272, 0.534, 0.131], [0.349, 0.686, 0.168], [0.393, 0.769, 0.189]],
                  dtype=np.float32)  # BGR rows


def _to_sepia(x, t):
    # numpy's float32 product with the 3 x 3 matrix, as its BLAS makes it:
    # a chain of fused multiply-adds over the three channels
    out = []
    for row in _SEPIA:
        acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        for c in range(3):
            acc = colorspace.fma32(x[..., c], row[c], acc)
        out.append(acc)
    return _to_u8(torch.stack(out, dim=-1))


def _fog(x, t, coef=0.2):
    return add_weighted(x, 1 - coef, 255.0, coef)


def _hue_saturation_value(x, t, dh=0.0, ds=0.0, dv=0.0):
    v = np.arange(256, dtype=np.float32)
    lut = np.stack([((v + dh) % 180).astype(np.float32).astype(np.uint8),
                    np.clip(v + ds, 0, 255).astype(np.float32).astype(np.uint8),
                    np.clip(v + dv, 0, 255).astype(np.float32).astype(np.uint8)], axis=-1)
    return colorspace.hsv2bgr(_lut(colorspace.bgr2hsv(x), lut)).to(torch.uint8)


def _color_jitter(x, t, b=1.0, c=1.0, s=1.0, h=0.0):
    out = (x.to(torch.float32) * b).clamp(0, 255)
    mean, _ = np_mean_std_f32(out.reshape(out.shape[0], -1))
    mean = mean.reshape(-1, 1, 1, 1)
    out = ((out - mean) * c + mean).clamp(0, 255)
    hsv = colorspace.bgr2hsv(out.to(torch.uint8)).to(torch.float32)
    hue = torch.fmod(hsv[..., 0] + h, 180.0)
    hue = torch.where(hue < 0, hue + 180.0, hue)
    sat = (hsv[..., 1] * s).clamp(0, 255)
    hsv = torch.stack([hue, sat, hsv[..., 2]], dim=-1).to(torch.uint8)
    return colorspace.hsv2bgr(hsv).to(torch.uint8)


def _fancy_pca(x, t, coeffs=None):
    # the frames' Gram matrices and channel sums on the device (exact in
    # float64), the 3 x 3 eigen-decompositions on the host as the JAX
    # package makes them, then one table a frame
    f, h, w = x.shape[:3]
    n = h * w
    flat = x.reshape(f, n, 3).to(torch.float64)
    gram = (flat.transpose(1, 2) @ flat).cpu().numpy().astype(np.float32)
    sums = flat.sum(1).cpu().numpy()
    luts = []
    for i in range(f):
        mu = sums[i] * (1.0 / n)
        cov = (gram[i] - n * np.outer(mu, mu)) / (max(n - 1, 1) * 255.0 * 255.0)
        ev, vec = np.linalg.eigh(cov)
        delta = (vec @ (coeffs * ev)) * 255.0
        luts.append(np.clip(np.arange(256, dtype=np.float32)[:, None]
                            + delta[None, :].astype(np.float32), 0, 255).astype(np.uint8))
    return _lut(x, np.stack(luts))


def _iso_noise(x, t, shift=0.02, intensity=0.3, seed=0):
    # each frame's generator starts from the seed; how far its Poisson draws
    # advance it depends on the frame's deviation, read back from the device
    f, h, w = x.shape[:3]
    hls = colorspace.bgr2hls(x)
    _, std = np_mean_std_f32(x.reshape(f, -1).to(torch.float32))
    lum, col = [], []
    for s in std.cpu().numpy():
        r = np.random.default_rng(seed)
        lum.append(r.poisson(s * intensity, size=(h, w)))
        col.append(r.normal(0, shift * 360 * intensity, size=(h, w)))
    lum, col = _dev_table(np.stack(lum), x), _dev_table(np.stack(col), x)
    hue = torch.fmod(hls[..., 0].double() + col, 360.0)
    hue = torch.where(hue < 0, hue + 360.0, hue).to(torch.float32)
    light = hls[..., 1].to(torch.float32)
    light = (light.double() + lum.double() * (1 - colorspace.div(light, 255.0)).double()) \
        .clamp(0, 255)
    # numpy's float → uint8 cast keeps the low byte of the truncated value
    hls = torch.stack([hue.to(torch.int32) & 255, light.to(torch.float32).to(torch.int32),
                       hls[..., 2]], dim=-1)
    return colorspace.hls2bgr(hls).to(torch.uint8)


def _clahe(x, t, clip=2.0):
    lab = colorspace.bgr2lab(x)
    light = clahe(lab[..., 0], clip)
    return colorspace.lab2bgr(torch.stack([light, lab[..., 1], lab[..., 2]], dim=-1)) \
        .to(torch.uint8)


def clahe(plane: torch.Tensor, clip: float, tiles: int = 8) -> torch.Tensor:
    """``cv2.createCLAHE(clip, (tiles, tiles)).apply`` of ``(F, H, W)``
    8-bit planes: per-tile histograms clipped at ``int(clip * area / 256)``,
    the excess spread evenly and its remainder one a ``256 // residual``
    step, tables ``round(cumsum * float32(255 / area))``, and the blend of
    the four nearest tiles' tables in float32 (BORDER_REFLECT_101 padding
    to whole tiles for the histograms only)."""
    f, h, w = plane.shape
    dev = plane.device
    ext = plane
    if h % tiles or w % tiles:
        ph, pw = (tiles - h % tiles) % tiles, (tiles - w % tiles) % tiles
        rows = torch.from_numpy(_border_index(h, 0, ph, "reflect101")).to(dev)
        cols = torch.from_numpy(_border_index(w, 0, pw, "reflect101")).to(dev)
        ext = plane.index_select(1, rows).index_select(2, cols)
    th, tw = ext.shape[1] // tiles, ext.shape[2] // tiles
    area = th * tw
    vals = ext.reshape(f, tiles, th, tiles, tw).transpose(2, 3).reshape(f, tiles * tiles, area)
    hist = torch.zeros(f, tiles * tiles, 256, dtype=torch.int64, device=dev)
    hist.scatter_add_(2, vals.long(), torch.ones_like(vals, dtype=torch.int64))
    if clip > 0:
        limit = max(int(clip * area / 256), 1)
        clipped = (hist - limit).clamp(min=0).sum(-1, keepdim=True)
        hist = hist.clamp(max=limit)
        batch = clipped // 256
        residual = clipped - batch * 256
        hist = hist + batch
        step = torch.clamp(256 // residual.clamp(min=1), min=1)
        i = torch.arange(256, device=dev)
        extra = (i % step == 0) & (i // step < residual) & (residual > 0)
        hist = hist + extra.long()
    scale = np.float32(255.0 / area)
    lut = torch.round(torch.cumsum(hist, -1).to(torch.float32) * scale).clamp(0, 255)
    lut = lut.reshape(f, tiles, tiles, 256)

    def coords(n, size):
        inv = np.float32(1.0) / np.float32(size)
        pos = (np.arange(n, dtype=np.float32) * inv - np.float32(0.5)).astype(np.float32)
        lo = np.floor(pos)
        frac = (pos - lo).astype(np.float32)
        lo = lo.astype(np.int64)
        return (torch.from_numpy(np.clip(lo, 0, tiles - 1)).to(dev),
                torch.from_numpy(np.clip(lo + 1, 0, tiles - 1)).to(dev),
                torch.from_numpy(frac).to(dev), torch.from_numpy(np.float32(1) - frac).to(dev))

    y1, y2, ya, ya1 = coords(h, th)
    x1, x2, xa, xa1 = coords(w, tw)
    v = plane.long()
    fi = torch.arange(f, device=dev).reshape(-1, 1, 1)

    def at(ty, tx):
        return lut[fi, ty.reshape(1, -1, 1), tx.reshape(1, 1, -1), v]

    top = at(y1, x1) * xa1 + at(y1, x2) * xa
    bottom = at(y2, x1) * xa1 + at(y2, x2) * xa
    res = top * ya1[:, None] + bottom * ya[:, None]
    return torch.round(res).clamp(0, 255).to(torch.int32)


def _gaussian_blur_step(x, t, k=3):
    return gaussian_blur(x, k)


def _median_step(x, t, k=3):
    return median_blur(x, k)


def _motion_blur(x, t, kernel=None):
    return filter2d(x, kernel)


def _glass_blur(x, t, seed=0):
    h, w = x.shape[1:3]
    r = np.random.default_rng(seed)
    out = gaussian_blur(x, 0, t.sigma)
    dy, dx = r.integers(-t.max_delta, t.max_delta + 1, size=(2, h, w))
    ys = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
    xs = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
    idx = _dev_table(ys * w + xs, x).reshape(-1)
    out = out.reshape(x.shape[0], h * w, 3).index_select(1, idx).reshape(x.shape)
    return gaussian_blur(out, 0, t.sigma)


def _downscale(x, t, scale=0.5):
    h, w = x.shape[1:3]
    small = torch.stack([resize(f, max(1, int(h * scale)), max(1, int(w * scale)), "area")
                         for f in x])
    return resize(small, h, w, "linear")


def warp_affine_matrix(h: int, w: int, dx: float, dy: float, scale: float,
                       angle: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` about the centre plus the shift, as
    ``ShiftScaleRotate`` builds it."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = w / 2, h / 2
    m = np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                  [-beta, alpha, beta * cx + (1 - alpha) * cy]])
    m[0, 2] += dx * w
    m[1, 2] += dy * h
    return m


def warp_affine(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``cv2.warpAffine(x, m, (w, h))`` of 8-bit frames, bilinear, constant 0
    border, as OpenCV 5 computes it: the inverse map in float32, a source
    position ``fma(M0, x, M1 * y + M2)``, and two fused lerps across then
    one down, rounded half to even; a neighbour outside the image counts as
    0."""
    f, h, w = x.shape[:3]
    dev = x.device
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    inv = np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                    [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]]).astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]

    def coord(row):
        off = (row[1] * ys + row[2]).astype(np.float32)
        return (np.float64(row[0]) * xs + off).astype(np.float32)

    sx, sy = coord(inv[0]), coord(inv[1])
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    alpha = _dev_table((sx - ix).astype(np.float32), x)[None, :, :, None]
    beta = _dev_table((sy - iy).astype(np.float32), x)[None, :, :, None]
    flat = x.reshape(f, h * w, 3).to(torch.float32)

    def tap(oy, ox):
        yy, xx = iy + oy, ix + ox
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = _dev_table(np.where(inside, yy * w + xx, 0).reshape(-1), x)
        vals = flat.index_select(1, idx).reshape(f, h, w, 3)
        return vals * _dev_table(inside, x)[None, :, :, None]

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = colorspace.fma32(alpha, p01 - p00, p00)
    bottom = colorspace.fma32(alpha, p11 - p10, p10)
    return torch.round(colorspace.fma32(beta, bottom - top, top)).clamp(0, 255).to(torch.uint8)


def _shift_scale_rotate(x, t, dx=0.0, dy=0.0, scale=1.0, angle=0.0):
    h, w = x.shape[1:3]
    return warp_affine(x, warp_affine_matrix(h, w, dx, dy, scale, angle))


def _shadow(x, t, pts=None, strength=0.5):
    overlay = np.ones(x.shape[1:3], np.float32)
    draw.fill_poly(overlay, pts, np.float32(strength))
    return _to_u8(x.to(torch.float32) * _dev_table(overlay, x)[None, :, :, None])


def _rain(x, t, drops=None, length=10):
    mask = np.zeros(x.shape[1:3], bool)
    for dx_, dy_ in drops:
        draw.line(mask, (int(dx_), int(dy_)), (int(dx_), int(dy_) + length), True)
    x = torch.where(_dev_table(mask, x)[None, :, :, None], torch.tensor(200, dtype=torch.uint8,
                                                                          device=x.device), x)
    return box_blur3(x)


def _sun_flare(x, t, center=(0, 0), radius=20):
    mask = np.zeros(x.shape[1:3], bool)
    draw.fill_circle(mask, center, radius, True)
    overlay = torch.where(_dev_table(mask, x)[None, :, :, None],
                          torch.tensor(255, dtype=torch.uint8, device=x.device), x)
    return add_weighted(x, 0.7, overlay, 0.3)


def _jpeg(x, t, quality=90):
    return jpeg.jpeg_roundtrip(x, quality)


#: each step's function of the ``(F, S, S, 3)`` uint8 stack, by transform name
STACK_STEPS = {
    "HorizontalFlip": _flip, "InvertImg": _invert, "CoarseDropout": _coarse_dropout,
    "RandomBrightnessContrast": _brightness_contrast, "RandomGamma": _gamma,
    "RGBShift": _rgb_shift, "GaussNoise": _gauss_noise, "MultiplicativeNoise": _mult_noise,
    "ToSepia": _to_sepia, "RandomFog": _fog, "ToGray": _to_gray,
    "HueSaturationValue": _hue_saturation_value, "ColorJitter": _color_jitter,
    "FancyPCA": _fancy_pca, "ISONoise": _iso_noise, "CLAHE": _clahe,
    "GaussianBlur": _gaussian_blur_step, "MedianBlur": _median_step,
    "MotionBlur": _motion_blur, "GlassBlur": _glass_blur, "ShiftScaleRotate": _shift_scale_rotate,
    "RandomShadow": _shadow, "RandomRain": _rain, "RandomSunFlare": _sun_flare,
    "ImageCompression": _jpeg, "Downscale": _downscale,
}
#: the steps that run crop by crop (the resize chain)
CROP_STEPS = ("IsotropicResize", "PadIfNeeded", "Resize")


def apply_step(x: torch.Tensor, step: tuple) -> torch.Tensor:
    """One drawn step, ``(transform, params)``, over a ``(F, S, S, 3)``
    uint8 stack."""
    t, params = step
    fn = STACK_STEPS.get(t.name)
    if fn is None:
        raise ValueError(f"transform {t.name!r} is not ported to torch")
    return fn(x, t, **params)


def crop_step(img: torch.Tensor, step: tuple) -> torch.Tensor:
    """One step of the resize chain on a ``(h, w, 3)`` crop."""
    t, _ = step
    h, w = img.shape[:2]
    if t.name == "IsotropicResize":
        nh, nw = isotropic_size(h, w, t.max_side)
        if (nh, nw) == (h, w):
            return img
        return resize(img, nh, nw, t.up if t.max_side / max(h, w) > 1 else t.down)
    if t.name == "PadIfNeeded":
        ph, pw = max(0, t.min_h - h), max(0, t.min_w - w)
        if ph == 0 and pw == 0:
            return img
        out = torch.zeros((h + ph, w + pw, 3), dtype=img.dtype, device=img.device)
        out[ph // 2:ph // 2 + h, pw // 2:pw // 2 + w] = img
        return out
    if t.name == "Resize":
        return resize(img, t.h, t.w, "linear")
    raise ValueError(f"{t.name!r} is not a resize-chain step")


def _on_device(crop, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(crop) if isinstance(crop, np.ndarray)
                           else crop).to(dev)


def resize_chain(crops: Sequence, steps: Sequence[tuple],
                 device: str | torch.device = "cuda") -> tuple[torch.Tensor, list]:
    """Crops (numpy arrays or tensors) → their ``(F, S, S, 3)`` uint8 stack on
    ``device`` after the leading resize-chain steps, crop by crop, and the
    steps left."""
    dev = resolve_device(device)
    n = 0
    while n < len(steps) and steps[n][0].name in CROP_STEPS:
        n += 1
    out = []
    for crop in crops:
        img = _on_device(crop, dev)
        for step in steps[:n]:
            img = crop_step(img, step)
        out.append(img)
    return torch.stack(out), list(steps[n:])


def apply_steps(stack: torch.Tensor, steps: Sequence[tuple]) -> torch.Tensor:
    """Every drawn step, in order, once over a video's ``(F, S, S, 3)`` stack."""
    for step in steps:
        stack = apply_step(stack, step)
    return stack


def train_transform(crops: Sequence, steps: Sequence[tuple],
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """A video's drawn steps on a device: the resize chain crop by crop, then
    the rest once over the video's stack."""
    return apply_steps(*resize_chain(crops, steps, device))


def create_val_transform(size: int):
    """IsotropicResize(size, area, cubic) → PadIfNeeded → Resize, the
    evaluation path: a function of ``(crops, device="cuda")`` that gives one
    ``(F, size, size, 3)`` uint8 tensor on the device (``"cuda"`` raises
    without a card)."""
    steps = [(ap.IsotropicResize(size, ap.INTER_AREA, ap.INTER_CUBIC), {}),
             (ap.PadIfNeeded(size, size), {}), (ap.Resize(size, size), {})]

    def transform(crops: Sequence, device: str | torch.device = "cuda") -> torch.Tensor:
        return resize_chain(crops, steps, device)[0]
    return transform
