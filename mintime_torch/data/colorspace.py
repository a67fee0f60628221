"""cv2's 8-bit colour conversions in torch, on any device (the conversions
the train-mode augmentations make: BGR to gray, HSV, HLS and Lab and back).

Each follows OpenCV's own 8-bit routine (``imgproc/src/color_*.cpp``):

* BGR → gray and BGR → HSV are integer arithmetic, as in cv2, so they are
  exact;
* BGR → Lab and Lab → BGR are cv2's integer routines with its tables
  (sRGB gamma, the cube root, L → y and a, b → x, z), rebuilt here with
  float32 steps as cv2 builds them;
* HSV → BGR, BGR → HLS and HLS → BGR are float32 arithmetic in the order
  of cv2's vector code, fused multiply-adds included; HSV → BGR truncates
  (OpenCV 5.0), the other two round half to even.

Each is bitwise equal to ``cv2.cvtColor`` (OpenCV 5.0) over all 2^24
8-bit triples.

Images are ``(..., 3)`` tensors of BGR values 0..255 in any integer dtype;
results are int32 tensors of the same shape (hue 0..179 in cv2's 8-bit
range).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _table(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(like.device)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """cv2's ``saturate_cast<uchar>`` of a float: half to even, clamped."""
    return torch.round(x).clamp(0, 255).to(torch.int32)


# ---------------------------------------------------------------- gray
def bgr2gray(x: torch.Tensor) -> torch.Tensor:
    """``COLOR_BGR2GRAY``: 15-bit fixed-point weights, rounded half up."""
    x = _i32(x)
    return (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15


# ---------------------------------------------------------------- HSV
@functools.lru_cache(maxsize=None)
def _hsv_tables() -> tuple[np.ndarray, np.ndarray]:
    """cv2's ``sdiv_table`` and ``hdiv_table180`` (12-bit reciprocals)."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int32)
    hdiv = np.zeros(256, np.int32)
    sdiv[1:] = np.round((255 << 12) / i)
    hdiv[1:] = np.round((180 << 12) / (6.0 * i))
    return sdiv, hdiv


def bgr2hsv(x: torch.Tensor) -> torch.Tensor:
    """``COLOR_BGR2HSV`` on 8-bit values (``RGB2HSV_b``)."""
    x = _i32(x)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    sdiv, hdiv = (_table(t, x) for t in _hsv_tables())
    s = (diff * sdiv[v.long()] + (1 << 11)) >> 12
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff.long()] + (1 << 11)) >> 12
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1)


def _sector_pick(sector: torch.Tensor, tabs: list[torch.Tensor]) -> tuple:
    """B, G, R from cv2's ``sector_data`` table: {1,3,0}, {1,0,2}, {3,0,1},
    {0,2,1}, {0,1,3}, {2,1,0}."""
    order = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
                         device=sector.device)
    stack = torch.stack(tabs, dim=-1)
    idx = order[sector.long()]
    return tuple(torch.gather(stack, -1, idx[..., c:c + 1]).squeeze(-1) for c in range(3))


def hsv2bgr(hsv: torch.Tensor) -> torch.Tensor:
    """``COLOR_HSV2BGR`` on 8-bit values (``HSV2RGB_b``: float32, hue scale
    6 / 180, ``1 - s * h`` fused, truncated to 8 bits)."""
    f = hsv.to(torch.float32)
    h = f[..., 0] * np.float32(6.0 / 180)
    s = f[..., 1] * np.float32(1.0 / 255)
    v = f[..., 2] * np.float32(1.0 / 255)
    pre = torch.trunc(h)
    h = h - pre
    sector = pre - torch.trunc(pre * np.float32(1.0 / 6)) * 6
    one = torch.ones((), dtype=torch.float32, device=f.device)
    tabs = [v, v * (one - s), v * fma32(-s, h, one), v * fma32(-s, one - h, one)]
    bgr = torch.stack(_sector_pick(sector, tabs), dim=-1)
    return torch.trunc(bgr * 255).clamp(0, 255).to(torch.int32)


# ---------------------------------------------------------------- HLS
def bgr2hls(x: torch.Tensor) -> torch.Tensor:
    """``COLOR_BGR2HLS`` on 8-bit values (``RGB2HLS_b``: float32 in [0, 1],
    hue to 0..180)."""
    f = x.to(torch.float32) * np.float32(1.0 / 255)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = vmax - vmin
    total = vmax + vmin
    l = total * 0.5
    s = diff / torch.where(l < 0.5, total, 2 - total)
    hd = torch.where(vmax == r, g - b, torch.where(vmax == g, b - r, r - g))
    base = torch.where(vmax == r, torch.where(g < b, 360.0, 0.0),
                       torch.where(vmax == g, 120.0, 240.0)).to(torch.float32)
    h = fma32(hd, div(60.0, diff), base) * np.float32(0.5)
    keep = diff > np.finfo(np.float32).eps
    h = torch.where(keep, h, 0.0)
    s = torch.where(keep, s, 0.0)
    return torch.stack([_round_u8(h), _round_u8(l * 255), _round_u8(s * 255)], dim=-1)


def hls2bgr(hls: torch.Tensor) -> torch.Tensor:
    """``COLOR_HLS2BGR`` on 8-bit values (``HLS2RGB_b``)."""
    f = hls.to(torch.float32)
    h = f[..., 0] * np.float32(6.0 / 180)
    l = f[..., 1] * np.float32(1.0 / 255)
    s = f[..., 2] * np.float32(1.0 / 255)
    ls = l * s
    p2 = torch.where(l <= 0.5, l + ls, (l + s) - ls)
    p1 = (l + l) - p2
    pre = torch.trunc(h)
    h = h - pre
    sector = pre - torch.trunc(pre * np.float32(1.0 / 6)) * 6
    one = torch.ones((), dtype=torch.float32, device=f.device)
    tabs = [p2, p1, p1 + (p2 - p1) * (one - h), p1 + (p2 - p1) * h]
    bgr = torch.stack(_sector_pick(sector, tabs), dim=-1)
    bgr = torch.where((s == 0)[..., None], l[..., None].expand_as(bgr), bgr)
    return _round_u8(bgr * 255)


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)``, rounded once: ``b`` a tensor or a float32
    value. The operands here are float32 values and small integers, whose
    product and sum are exact in float64."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    return (a.double() * b + c.double()).to(torch.float32)


def div(a, b):
    """``a / b`` correctly rounded. A Python number on one side becomes a
    tensor first: torch computes ``number / tensor`` as a reciprocal times
    the number, and on the card ``tensor / number`` as the tensor times the
    number's reciprocal, which round differently from cv2 and numpy."""
    like = b if isinstance(b, torch.Tensor) else a
    a = a if isinstance(a, torch.Tensor) else torch.full_like(like, a)
    b = b if isinstance(b, torch.Tensor) else torch.full_like(like, b)
    return a / b


# ---------------------------------------------------------------- Lab
_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_INV_GAMMA_TAB = 4096
_BASE = 1 << 14
_MIN_AB = -8145
_D65 = (0.950456, 1.0, 1.088754)
_RGB2XYZ = (0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
            0.019334, 0.119193, 0.950227)
_XYZ2RGB = (3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
            0.055648, -0.204043, 1.057311)


def _gamma(x: float) -> float:
    return x / 12.92 if x <= 0.04045 else ((x + 0.055) / 1.055) ** 2.4


def _inv_gamma(x: float) -> float:
    return x * 12.92 if x <= 0.0031308 else x ** (1 / 2.4) * 1.055 - 0.055


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _lab_tables() -> dict:
    """cv2's 8-bit Lab tables (``initLabTabs``, float32 steps as its
    softfloat ones) and the two routines' integer coefficients for BGR input
    and output."""
    f = _f32
    rnd = lambda v: int(np.round(v))  # noqa: E731  cvRound: half to even
    lthresh, lscale, lbias = f(216 / 24389), f(841 / 108), f(16 / 116)
    gamma_b = np.array([rnd(f(f(255 * 8) * f(_gamma(f(i / 255))))) for i in range(256)], np.int32)
    inv_gamma_b = np.array([rnd(f(255 * f(_inv_gamma(f(i / _INV_GAMMA_TAB)))))
                            for i in range(_INV_GAMMA_TAB)], np.int32)
    cb_scale = f(1 / f(255 * 8))
    cbrt = []
    for i in range(256 * 3 // 2 * (1 << _GAMMA_SHIFT)):
        x = f(cb_scale * i)
        y = f(x * lscale + lbias) if x < lthresh else float(np.cbrt(np.float32(x)))
        cbrt.append(rnd(f((1 << _LAB_SHIFT2) * y)))
    cbrt = np.array(cbrt, np.int32)
    y_tab = np.zeros(256, np.int32)
    ify_tab = np.zeros(256, np.int32)
    for i in range(256):
        if i <= 20:
            y_tab[i] = rnd(f(f(i * _BASE * 20 * 9) / f(17 * 29 * 29 * 29)))
            ify_tab[i] = rnd(f(_BASE * f(f(16 / 116) + f(f(i * 5) / f(3 * 17 * 29)))))
        else:
            fy = f(f(f(i * 100 * _BASE) / f(255 * 116)) + f(f(16 * _BASE) / f(116)))
            ify_tab[i] = rnd(fy)
            y_tab[i] = rnd(f(f(f(fy * fy) * fy) / f(_BASE * _BASE)))
    v = np.arange(_MIN_AB, _BASE * 9 // 4 + _MIN_AB, dtype=np.int64)
    # C's integer division, which truncates toward zero
    lin = np.trunc(v * 108 / 841).astype(np.int64) - (_BASE * 16 // 116 * 108 // 841)
    cube = (v * v // _BASE) * v // _BASE
    ab_to_xz = np.where(v <= 3390, lin, cube).astype(np.int32)
    # BGR → XYZ: row i's blue, green, red weights, scaled by 2^12 over the white point
    fwd = np.zeros(9, np.int64)
    for i in range(3):
        r, g, b = _RGB2XYZ[i * 3:i * 3 + 3]
        fwd[i * 3:i * 3 + 3] = [rnd((1 << _LAB_SHIFT) * c / _D65[i]) for c in (b, g, r)]
    # XYZ → BGR: the blue, green and red rows, times the white point
    inv = np.zeros(9, np.int64)
    for row, out in ((2, 0), (1, 1), (0, 2)):
        inv[out * 3:out * 3 + 3] = [rnd((1 << _LAB_SHIFT) * _XYZ2RGB[row * 3 + i] * _D65[i])
                                    for i in range(3)]
    return {"gamma": gamma_b, "inv_gamma": inv_gamma_b, "cbrt": cbrt, "y": y_tab,
            "ify": ify_tab, "ab_to_xz": ab_to_xz, "fwd": fwd, "inv": inv}


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def bgr2lab(x: torch.Tensor) -> torch.Tensor:
    """``COLOR_BGR2LAB`` on 8-bit values (``RGB2Lab_b``, integer)."""
    t = _lab_tables()
    gamma, cbrt = _table(t["gamma"], x).long(), _table(t["cbrt"], x).long()
    x = x.long()
    c = [int(v) for v in t["fwd"]]
    b, g, r = gamma[x[..., 0]], gamma[x[..., 1]], gamma[x[..., 2]]
    fx = cbrt[_descale(b * c[0] + g * c[1] + r * c[2], _LAB_SHIFT)]
    fy = cbrt[_descale(b * c[3] + g * c[4] + r * c[5], _LAB_SHIFT)]
    fz = cbrt[_descale(b * c[6] + g * c[7] + r * c[8], _LAB_SHIFT)]
    lscale = (116 * 255 + 50) // 100
    lshift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = _descale(lscale * fy + lshift, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([L, a, bb], dim=-1).clamp(0, 255).to(torch.int32)


def lab2bgr(lab: torch.Tensor) -> torch.Tensor:
    """``COLOR_LAB2BGR`` on 8-bit values (``Lab2RGBinteger``)."""
    t = _lab_tables()
    lab = lab.long()
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = _table(t["y"], lab).long()[L]
    ify = _table(t["ify"], lab).long()[L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    ab_to_xz = _table(t["ab_to_xz"], lab).long()
    xx = ab_to_xz[ify + adiv - _MIN_AB]
    zz = ab_to_xz[ify - bdiv - _MIN_AB]
    c = [int(v) for v in t["inv"]]
    shift = _LAB_SHIFT + (14 - 12)
    inv_gamma = _table(t["inv_gamma"], lab).long()
    outs = []
    for i in range(3):
        o = _descale(c[i * 3] * xx + c[i * 3 + 1] * y + c[i * 3 + 2] * zz, shift)
        outs.append(inv_gamma[o.clamp(0, _INV_GAMMA_TAB - 1)])
    return torch.stack(outs, dim=-1).to(torch.int32)
