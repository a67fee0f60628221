"""A JPEG encode and decode round trip in integer torch, on any device: what
``cv2.imdecode(cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q]))``
gives with libjpeg-turbo's defaults, computed without the codec.

The entropy coding is lossless, so the pixels come from the integer steps
around it, each as libjpeg-turbo computes it:

1. RGB → YCbCr with 16-bit fixed-point tables (``jccolor.c``);
2. 4:2:0 chroma: 2 x 2 averages with the alternating bias 1, 2
   (``jcsample.c`` ``h2v2_downsample``), the planes first widened by their
   edge pixels to whole blocks;
3. the "islow" forward DCT (``jfdctint.c``, 13-bit constants, two passes);
4. quantisation by the IJG tables scaled to the quality
   (``jcparam.c``), through libjpeg-turbo's reciprocals (``jcdctmgr.c``);
5. the "islow" inverse DCT (``jidctint.c``) and its range limit;
6. "fancy" triangle upsampling of the chroma (``jdsample.c``
   ``h2v2_fancy_upsample``);
7. YCbCr → RGB with the decoder's fixed-point tables (``jdcolor.c``).

Images are ``(..., H, W, 3)`` BGR uint8 tensors; the leading dims are
frames, each coded on its own.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_CONST_BITS, _PASS1_BITS = 13, 2
# jfdctint.c / jidctint.c: FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality``'s table for ``quality`` (baseline: 1..255)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


@functools.lru_cache(maxsize=None)
def _divisors(quality: int, chroma: bool) -> tuple:
    """libjpeg-turbo's ``compute_reciprocal`` for each coefficient's divisor
    (the table value times 8, the forward DCT's scale): reciprocal,
    correction and shift, so that ``q = ((|x| + c) * r) >> s``."""
    q = quant_table(_CHROMA if chroma else _LUMA, quality)
    recip, corr, shift = [], [], []
    for divisor in (q * 8).tolist():
        b = divisor.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, divisor)
        c = divisor // 2
        if fr == 0:  # a power of two
            fq >>= 1
            r -= 1
        elif fr <= divisor // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip), np.array(corr), np.array(shift), q


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """``(..., 8*by, 8*bx)`` → ``(..., by, bx, 8, 8)``."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)


def _unblocks(blocks: torch.Tensor) -> torch.Tensor:
    *lead, by, bx, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, by * 8, bx * 8)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: list, final: bool) -> list:
    """One pass of ``jpeg_fdct_islow`` over the 8 inputs ``d``."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if final:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
        n = _CONST_BITS + _PASS1_BITS
    else:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
        n = _CONST_BITS - _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, n)
    out[6] = _descale(z1 - tmp12 * _F1847, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def _idct_1d(d: list, n: int) -> list:
    """One pass of ``jpeg_idct_islow`` (dequantised inputs ``d``) with the
    final descale by ``n`` bits."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [_descale(tmp10 + t3, n), _descale(tmp11 + t2, n), _descale(tmp12 + t1, n),
            _descale(tmp13 + t0, n), _descale(tmp13 - t0, n), _descale(tmp12 - t1, n),
            _descale(tmp11 - t2, n), _descale(tmp10 - t3, n)]


def _rows_apply(blocks: torch.Tensor, fn, axis: int) -> torch.Tensor:
    """Apply a 1-D pass along ``axis`` (-1 rows, -2 columns) of 8 x 8 blocks."""
    parts = list(blocks.unbind(axis))
    return torch.stack(fn(parts), dim=axis)


def fdct_quantize(blocks: torch.Tensor, quality: int, chroma: bool) -> torch.Tensor:
    """Level-shifted int64 samples ``(..., 8, 8)`` → quantised coefficients."""
    x = blocks - 128
    x = _rows_apply(x, lambda d: _fdct_1d(d, False), -1)
    x = _rows_apply(x, lambda d: _fdct_1d(d, True), -2)
    recip, corr, shift, _ = (torch.from_numpy(t).to(blocks.device).reshape(8, 8)
                             for t in _divisors(quality, chroma))
    q = ((x.abs() + corr) * recip) >> shift
    return torch.where(x < 0, -q, q)


def dequantize_idct(coef: torch.Tensor, quality: int, chroma: bool) -> torch.Tensor:
    """Quantised coefficients ``(..., 8, 8)`` → int64 samples 0..255."""
    q = torch.from_numpy(_divisors(quality, chroma)[3]).to(coef.device).reshape(8, 8)
    x = coef * q
    x = _rows_apply(x, lambda d: _idct_1d(d, _CONST_BITS - _PASS1_BITS), -2)
    x = _rows_apply(x, lambda d: _idct_1d(d, _CONST_BITS + _PASS1_BITS + 3), -1)
    # the post-IDCT range limit: x + 128, clamped, on the low 10 bits
    idx = x & 1023
    return torch.where(idx < 128, idx + 128,
                       torch.where(idx < 512, 255, torch.where(idx < 896, 0, idx - 896)))


def _pad_to(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Widen ``(..., ph, pw)`` to ``(..., h, w)`` by repeating the last row
    and column."""
    ph, pw = plane.shape[-2:]
    rows = torch.arange(h, device=plane.device).clamp(max=ph - 1)
    cols = torch.arange(w, device=plane.device).clamp(max=pw - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def _upsample_h2v2(c: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    """``h2v2_fancy_upsample`` of ``(..., ch, cw)`` chroma (its real size;
    edges repeated) → ``(..., 2ch, 2cw)``."""
    dev = c.device
    up = torch.arange(ch, device=dev) - 1
    down = torch.arange(ch, device=dev) + 1
    near3 = c * 3
    above = near3 + c.index_select(-2, up.clamp(min=0))       # output rows 2i
    below = near3 + c.index_select(-2, down.clamp(max=ch - 1))  # output rows 2i + 1
    rows = torch.stack([above, below], dim=-2).reshape(*c.shape[:-2], 2 * ch, cw)
    left = rows.index_select(-1, (torch.arange(cw, device=dev) - 1).clamp(min=0))
    right = rows.index_select(-1, (torch.arange(cw, device=dev) + 1).clamp(max=cw - 1))
    even = (rows * 3 + left + 8) >> 4
    odd = (rows * 3 + right + 7) >> 4
    return torch.stack([even, odd], dim=-1).reshape(*rows.shape[:-1], 2 * cw)


def jpeg_roundtrip(img: torch.Tensor, quality: int) -> torch.Tensor:
    """``(..., H, W, 3)`` BGR uint8 → the same after a JPEG round trip at
    ``quality`` (4:2:0, islow DCTs, fancy upsampling)."""
    h, w = img.shape[-3:-1]
    x = img.long()
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    # 1. RGB → YCbCr (jccolor.c; the rounding constants folded into the tables)
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + _ONE_HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + (128 << _SCALEBITS) + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + (128 << _SCALEBITS) + _ONE_HALF - 1) >> _SCALEBITS
    # blocks: luma in 8 x 8, chroma at half size in 8 x 8 (16 x 16 MCUs)
    lh, lw = -(-h // 8) * 8, -(-w // 8) * 8
    ch_real, cw_real = -(-h // 2), -(-w // 2)
    ch, cw = -(-h // 16) * 8, -(-w // 16) * 8
    luma = dequantize_idct(fdct_quantize(_blocks(_pad_to(y, lh, lw)), quality, False),
                           quality, False)
    luma = _unblocks(luma)[..., :h, :w]
    # 2. 2 x 2 chroma averages, bias 1, 2, 1, 2, ... along a row
    bias = (torch.arange(cw, device=img.device) % 2) + 1
    chroma = []
    for plane in (cb, cr):
        full = _pad_to(plane, 2 * ch_real, 2 * cw)
        s = full[..., 0::2, 0::2] + full[..., 0::2, 1::2] + full[..., 1::2, 0::2] \
            + full[..., 1::2, 1::2]
        sub = _pad_to((s + bias) >> 2, ch, cw)
        rec = _unblocks(dequantize_idct(fdct_quantize(_blocks(sub), quality, True),
                                        quality, True))
        chroma.append(_upsample_h2v2(rec[..., :ch_real, :cw_real], ch_real, cw_real)[..., :h, :w])
    cb, cr = chroma[0] - 128, chroma[1] - 128
    # 7. YCbCr → RGB (jdcolor.c)
    red = luma + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    green = luma + ((-_fix(0.34414) * cb + _ONE_HALF - _fix(0.71414) * cr) >> _SCALEBITS)
    blue = luma + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    return torch.stack([blue, green, red], dim=-1).clamp(0, 255).to(torch.uint8)
