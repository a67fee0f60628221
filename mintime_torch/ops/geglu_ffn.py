"""Fused GEGLU feed-forward (counterpart of ``mintime_tpu/ops/pallas_ffn.py``,
the forward of ``geglu_ffn`` at ``:229-247`` and ``_fwd_kernel`` at ``:57-74``).

``out = (val * gelu_erf(gate)) @ w1.T + b1`` with ``[val | gate] = x @ w0.T
+ b0``. Weights are in PyTorch's Linear layout: ``w0 (2H, D)``, ``w1 (D, H)``.

:func:`geglu_ffn` runs the CUDA kernel ``csrc/geglu_ffn.cu`` for a CUDA
tensor and :func:`geglu_ffn_plain` for a CPU tensor. The plain version
repeats the kernel's arithmetic: fp32 accumulation, the up-projection rounded
to the input dtype before the gate math, gate math in fp32, the product
rounded again before the down-projection.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mintime_torch.ops import _build

#: kernel launches since the last reset (one per :func:`geglu_ffn` call on the card)
launches = 0

_KERNEL_DIM = 512
_KERNEL_CHUNK = 64
_KERNEL_ROWS = 32  # rows per block


def reset_launches() -> None:
    global launches
    launches = 0


def geglu_ffn_plain(x, w0, b0, w1, b1):
    """Plain PyTorch version of the fused FFN (any device, any float dtype)."""
    f32 = torch.float32
    h = (x.to(f32) @ w0.to(f32).T + b0.to(f32)).to(x.dtype)
    val, gate = h.to(f32).chunk(2, dim=-1)
    prod = (val * F.gelu(gate)).to(x.dtype)
    return (prod.to(f32) @ w1.to(f32).T + b1.to(f32)).to(x.dtype)


def split_count(m: int, hidden: int, sms: int) -> int:
    """How many blocks share the hidden width of one row tile: 1 while the
    row tiles alone give every SM a block, else enough to give each SM about
    two, at most one per hidden chunk."""
    tiles = -(-m // _KERNEL_ROWS)
    if tiles >= sms:
        return 1
    return min(hidden // _KERNEL_CHUNK, -(-2 * sms // tiles))


def _check_kernel_args(x2, w0, b0, w1, b1):
    dim = x2.shape[-1]
    hidden = w1.shape[1]
    for name, t in (("x", x2), ("w0", w0), ("b0", b0), ("w1", w1), ("b1", b1)):
        if not t.is_cuda:
            raise ValueError(f"geglu_ffn: {name} is not on the card with x")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"geglu_ffn kernel takes bf16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"geglu_ffn kernel needs a contiguous {name}")
        if t.data_ptr() % 32:
            raise ValueError(f"geglu_ffn kernel needs {name} aligned to 32 bytes")
    if dim != _KERNEL_DIM:
        raise ValueError(f"geglu_ffn kernel is built for width {_KERNEL_DIM}, got {dim}")
    if hidden % _KERNEL_CHUNK:
        raise ValueError(f"geglu_ffn kernel needs hidden % {_KERNEL_CHUNK} == 0, got {hidden}")
    if w0.shape != (2 * hidden, dim) or b0.shape != (2 * hidden,) or w1.shape != (dim, hidden) \
            or b1.shape != (dim,):
        raise ValueError(
            f"geglu_ffn: inconsistent shapes w0 {tuple(w0.shape)} b0 {tuple(b0.shape)}"
            f" w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} for width {dim}"
        )


def geglu_ffn_cuda(x, w0, b0, w1, b1):
    """Launch the CUDA kernel on ``x (..., 512)`` bf16; returns a new tensor."""
    global launches
    x2 = x.reshape(-1, x.shape[-1])
    _check_kernel_args(x2, w0, b0, w1, b1)
    out = torch.empty_like(x2)
    m = x2.shape[0]
    if m == 0:
        return out.reshape(x.shape)
    hidden = w1.shape[1]
    splits = split_count(m, hidden, torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = (torch.empty((splits, m, x2.shape[1]), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _build.load("geglu_ffn")
    fn = lib.geglu_ffn_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(x2.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    out.data_ptr(), None if partial is None else partial.data_ptr(), m,
                    x2.shape[1], hidden, splits, stream)
    _build.check(status, "geglu_ffn")
    launches += 1
    return out.reshape(x.shape)


def geglu_ffn(x, w0, b0, w1, b1):
    """Fused GEGLU FFN over the last axis of ``x`` (any leading shape).

    A CPU tensor takes :func:`geglu_ffn_plain`; a CUDA tensor takes the
    kernel or raises. There is no fallback between the two.
    """
    if x.is_cuda:
        return geglu_ffn_cuda(x, w0, b0, w1, b1)
    return geglu_ffn_plain(x, w0, b0, w1, b1)
