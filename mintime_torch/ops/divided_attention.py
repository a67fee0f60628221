"""Divided attention with a CLS row from packed qkv (counterpart of
``mintime_tpu/ops/pallas_attention.py``: ``_divided_kernel`` at ``:140-238``,
``divided_attention`` at ``:773-822`` and ``mask_to_bias`` at ``:115-117``).

The packed columns are ``[q | k | v]``-major with heads inside each third,
which is PyTorch's ``to_qkv`` layout; the JAX package packs head-major
``(H, [q|k|v], dh)`` instead, and the weight converter permutes once at load
time (:mod:`mintime_torch.convert`).

:func:`divided_attention` runs the CUDA kernel ``csrc/divided_attention.cu``
for a CUDA tensor and :func:`divided_attention_plain` for a CPU tensor. The
plain version repeats the kernel's arithmetic: q scaled in the input dtype,
fp32 logits, biases added in fp32, token-row probabilities rounded to the
input dtype before PV, the CLS row's unnormalised probabilities rounded
before PV and its sum divided out at the end.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mintime_torch.ops import _build

#: finite additive mask value (``pallas_attention.py:32``)
NEG = -0.7 * float(np.finfo(np.float32).max)

#: kernel launches since the last reset (one per :func:`divided_attention` call on the card)
launches = 0

_KERNEL_DH = 64
_KERNEL_MAX_L = 64
_KERNEL_MAX_KEYS = 12 * 1024  # G*L fp32 CLS-row logits in 48 KB of shared memory


def reset_launches() -> None:
    global launches
    launches = 0


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """bool mask → additive fp32 bias (0 where True, ``NEG`` where False)."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full((), NEG, dtype=torch.float32, device=mask.device))


def _split(qkv, heads, dim_head):
    """(..., 3*H*dh) → q, k, v each (..., H, dh)."""
    t = qkv.unflatten(-1, (3, heads, dim_head))
    return t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]


def divided_attention_plain(qkv_g, qkv_cls, seq_bias, row_bias, *, heads: int, dim_head: int):
    """Plain PyTorch version of the divided-attention kernel.

    Args:
      qkv_g: (B, G, L, 3*H*dh) packed ``[q|k|v]`` token projections (any
        strides).
      qkv_cls: (B, 1, 3*H*dh) CLS projections.
      seq_bias: (B, L, 1+L) fp32 additive mask of the token rows (column 0 =
        CLS key) or None.
      row_bias: fp32 CLS-row bias broadcastable to (B, G, L) — (B, 1, L) on
        the time axis, (B, G, 1) on the space axis — or None.
    Returns (out (B, G, L, H*dh), out_cls (B, 1, H*dh)) in qkv's dtype.
    """
    f32 = torch.float32
    B, G, L, _ = qkv_g.shape
    dt = qkv_g.dtype
    scale = dim_head ** -0.5
    q, k, v = _split(qkv_g, heads, dim_head)  # (B, G, L, H, dh)
    qc, kc, vc = _split(qkv_cls[:, 0], heads, dim_head)  # (B, H, dh)
    q = (q * scale).to(f32)
    qc = (qc * scale).to(f32)
    k, v, kc, vc = k.to(f32), v.to(f32), kc.to(f32), vc.to(f32)

    # token rows: softmax over [CLS key | L keys] within each group
    logits = torch.cat(
        [torch.einsum("bglhd,bhd->bhgl", q, kc)[..., None],
         torch.einsum("bglhd,bgmhd->bhglm", q, k)],
        dim=-1,
    )  # (B, H, G, L, 1+L)
    if seq_bias is not None:
        logits = logits + seq_bias.to(f32)[:, None, None]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    attn = (p / p.sum(dim=-1, keepdim=True)).to(dt).to(f32)
    out = torch.einsum("bhglm,bgmhd->bglhd", attn[..., 1:], v)
    out = out + attn[..., 0].permute(0, 2, 3, 1)[..., None] * vc[:, None, None]
    out = out.reshape(B, G, L, heads * dim_head).to(dt)

    # CLS row: one query over all G*L keys and itself
    lr = torch.einsum("bhd,bglhd->bhgl", qc, k)
    if row_bias is not None:
        lr = lr + row_bias.to(f32)[:, None]
    ls = (qc * kc).sum(dim=-1)  # (B, H)
    mx = torch.maximum(lr.amax(dim=(2, 3)), ls)
    pr = torch.exp(lr - mx[:, :, None, None])
    ps = torch.exp(ls - mx)
    z = pr.sum(dim=(2, 3)) + ps
    acc = torch.einsum("bhgl,bglhd->bhd", pr.to(dt).to(f32), v)
    out_cls = ((acc + ps[..., None] * vc) / z[..., None]).reshape(B, 1, heads * dim_head)
    return out, out_cls.to(dt)


def _check_kernel_args(qkv_g, qkv_cls, seq_bias, row_bias, heads, dim_head):
    B, G, L, c3 = qkv_g.shape
    inner = heads * dim_head
    if dim_head != _KERNEL_DH:
        raise ValueError(f"divided_attention kernel is built for dim_head {_KERNEL_DH}, got {dim_head}")
    if c3 != 3 * inner or qkv_cls.shape != (B, 1, c3):
        raise ValueError(f"divided_attention: qkv {tuple(qkv_g.shape)} / qkv_cls"
                         f" {tuple(qkv_cls.shape)} do not match heads {heads} x {dim_head}")
    if not 1 <= L <= _KERNEL_MAX_L:
        raise ValueError(f"divided_attention kernel takes 1 <= L <= {_KERNEL_MAX_L}, got {L}")
    if G * L > _KERNEL_MAX_KEYS:
        raise ValueError(f"divided_attention kernel takes G*L <= {_KERNEL_MAX_KEYS}, got {G * L}")
    for name, t in (("qkv", qkv_g), ("qkv_cls", qkv_cls)):
        if not t.is_cuda or t.device != qkv_g.device:
            raise ValueError(f"divided_attention: {name} is not on the card with qkv")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"divided_attention kernel takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"divided_attention kernel needs unit stride on {name}'s last axis")
    if seq_bias is not None:
        if seq_bias.shape != (B, L, 1 + L) or seq_bias.dtype != torch.float32 \
                or not seq_bias.is_contiguous() or seq_bias.device != qkv_g.device:
            raise ValueError("divided_attention kernel needs seq_bias as contiguous fp32"
                             f" (B, L, 1+L) = {(B, L, 1 + L)} on the card")
    if row_bias is not None:
        if row_bias.dtype != torch.float32 or row_bias.device != qkv_g.device \
                or row_bias.dim() != 3:
            raise ValueError("divided_attention kernel needs row_bias as 3-D fp32 on the card")


def divided_attention_cuda(qkv_g, qkv_cls, seq_bias, row_bias, *, heads: int, dim_head: int):
    """Launch the CUDA kernel. ``qkv_g`` may be any strided view whose last
    axis is contiguous (the time axis passes the (B, n, F, ·) transpose of
    the natural layout); the token output gets the same stride order, so
    transposing it back is free."""
    global launches
    _check_kernel_args(qkv_g, qkv_cls, seq_bias, row_bias, heads, dim_head)
    B, G, L, _ = qkv_g.shape
    inner = heads * dim_head
    dev = qkv_g.device
    if qkv_g.stride(1) < qkv_g.stride(2):  # transposed view of (B, L, G, ·)
        out = torch.empty((B, L, G, inner), dtype=qkv_g.dtype, device=dev).transpose(1, 2)
    else:
        out = torch.empty((B, G, L, inner), dtype=qkv_g.dtype, device=dev)
    out_cls = torch.empty((B, 1, inner), dtype=qkv_g.dtype, device=dev)
    if row_bias is not None:
        row_bias = row_bias.expand(B, G, L)
        rb_ptr, rb_strides = row_bias.data_ptr(), row_bias.stride()
    else:
        rb_ptr, rb_strides = None, (0, 0, 0)
    lib = _build.load("divided_attention")
    fn = lib.divided_attention_fwd
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [ptr, i64, i64, i64, ptr, i64, ptr, ptr, i64, i64, i64,
                   ptr, i64, i64, i64, ptr, i64] + [ctypes.c_int] * 5 + [ptr]
    fn.restype = ctypes.c_int
    sb, sg, sl, _ = qkv_g.stride()
    ob, og, ol, _ = out.stride()
    with torch.cuda.device(dev):
        status = fn(
            qkv_g.data_ptr(), sb, sg, sl, qkv_cls.data_ptr(), qkv_cls.stride(0),
            None if seq_bias is None else seq_bias.data_ptr(), rb_ptr, *rb_strides,
            out.data_ptr(), ob, og, ol, out_cls.data_ptr(), out_cls.stride(0),
            B, G, L, heads, dim_head, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "divided_attention")
    launches += 1
    return out, out_cls


def divided_attention(qkv_g, qkv_cls, seq_bias, row_bias, *, heads: int, dim_head: int):
    """Grouped attention with a CLS row from packed ``[q|k|v]`` qkv.

    Same arguments and results as :func:`divided_attention_plain`. A CPU
    tensor takes the plain version; a CUDA tensor takes the kernel or
    raises. There is no fallback between the two.
    """
    if qkv_g.is_cuda:
        return divided_attention_cuda(qkv_g, qkv_cls, seq_bias, row_bias,
                                      heads=heads, dim_head=dim_head)
    return divided_attention_plain(qkv_g, qkv_cls, seq_bias, row_bias,
                                   heads=heads, dim_head=dim_head)
