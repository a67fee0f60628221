"""Divided attention with a CLS row from packed qkv (counterpart of
``mintime_tpu/ops/pallas_attention.py``: ``_divided_kernel`` at ``:140-238``,
``_divided_bwd_kernel`` at ``:289-452``, the ``custom_vjp`` at ``:488-511``,
``divided_attention`` at ``:773-822`` and ``mask_to_bias`` at ``:115-117``).

:func:`divided_attention` picks its path by the slice's bytes, as the JAX
package does (``pallas_attention.py:816-822``): a slice whose packed qkv is
at most :data:`WHOLE_SLICE_BYTES` goes to the whole-slice kernels here; a
larger one (the Convolutional TimeSformer's time axis) goes to the token-row
kernels and the plain CLS row of :mod:`mintime_torch.ops.token_rows`. The
choice uses the dtype's size, so an fp32 CPU run and a bf16 card run can pick
differently at the same shape, as in JAX.

The packed columns are ``[q | k | v]``-major with heads inside each third,
which is PyTorch's ``to_qkv`` layout; the JAX package packs head-major
``(H, [q|k|v], dh)`` instead, and the weight converter permutes once at load
time (:mod:`mintime_torch.convert`).

:func:`divided_attention` is differentiable through
:class:`DividedAttentionFunction`. For CUDA tensors its forward runs the
kernel ``csrc/divided_attention.cu`` and its backward
``csrc/divided_attention_bwd.cu``; for CPU tensors they run
:func:`divided_attention_plain` and :func:`divided_attention_bwd_plain`. The
plain versions repeat the kernels' arithmetic: q scaled in the input dtype,
fp32 logits, biases added in fp32, token-row probabilities rounded to the
input dtype before PV, the CLS row's unnormalised probabilities rounded
before PV and its sum divided out at the end; the backward recomputes both
softmaxes in fp32 and rounds only its results.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from mintime_torch.ops import _build
from mintime_torch.ops.token_rows import (_aligned16, _empty_grouped, _token_rows_grads,
                                          _token_rows_out, _upcast, cls_row_plain, rows_plan,
                                          token_rows_attention)

#: finite additive mask value (``pallas_attention.py:32``)
NEG = -0.7 * float(np.finfo(np.float32).max)

#: forward kernel launches since the last reset (one per :func:`divided_attention_cuda` call)
launches = 0
#: backward kernel launches since the last reset (one per
#: :func:`divided_attention_bwd_cuda` call)
bwd_launches = 0

_KERNEL_DH = 64
#: longest attended axis of the whole-slice kernels; ``DividedAttention``
#: sends every axis up to this length to :func:`divided_attention`
#: (``mintime_tpu/models/timesformer.py:152``)
_KERNEL_MAX_L = 256
#: most keys of the CLS row (G*L) the kernels take
_KERNEL_MAX_KEYS = 12 * 1024
#: keys of a chunk of the CLS row, forward and backward (one block of each
#: CLS launch)
_CLS_CHUNK_KEYS = 128

#: largest packed qkv slice (G*L*3*inner bytes) of the whole-slice kernels
#: (``pallas_attention.py:770``); larger slices take the token rows
WHOLE_SLICE_BYTES = 6 * 1024 * 1024


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """bool mask → additive fp32 bias (0 where True, ``NEG`` where False)."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full((), NEG, dtype=torch.float32, device=mask.device))


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
    dt = qkv_g.dtype
    q, k, v, qc, kc, vc = _upcast(qkv_g, qkv_cls, heads, dim_head)  # fp32, q and qc scaled
    out = _token_rows_out(q, k, v, kc, vc, seq_bias, dt)
    return out, _cls_row_out(qc, kc, vc, k, v, row_bias, dt)


def _cls_row_out(qc, kc, vc, k, v, row_bias, dt):
    """The CLS row, one query over itself and all G*L keys, from the fp32
    operands of :func:`~mintime_torch.ops.token_rows._upcast` (``qc``
    scaled): unnormalised probabilities rounded to ``dt`` before PV and the
    sum divided out at the end. ``row_bias``: fp32, broadcastable to (B, G,
    L), or None. Returns (B, 1, H*dh) in ``dt``."""
    f32 = torch.float32
    B, H, dh = qc.shape
    lr = torch.einsum("bhd,bglhd->bhgl", qc, k)
    if row_bias is not None:
        lr = lr + row_bias.to(f32)[:, None]
    ls = (qc * kc).sum(dim=-1)  # (B, H)
    mx = torch.maximum(lr.amax(dim=(2, 3)), ls)
    pr = torch.exp(lr - mx[:, :, None, None])
    ps = torch.exp(ls - mx)
    z = pr.sum(dim=(2, 3)) + ps
    acc = torch.einsum("bhgl,bglhd->bhd", pr.to(dt).to(f32), v)
    return ((acc + ps[..., None] * vc) / z[..., None]).reshape(B, 1, H * dh).to(dt)


def divided_attention_bwd_plain(qkv_g, qkv_cls, seq_bias, row_bias, d_tok, d_cls, *,
                                heads: int, dim_head: int):
    """Plain PyTorch version of the backward kernel.

    ``d_tok (B, G, L, H*dh)`` and ``d_cls (B, 1, H*dh)`` are the cotangents
    of :func:`divided_attention_plain`'s outputs. Returns ``(d_qkv, d_qkvc)``
    in qkv's dtype, ``d_qkv`` in the stride order of ``qkv_g``.
    """
    f32 = torch.float32
    B, G, L, _ = qkv_g.shape
    dt = qkv_g.dtype
    scale = dim_head ** -0.5
    q, k, v, qc, kc, vc = _upcast(qkv_g, qkv_cls, heads, dim_head)  # fp32, q and qc scaled
    do = d_tok.to(dt).to(f32).unflatten(-1, (heads, dim_head))
    dc = d_cls[:, 0].to(dt).to(f32).unflatten(-1, (heads, dim_head))
    dq, dk, dv, dkc, dvc = _token_rows_grads(q, k, v, kc, vc, do, seq_bias)

    # CLS row: recompute the softmax over itself and all G*L keys
    lr = torch.einsum("bhd,bglhd->bhgl", qc, k)
    if row_bias is not None:
        lr = lr + row_bias.to(f32)[:, None]
    ls = (qc * kc).sum(dim=-1)  # (B, H)
    mc = torch.maximum(lr.amax(dim=(2, 3)), ls)
    pru = torch.exp(lr - mc[:, :, None, None])
    psu = torch.exp(ls - mc)
    z = pru.sum(dim=(2, 3)) + psu
    pr, ps = pru / z[:, :, None, None], psu / z
    dpr = torch.einsum("bhd,bglhd->bhgl", dc, v)
    dps = (vc * dc).sum(dim=-1)
    s_dot = (pr * dpr).sum(dim=(2, 3)) + ps * dps
    dlr = pr * (dpr - s_dot[:, :, None, None])
    dls = ps * (dps - s_dot)
    dqc = scale * (torch.einsum("bhgl,bglhd->bhd", dlr, k) + dls[..., None] * kc)
    dk = dk + torch.einsum("bhgl,bhd->bglhd", dlr, qc)
    dkc = dkc + dls[..., None] * qc
    dv = dv + torch.einsum("bhgl,bhd->bglhd", pr, dc)
    dvc = dvc + ps[..., None] * dc

    d_qkv = _empty_grouped(qkv_g, 3 * heads * dim_head)
    d_qkv.copy_(torch.stack([scale * dq, dk, dv], dim=3).reshape(B, G, L, -1))
    d_qkvc = torch.stack([dqc, dkc, dvc], dim=1).reshape(B, 1, -1).to(dt)
    return d_qkv, d_qkvc


def takes_whole_slice(G: int, L: int, c3: int, element_size: int) -> bool:
    """Whether :func:`divided_attention` sends a (·, G, L, c3) slice of this
    element size to the whole-slice kernels (``pallas_attention.py:816``)."""
    return G * L * c3 * element_size <= WHOLE_SLICE_BYTES


def check_kernel_shape(G: int, L: int, dim_head: int) -> None:
    """Raise ``ValueError`` unless the whole-slice kernels take G groups of L
    positions with heads of ``dim_head``."""
    if dim_head != _KERNEL_DH:
        raise ValueError(f"divided_attention kernel is built for dim_head {_KERNEL_DH}, got {dim_head}")
    if not 1 <= L <= _KERNEL_MAX_L:
        raise ValueError(f"divided_attention kernel takes 1 <= L <= {_KERNEL_MAX_L}, got {L}")
    if G * L > _KERNEL_MAX_KEYS:
        raise ValueError(f"divided_attention kernel takes G*L <= {_KERNEL_MAX_KEYS}, got {G * L}")


def cls_row_chunks(G: int, L: int) -> int:
    """Chunks of the CLS row over G groups of L keys, forward and backward:
    one block of each of its launches a chunk."""
    return -(-G * L // _CLS_CHUNK_KEYS)


def bwd_plan(B: int, G: int, L: int, dim_head: int = _KERNEL_DH) -> dict:
    """Launch shape of the backward kernel (``csrc/divided_attention_bwd.cu``)
    for B videos of G groups of L positions.

    The token-row launches (rows, then columns) are
    :func:`~mintime_torch.ops.token_rows.rows_plan`'s: a warp takes 16 rows
    (or keys) of one group, a block a 64-row chunk of one group or several
    whole groups numbered ``n = b * G + g`` across videos. Returns its
    ``groups_per_block``, ``row_chunks`` (chunks of a group), ``threads``
    and ``blocks`` (of each token-row launch, per head), ``cls_chunks``
    (chunks of the CLS row's G*L keys) and the fp32 scratch per (b, h):
    ``cls_scratch`` (each key's logit and d_cls . v, each
    chunk's partial sums, the row's stats and its own dk_cls, dv_cls terms),
    ``kv_part`` (each group chunk's dk_cls, dv_cls part) and ``row_stats``
    (each token row's max, sum and s_dot)."""
    rows = rows_plan(B, G, L)
    chunks = rows["row_chunks"]
    cls_chunks = cls_row_chunks(G, L)
    return {**rows, "cls_chunks": cls_chunks,
            "cls_scratch": 2 * G * L + cls_chunks * (2 * dim_head + 3) + 3 + 2 * dim_head,
            "kv_part": G * chunks * 2 * dim_head, "row_stats": G * L * 3}


def _bwd_scratch(plan: dict, B: int, G: int, L: int, heads: int, dim_head: int, device):
    """The backward's fp32 scratch under ``plan``: (cls_scratch, kv_part,
    row_stats), each written before it is read."""
    f32 = torch.float32
    return (torch.empty((B, heads, plan["cls_scratch"]), dtype=f32, device=device),
            torch.empty((B, G * plan["row_chunks"], heads, 2, dim_head), dtype=f32, device=device),
            torch.empty((B, G, heads, L, 3), dtype=f32, device=device))


def _check_kernel_args(qkv_g, qkv_cls, seq_bias, row_bias, heads, dim_head):
    B, G, L, c3 = qkv_g.shape
    inner = heads * dim_head
    check_kernel_shape(G, L, dim_head)
    if c3 != 3 * inner or qkv_cls.shape != (B, 1, c3):
        raise ValueError(f"divided_attention: qkv {tuple(qkv_g.shape)} / qkv_cls"
                         f" {tuple(qkv_cls.shape)} do not match heads {heads} x {dim_head}")
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
    cls_chunks = cls_row_chunks(G, L)
    # the launches read rows by 16-byte loads
    qkv_g, qkv_cls = _aligned16(qkv_g), _aligned16(qkv_cls)
    out = _empty_grouped(qkv_g, inner)
    out_cls = torch.empty((B, 1, inner), dtype=qkv_g.dtype, device=dev)
    cls_scratch = torch.empty((B, heads, G * L + cls_chunks * (dim_head + 2)),
                              dtype=torch.float32, device=dev)
    if row_bias is not None:
        row_bias = row_bias.expand(B, G, L)
        rb_ptr, rb_strides = row_bias.data_ptr(), row_bias.stride()
    else:
        rb_ptr, rb_strides = None, (0, 0, 0)
    lib = _build.load("divided_attention")
    fn = lib.divided_attention_fwd
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [ptr, i64, i64, i64, ptr, i64, ptr, ptr, i64, i64, i64,
                   ptr, i64, i64, i64, ptr, i64, ptr] + [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    sb, sg, sl, _ = qkv_g.stride()
    ob, og, ol, _ = out.stride()
    with torch.cuda.device(dev):
        status = fn(
            qkv_g.data_ptr(), sb, sg, sl, qkv_cls.data_ptr(), qkv_cls.stride(0),
            None if seq_bias is None else seq_bias.data_ptr(), rb_ptr, *rb_strides,
            out.data_ptr(), ob, og, ol, out_cls.data_ptr(), out_cls.stride(0),
            cls_scratch.data_ptr(), cls_chunks,
            B, G, L, heads, dim_head, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "divided_attention")
    launches += 1
    return out, out_cls


def divided_attention_bwd_cuda(qkv_g, qkv_cls, seq_bias, row_bias, d_tok, d_cls, *,
                               heads: int, dim_head: int):
    """Launch the backward kernel; same results as
    :func:`divided_attention_bwd_plain`. ``d_tok`` may be any strided view
    whose last axis is contiguous; ``d_qkv`` gets the stride order of
    ``qkv_g``."""
    global bwd_launches
    _check_kernel_args(qkv_g, qkv_cls, seq_bias, row_bias, heads, dim_head)
    B, G, L, c3 = qkv_g.shape
    inner = heads * dim_head
    dev = qkv_g.device
    d_tok = d_tok.to(qkv_g.dtype)
    d_cls = d_cls.to(qkv_g.dtype)
    if d_tok.stride(-1) != 1:
        d_tok = d_tok.contiguous()
    if d_cls.stride(-1) != 1:
        d_cls = d_cls.contiguous()
    if d_tok.shape != (B, G, L, inner) or d_cls.shape != (B, 1, inner) \
            or d_tok.device != dev or d_cls.device != dev:
        raise ValueError(f"divided_attention: cotangents {tuple(d_tok.shape)} /"
                         f" {tuple(d_cls.shape)} do not match qkv {tuple(qkv_g.shape)}")
    # the launches stage rows by 16-byte copies
    qkv_g, qkv_cls, d_tok = (_aligned16(t) for t in (qkv_g, qkv_cls, d_tok))
    plan = bwd_plan(B, G, L, dim_head)
    d_qkv = _empty_grouped(qkv_g, c3)
    d_qkvc = torch.empty((B, 1, c3), dtype=qkv_g.dtype, device=dev)
    cls_scratch, kv_part, row_stats = _bwd_scratch(plan, B, G, L, heads, dim_head, dev)
    if row_bias is not None:
        row_bias = row_bias.expand(B, G, L)
        rb_ptr, rb_strides = row_bias.data_ptr(), row_bias.stride()
    else:
        rb_ptr, rb_strides = None, (0, 0, 0)
    lib = _build.load("divided_attention_bwd")
    fn = lib.divided_attention_bwd
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = ([ptr, i64, i64, i64, ptr, i64, ptr, ptr, i64, i64, i64, ptr, i64, i64, i64,
                    ptr, i64, ptr, i64, i64, i64, ptr, i64, ptr, ptr, ptr]
                   + [ctypes.c_int] * 9 + [ptr])
    fn.restype = ctypes.c_int
    sb, sg, sl, _ = qkv_g.stride()
    tb, tg, tl, _ = d_tok.stride()
    ob, og, ol, _ = d_qkv.stride()
    with torch.cuda.device(dev):
        status = fn(
            qkv_g.data_ptr(), sb, sg, sl, qkv_cls.data_ptr(), qkv_cls.stride(0),
            None if seq_bias is None else seq_bias.data_ptr(), rb_ptr, *rb_strides,
            d_tok.data_ptr(), tb, tg, tl, d_cls.data_ptr(), d_cls.stride(0),
            d_qkv.data_ptr(), ob, og, ol, d_qkvc.data_ptr(), d_qkvc.stride(0),
            cls_scratch.data_ptr(), kv_part.data_ptr(), row_stats.data_ptr(),
            B, G, L, heads, dim_head, plan["groups_per_block"], plan["row_chunks"],
            plan["threads"], plan["cls_chunks"], torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "divided_attention_bwd")
    bwd_launches += 1
    return d_qkv, d_qkvc


class DividedAttentionFunction(torch.autograd.Function):
    """Divided attention with its recompute backward (the ``custom_vjp`` of
    ``pallas_attention.py:488-511``): kernels for CUDA tensors, plain
    versions for CPU tensors. The biases get zero gradients, as in the JAX
    package."""

    @staticmethod
    def forward(ctx, qkv_g, qkv_cls, seq_bias, row_bias, heads, dim_head):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(qkv_g, qkv_cls, seq_bias, row_bias)
        ctx.heads, ctx.dim_head = heads, dim_head
        fwd = divided_attention_cuda if qkv_g.is_cuda else divided_attention_plain
        return fwd(qkv_g, qkv_cls, seq_bias, row_bias, heads=heads, dim_head=dim_head)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_tok, d_cls):
        qkv_g, qkv_cls, seq_bias, row_bias = ctx.saved_tensors
        bwd = divided_attention_bwd_cuda if qkv_g.is_cuda else divided_attention_bwd_plain
        d_qkv, d_qkvc = bwd(qkv_g, qkv_cls, seq_bias, row_bias, d_tok, d_cls,
                            heads=ctx.heads, dim_head=ctx.dim_head)
        zero = [torch.zeros_like(t) if t is not None and need else None
                for t, need in zip((seq_bias, row_bias), ctx.needs_input_grad[2:4])]
        return d_qkv, d_qkvc, *zero, None, None


def divided_attention(qkv_g, qkv_cls, seq_bias, row_bias, *, heads: int, dim_head: int):
    """Grouped attention with a CLS row from packed ``[q|k|v]`` qkv,
    differentiable.

    Same arguments and results as :func:`divided_attention_plain`. A slice of
    at most :data:`WHOLE_SLICE_BYTES` takes the whole-slice kernels; a larger
    one the token-row kernels and :func:`~mintime_torch.ops.token_rows.
    cls_row_plain`. CPU tensors take the plain versions; CUDA tensors take the
    kernels or raise. There is no fallback between the two.
    """
    _, G, L, c3 = qkv_g.shape
    if takes_whole_slice(G, L, c3, qkv_g.element_size()):
        return DividedAttentionFunction.apply(qkv_g, qkv_cls, seq_bias, row_bias, heads, dim_head)
    out_tok = token_rows_attention(qkv_g, qkv_cls, seq_bias, heads=heads, dim_head=dim_head)
    return out_tok, cls_row_plain(qkv_g, qkv_cls, row_bias, heads=heads, dim_head=dim_head)
