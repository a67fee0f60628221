"""Chunked-dense divided attention (counterpart of
``experiments/attn_kernel_variants.py``: ``_chunked_kernel`` at ``:173-252``
and ``variant_g`` at ``:255-312``, variant G of the attention probe).

The same function as :func:`mintime_torch.ops.divided_attention.
divided_attention` (token rows plus the CLS row), computed another way: P
groups of L rows are packed into one tile of ``P * Lp`` rows and each tile
takes DENSE logits over all its rows under an additive block-diagonal bias
(``NEG`` between groups), so one product of a tile replaces P small ones.
G is padded to ``Gp = ceil(G / P) * P`` and L to ``Lp`` (the least length at
or above L with ``P * Lp`` a multiple of 16, the tensor-core tile; the TPU
probe's rule, ``L % 8`` for its sublanes, does not apply). Padded key
columns and padded groups get ``NEG``; padded query rows are dropped.

Rounding as the probe: q scaled in the input dtype, fp32 logits, the biases
added in fp32 (the block-diagonal bias to the tiled ``sbias`` first), fp32
softmax, the token-row probabilities rounded to the input dtype before PV,
the CLS value's term added in fp32; the CLS row as the whole-slice kernel's,
with unnormalised probabilities rounded before PV and the sum divided out at
the end.

The packed columns are ``[q | k | v]``-major with heads inside each third
(the port's layout; the JAX probe packs head-major), so the port's attention
probe gives variants A, B and G one set of tensors.

:func:`chunked_attention` runs :func:`chunked_attention_plain` for CPU
tensors and the kernel ``csrc/chunked_attention.cu`` for CUDA tensors: a
launch for the packed tiles' token rows, then the divided forward's three
launches for the CLS row (:func:`plan` gives their shapes and scratch). The
probe has no VJP, so neither has the kernel path: it raises on inputs that
require grad.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mintime_torch.ops import _build
from mintime_torch.ops.divided_attention import NEG, _cls_row_out, cls_row_chunks
from mintime_torch.ops.token_rows import _upcast

#: kernel launches since the last reset (one per :func:`chunked_attention_cuda` call)
launches = 0

_KERNEL_DH = 64
_KERNEL_MAX_TILE = 128  # P * Lp rows of one packed tile
_TILE = 16  # the tensor-core tile's rows


def reset_launches() -> None:
    global launches
    launches = 0


def padded_sizes(G: int, L: int, P: int) -> tuple[int, int]:
    """``(Gp, Lp)``: G padded to a multiple of P, and the least ``Lp >= L``
    with ``P * Lp`` a multiple of 16."""
    Lp = L
    while (P * Lp) % _TILE:
        Lp += 1
    return -(-G // P) * P, Lp


def plan(G: int, L: int, P: int, dim_head: int = _KERNEL_DH) -> dict:
    """What ``csrc/chunked_attention.cu`` takes for G groups of L positions
    packed P a tile: ``Lp`` (a group's padded rows; the token-row launch
    runs a block of P * Lp / 16 warps a tile), ``cls_chunks`` (chunks of
    the CLS row's G*L keys, one block of each of its launches per (b, h), as
    the divided forward chunks them) and ``cls_scratch`` (fp32 per (b, h):
    each key's logit, then a chunk's sum of bf16(p) v, sum of p and max)."""
    chunks = cls_row_chunks(G, L)
    return {"Lp": padded_sizes(G, L, P)[1], "cls_chunks": chunks,
            "cls_scratch": G * L + chunks * (dim_head + 2)}


def chunked_attention_plain(qkv, qkvc, sbias, rbias, *, heads: int, dim_head: int, P: int):
    """Plain PyTorch version of the kernel, packing as ``variant_g`` does.

    Args:
      qkv: (B, G, L, 3*H*dh) packed ``[q|k|v]`` token projections.
      qkvc: (B, 1, 3*H*dh) CLS projections.
      sbias: (B, L, 1+L) fp32 additive mask of the token rows (column 0 the
        CLS key).
      rbias: fp32 CLS-row bias broadcastable to (B, G, L), e.g. (B, 1, L).
      P: groups packed into one tile.
    Returns (out (B, G, L, H*dh), out_cls (B, 1, H*dh)) in qkv's dtype.
    """
    f32 = torch.float32
    B, G, L, _ = qkv.shape
    dt, dev = qkv.dtype, qkv.device
    Gp, Lp = padded_sizes(G, L, P)
    C, PL = Gp // P, P * Lp
    qkv_p = F.pad(qkv, (0, 0, 0, Lp - L, 0, Gp - G))
    sb = F.pad(sbias.to(f32), (0, 0, 0, Lp - L))  # padded query rows: 0 (dropped)
    sb = F.pad(sb, (0, Lp - L), value=NEG)  # padded key columns: NEG
    rb = torch.cat([rbias.to(f32).expand(B, G, L),
                    torch.full((B, Gp - G, L), NEG, dtype=f32, device=dev)], dim=1)
    rb = F.pad(rb, (0, Lp - L), value=NEG)  # (B, Gp, Lp): padded groups and columns NEG
    q, k, v, qc, kc, vc = _upcast(qkv_p, qkvc, heads, dim_head)  # fp32, q and qc scaled in dt

    def tiles(t):  # (B, Gp, Lp, H, dh) -> (B, H, C, P*Lp, dh)
        return t.permute(0, 3, 1, 2, 4).reshape(B, heads, C, PL, dim_head)

    qf, kf, vf = tiles(q), tiles(k), tiles(v)
    grp = torch.arange(PL, device=dev) // Lp
    block = torch.where(grp[:, None] == grp[None, :], 0.0, NEG).to(f32)
    sb_tok = sb[:, :, 1:].repeat(1, P, P) + block  # (B, PL, PL)
    sb_cls = sb[:, :, :1].repeat(1, P, 1)  # (B, PL, 1)
    logits = torch.cat([torch.einsum("bhcid,bhd->bhci", qf, kc)[..., None] + sb_cls[:, None, None],
                        torch.einsum("bhcid,bhcjd->bhcij", qf, kf) + sb_tok[:, None, None]],
                       dim=-1)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = (p / p.sum(dim=-1, keepdim=True)).to(dt).to(f32)
    og = (torch.einsum("bhcij,bhcjd->bhcid", attn[..., 1:], vf)
          + attn[..., :1] * vc[:, :, None, None])
    out = og.reshape(B, heads, Gp, Lp, dim_head).permute(0, 2, 3, 1, 4)[:, :G, :L]
    out = out.reshape(B, G, L, heads * dim_head).to(dt)
    return out, _cls_row_out(qc, kc, vc, k, v, rb, dt)


def _check_kernel_args(qkv, qkvc, sbias, rbias, heads, dim_head, P):
    B, G, L, c3 = qkv.shape
    if dim_head != _KERNEL_DH:
        raise ValueError(f"chunked_attention kernel is built for dim_head {_KERNEL_DH}, got {dim_head}")
    if c3 != 3 * heads * dim_head or qkvc.shape != (B, 1, c3):
        raise ValueError(f"chunked_attention: qkv {tuple(qkv.shape)} / qkvc {tuple(qkvc.shape)}"
                         f" do not match heads {heads} x {dim_head}")
    _, Lp = padded_sizes(G, L, P)
    if not P >= 1 or P * Lp > _KERNEL_MAX_TILE:
        raise ValueError(f"chunked_attention kernel takes tiles of P * Lp <= {_KERNEL_MAX_TILE}"
                         f" rows, got P={P}, Lp={Lp}")
    for name, t in (("qkv", qkv), ("qkvc", qkvc), ("sbias", sbias), ("rbias", rbias)):
        if not t.is_cuda or t.device != qkv.device:
            raise ValueError(f"chunked_attention: {name} is not on the card with qkv")
        if t.requires_grad:
            raise ValueError(f"chunked_attention has no backward (nor has the probe): {name}"
                             " requires grad")
    for name, t in (("qkv", qkv), ("qkvc", qkvc)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"chunked_attention kernel takes {name} contiguous in bf16")
    if sbias.shape != (B, L, 1 + L) or sbias.dtype != torch.float32 or not sbias.is_contiguous():
        raise ValueError(f"chunked_attention kernel needs sbias as contiguous fp32 (B, L, 1+L)"
                         f" = {(B, L, 1 + L)}")
    if rbias.dtype != torch.float32 or rbias.dim() != 3:
        raise ValueError("chunked_attention kernel needs rbias as 3-D fp32")


def chunked_attention_cuda(qkv, qkvc, sbias, rbias, *, heads: int, dim_head: int, P: int):
    """Launch the CUDA kernel (the packed tiles' token rows, then the CLS
    row's three launches over :func:`plan`'s chunks); same results as
    :func:`chunked_attention_plain`."""
    global launches
    _check_kernel_args(qkv, qkvc, sbias, rbias, heads, dim_head, P)
    B, G, L, _ = qkv.shape
    shape = plan(G, L, P, dim_head)
    inner = heads * dim_head
    dev = qkv.device
    out = torch.empty((B, G, L, inner), dtype=qkv.dtype, device=dev)
    out_cls = torch.empty((B, 1, inner), dtype=qkv.dtype, device=dev)
    cls_scratch = torch.empty((B, heads, shape["cls_scratch"]), dtype=torch.float32, device=dev)
    rbias = rbias.expand(B, G, L)
    fn = _build.load("chunked_attention").chunked_attention_fwd
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr] + [ctypes.c_int] * 8 + [ptr]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(qkv.data_ptr(), qkvc.data_ptr(), sbias.data_ptr(), rbias.data_ptr(),
                    *rbias.stride(), out.data_ptr(), out_cls.data_ptr(), cls_scratch.data_ptr(),
                    shape["cls_chunks"], B, G, L, heads, dim_head, P, shape["Lp"],
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "chunked_attention")
    launches += 1
    return out, out_cls


def chunked_attention(qkv, qkvc, sbias, rbias, *, heads: int, dim_head: int, P: int):
    """Chunked-dense divided attention; same arguments and results as
    :func:`chunked_attention_plain`. CPU tensors take the plain version;
    CUDA tensors take the kernel or raise. There is no fallback between the
    two."""
    fwd = chunked_attention_cuda if qkv.is_cuda else chunked_attention_plain
    return fwd(qkv, qkvc, sbias, rbias, heads=heads, dim_head=dim_head, P=P)
