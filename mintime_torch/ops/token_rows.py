"""Token rows of the divided attention for slices too large for the
whole-slice kernel, and the CLS row outside any kernel (counterpart of
``mintime_tpu/ops/pallas_attention.py``: ``_token_rows_kernel`` at
``:530-568``, ``_token_rows_bwd_kernel`` at ``:571-637``, the ``custom_vjp``
at ``:719-741`` and ``_cls_row_xla`` at ``:744-766``).

:func:`mintime_torch.ops.divided_attention.divided_attention` sends a slice
here when its packed qkv exceeds the whole-slice budget: the Convolutional
TimeSformer's time axis, G = 1280 channel groups of L = 8 frames. Groups never
interact in the token rows, so they need no cross-group pass; the one CLS row
over all G*L keys is plain PyTorch (:func:`cls_row_plain`), differentiated by
autograd, as the JAX package leaves it to XLA.

:func:`token_rows_attention` is differentiable through
:class:`TokenRowsAttentionFunction`. For CUDA tensors its forward runs the
kernel ``csrc/token_rows_attention.cu`` and its backward
``csrc/token_rows_attention_bwd.cu``, launched as :func:`plan` lays them
out; for CPU tensors they run :func:`token_rows_attention_plain` and
:func:`token_rows_attention_bwd_plain`.
The plain versions repeat the kernels' arithmetic: q scaled in the input
dtype, fp32 logits, the normalised probabilities rounded to the input dtype
before PV, the CLS value term added in fp32; the backward recomputes the
softmax in fp32 and rounds only its results. The CLS key and value get their
gradient summed over every group in fp32 and cast to ``qkv_cls``'s dtype; the
CLS query's third of that gradient is zero (the CLS row's own gradient comes
through :func:`cls_row_plain`).

Packed columns are ``[q | k | v]``-major with heads inside each third
(PyTorch's ``to_qkv`` layout; the JAX package packs head-major).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from mintime_torch.ops import _build

#: forward kernel launches since the last reset (one per
#: :func:`token_rows_attention_cuda` call)
launches = 0
#: backward kernel launches since the last reset (one per
#: :func:`token_rows_attention_bwd_cuda` call)
bwd_launches = 0

_KERNEL_DH = 64
_KERNEL_MAX_L = 64  # both kernels'; the attention probe runs the forward on the space axis, L = 49
#: rows of a warp's tensor-core tile; up to this L the kernels pack 16 // L
#: whole groups a tile under a block-diagonal mask
_TILE_ROWS = 16
#: most warps a block of the tile launches, a head each
_TILE_MAX_WARPS = 8
#: most runs of whole tiles a block of the tile backward takes one after
#: another, copying the next run while it computes this one; the forward
#: takes one (a second buffer costs it more blocks an SM than it gains)
_TILE_RUNS = 4
#: the H100's SMs, for plans made without a card
_SMS = 132
#: query rows (row launch) or keys (column launch) of one group's chunk in a
#: block of the attention backward's token-row launches above
#: ``_TILE_ROWS``, and their most warps a block: a warp per 16 rows
_ROWS_TILE = 64
_ROWS_WARPS = 4


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def _split(qkv, heads, dim_head):
    """(..., 3*H*dh) → q, k, v each (..., H, dh)."""
    t = qkv.unflatten(-1, (3, heads, dim_head))
    return t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]


def _empty_grouped(like, last: int):
    """Uninitialised (B, G, L, last) tensor in the stride order of ``like``:
    a transposed view when ``like`` is the (B, L, G, ·) layout seen as
    (B, G, L, ·), so transposing it back is free."""
    B, G, L, _ = like.shape
    if like.stride(1) < like.stride(2):
        return torch.empty((B, L, G, last), dtype=like.dtype, device=like.device).transpose(1, 2)
    return torch.empty((B, G, L, last), dtype=like.dtype, device=like.device)


def _token_softmax(q, k, kc, seq_bias):
    """fp32 probabilities (B, H, G, L, 1+L) over [CLS key | L keys] of each
    group, from the scaled fp32 q (B, G, L, H, dh), k and kc."""
    logits = torch.cat([torch.einsum("bglhd,bhd->bhgl", q, kc)[..., None],
                        torch.einsum("bglhd,bgmhd->bhglm", q, k)], dim=-1)
    if seq_bias is not None:
        logits = logits + seq_bias.float()[:, None, None]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def _upcast(qkv_g, qkv_cls, heads, dim_head):
    """fp32 q (scaled in the input dtype), k, v, q_cls (scaled), k_cls, v_cls."""
    f32 = torch.float32
    scale = dim_head ** -0.5
    q, k, v = _split(qkv_g, heads, dim_head)  # (B, G, L, H, dh)
    qc, kc, vc = _split(qkv_cls[:, 0], heads, dim_head)  # (B, H, dh)
    return ((q * scale).to(f32), k.to(f32), v.to(f32), (qc * scale).to(f32), kc.to(f32),
            vc.to(f32))


def _token_rows_out(q, k, v, kc, vc, seq_bias, dt):
    """Token-row outputs (B, G, L, H*dh) in ``dt`` from the fp32 operands of
    :func:`_upcast`: probabilities rounded to ``dt`` before PV, the CLS value
    term added in fp32."""
    B, G, L, H, dh = q.shape
    attn = _token_softmax(q, k, kc, seq_bias).to(dt).float()
    out = torch.einsum("bhglm,bgmhd->bglhd", attn[..., 1:], v)
    out = out + attn[..., 0].permute(0, 2, 3, 1)[..., None] * vc[:, None, None]
    return out.reshape(B, G, L, H * dh).to(dt)


def _token_rows_grads(q, k, v, kc, vc, do, seq_bias):
    """fp32 gradients of the token rows from the fp32 operands and the
    cotangent ``do`` (B, G, L, H, dh), the softmax recomputed: (dq before
    its dh^-0.5, dK, dV, dk_cls and dv_cls summed over the groups)."""
    attn = _token_softmax(q, k, kc, seq_bias)  # (B, H, G, L, 1+L)
    dattn = torch.cat([torch.einsum("bglhd,bhd->bhgl", do, vc)[..., None],
                       torch.einsum("bglhd,bgmhd->bhglm", do, v)], dim=-1)
    dlog = attn * (dattn - (dattn * attn).sum(dim=-1, keepdim=True))
    dq = (torch.einsum("bhglm,bgmhd->bglhd", dlog[..., 1:], k)
          + torch.einsum("bhgl,bhd->bglhd", dlog[..., 0], kc))
    dk = torch.einsum("bhglm,bglhd->bgmhd", dlog[..., 1:], q)
    dv = torch.einsum("bhglm,bglhd->bgmhd", attn[..., 1:], do)
    dkc = torch.einsum("bhgl,bglhd->bhd", dlog[..., 0], q)
    dvc = torch.einsum("bhgl,bglhd->bhd", attn[..., 0], do)
    return dq, dk, dv, dkc, dvc


def token_rows_attention_plain(qkv_g, qkv_cls, seq_bias, *, heads: int, dim_head: int):
    """Plain PyTorch version of the token-rows kernel.

    Args:
      qkv_g: (B, G, L, 3*H*dh) packed ``[q|k|v]`` token projections (any
        strides).
      qkv_cls: (B, 1, 3*H*dh) CLS projections.
      seq_bias: (B, L, 1+L) fp32 additive mask of the token rows (column 0 =
        CLS key) or None.
    Returns out (B, G, L, H*dh) in qkv's dtype.
    """
    q, k, v, _, kc, vc = _upcast(qkv_g, qkv_cls, heads, dim_head)
    return _token_rows_out(q, k, v, kc, vc, seq_bias, qkv_g.dtype)


def token_rows_attention_bwd_plain(qkv_g, qkv_cls, seq_bias, d_tok, *, heads: int,
                                   dim_head: int):
    """Plain PyTorch version of the token-rows backward kernel.

    ``d_tok (B, G, L, H*dh)`` is the cotangent of
    :func:`token_rows_attention_plain`'s output. Returns ``(d_qkv, d_qkvc)``:
    ``d_qkv`` in qkv's dtype and the stride order of ``qkv_g``; ``d_qkvc (B, 1,
    3*H*dh)`` in ``qkv_cls``'s dtype, the CLS key and value gradients summed
    over every group in fp32, its q third zero.
    """
    B, G, L, c3 = qkv_g.shape
    q, k, v, _, kc, vc = _upcast(qkv_g, qkv_cls, heads, dim_head)
    do = d_tok.to(qkv_g.dtype).float().unflatten(-1, (heads, dim_head))
    dq, dk, dv, dkc, dvc = _token_rows_grads(q, k, v, kc, vc, do, seq_bias)
    d_qkv = _empty_grouped(qkv_g, c3)
    d_qkv.copy_(torch.stack([dim_head ** -0.5 * dq, dk, dv], dim=3).reshape(B, G, L, -1))
    d_qkvc = torch.stack([torch.zeros_like(dkc), dkc, dvc], dim=1).reshape(B, 1, -1)
    return d_qkv, d_qkvc.to(qkv_cls.dtype)


def rows_plan(B: int, G: int, L: int) -> dict:
    """Launch shape of the attention backward's token-row launches (the row
    and column launches of ``csrc/attn_bwd_rows_mma.cuh``) for B videos of G
    groups of L positions: a warp takes 16 rows (or keys) of one group; a
    block a ``_ROWS_TILE``-row chunk of one group where L is longer, else
    whole groups, as many as its ``_ROWS_WARPS`` warps hold (four of L <=
    16, two of L <= 32, one on three or four warps at L <= 64), numbered ``n
    = b * G + g`` across videos. Returns ``groups_per_block``,
    ``row_chunks`` (chunks of a group), ``threads`` and ``blocks`` (of each
    launch, per head)."""
    tiles = -(-L // 16)
    warps_per_group = min(tiles, _ROWS_WARPS)
    chunks = -(-L // _ROWS_TILE)
    groups = _ROWS_WARPS // warps_per_group if chunks == 1 else 1
    return {"groups_per_block": groups, "row_chunks": chunks,
            "threads": 32 * warps_per_group * groups, "blocks": -(-B * G // groups) * chunks}


def plan(B: int, G: int, L: int, heads: int, dim_head: int = _KERNEL_DH,
         sms: int = _SMS) -> dict:
    """Launch shape of the token-row kernels for B videos of G groups of L
    positions at ``heads`` heads on a card of ``sms`` SMs; the wrappers pass
    it to the kernels as it is.

    Up to L = 16 (``tiled``) both kernels run the tile of
    ``csrc/token_rows_tile.cuh``: a warp owns 16 rows of one head holding
    ``groups_per_tile`` = 16 // L whole groups under a block-diagonal mask.
    A block takes such a tile's groups (a run; never two videos: an odd G
    leaves a video's last tile short) at ``heads_per_block`` heads, a warp a
    head (``threads``); its grid is ``fwd_blocks`` or ``bwd_blocks`` by
    ``head_chunks``. The forward takes one run a block; the backward
    ``bwd_runs``, up to ``_TILE_RUNS`` one after another, double-buffered,
    as many as leave two blocks an SM, and writes one fp32 partial of the CLS
    key's gradients a block and head, ``kv_part``; ``row_stats`` is None.
    ``smem_fwd`` and ``smem_bwd`` are the blocks' shared memory in bytes.

    Above, the forward runs the divided forward's token rows (a block per
    (b, g, h) of ``fwd_threads``) and the backward the divided backward's
    row and column launches (:func:`rows_plan`: ``groups_per_block``,
    ``row_chunks``, ``threads``, ``blocks``) with a partial a group chunk
    and head (``kv_part``) and each row's max, sum and s_dot
    (``row_stats``).

    ``fwd_launches`` and ``bwd_launches`` count a call's CUDA launches (the
    backward's last one is the ordered reduce of the partials)."""
    if L <= _TILE_ROWS:
        gpt = _TILE_ROWS // L
        head_chunks = -(-heads // _TILE_MAX_WARPS)
        hpb = -(-heads // head_chunks)
        blocks = lambda runs: B * -(-G // (gpt * runs))  # noqa: E731
        bwd_runs = next((r for r in range(_TILE_RUNS, 1, -1) if blocks(r) >= 2 * sms), 1)
        tile = 2 * _TILE_ROWS * dim_head  # bytes of a bf16 tile
        cls = 4 * 2 * hpb * dim_head  # k_cls and v_cls in fp32
        col0 = 4 * hpb * 2 * dim_head  # the backward's column-0 sums of each head
        return {"tiled": True, "groups_per_tile": gpt, "heads_per_block": hpb,
                "head_chunks": head_chunks, "threads": 32 * hpb,
                "fwd_blocks": blocks(1), "bwd_runs": bwd_runs,
                "bwd_blocks": blocks(bwd_runs), "row_chunks": 0,
                "kv_part": (blocks(bwd_runs), heads, 2, dim_head), "row_stats": None,
                "smem_fwd": 3 * hpb * tile + cls,
                "smem_bwd": (2 if bwd_runs > 1 else 1) * 4 * hpb * tile + cls + col0,
                "fwd_threads": 32 * hpb, "fwd_launches": 1, "bwd_launches": 2}
    rows = rows_plan(B, G, L)
    return {"tiled": False, "groups_per_tile": 0, "heads_per_block": 0, "bwd_runs": 0, **rows,
            "head_chunks": heads,
            "kv_part": (B * G * rows["row_chunks"], heads, 2, dim_head),
            "row_stats": (B, G, heads, L, 3), "fwd_threads": 32 * min(4, -(-L // 16)),
            "fwd_launches": 1, "bwd_launches": 3}


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its start and every stride but the last are 16-byte aligned,
    else a copy in its stride order (a model's views always are aligned)."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:-1]):
        return t
    out = _empty_grouped(t, t.shape[-1]) if t.dim() == 4 else torch.empty_like(
        t, memory_format=torch.contiguous_format)
    return out.copy_(t)


def _check_kernel_args(qkv_g, qkv_cls, seq_bias, heads, dim_head):
    B, G, L, c3 = qkv_g.shape
    if dim_head != _KERNEL_DH:
        raise ValueError(f"token_rows_attention kernel is built for dim_head {_KERNEL_DH},"
                         f" got {dim_head}")
    if c3 != 3 * heads * dim_head or qkv_cls.shape != (B, 1, c3):
        raise ValueError(f"token_rows_attention: qkv {tuple(qkv_g.shape)} / qkv_cls"
                         f" {tuple(qkv_cls.shape)} do not match heads {heads} x {dim_head}")
    if not 1 <= L <= _KERNEL_MAX_L:
        raise ValueError(f"token_rows_attention kernel takes 1 <= L <= {_KERNEL_MAX_L}, got {L}")
    for name, t in (("qkv", qkv_g), ("qkv_cls", qkv_cls)):
        if not t.is_cuda or t.device != qkv_g.device:
            raise ValueError(f"token_rows_attention: {name} is not on the card with qkv")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"token_rows_attention kernel takes bf16, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"token_rows_attention kernel needs unit stride on {name}'s last axis")
    if seq_bias is not None:
        if seq_bias.shape != (B, L, 1 + L) or seq_bias.dtype != torch.float32 \
                or not seq_bias.is_contiguous() or seq_bias.device != qkv_g.device:
            raise ValueError("token_rows_attention kernel needs seq_bias as contiguous fp32"
                             f" (B, L, 1+L) = {(B, L, 1 + L)} on the card")


def token_rows_attention_cuda(qkv_g, qkv_cls, seq_bias, *, heads: int, dim_head: int):
    """Launch the CUDA kernel under :func:`plan`. ``qkv_g`` may be any
    strided view whose last axis is contiguous (the time axis passes the
    (B, n, F, ·) transpose of the natural layout); the output gets the same
    stride order. A view whose start or strides are not 16-byte aligned is
    copied first."""
    global launches
    _check_kernel_args(qkv_g, qkv_cls, seq_bias, heads, dim_head)
    B, G, L, _ = qkv_g.shape
    dev = qkv_g.device
    # the launches stage rows by 16-byte copies
    qkv_g, qkv_cls = _aligned16(qkv_g), _aligned16(qkv_cls)
    p = plan(B, G, L, heads, dim_head, _sms(dev))
    tile = [p["groups_per_tile"], p["heads_per_block"], p["threads"] if p["tiled"] else 0]
    out = _empty_grouped(qkv_g, heads * dim_head)
    lib = _build.load("token_rows_attention")
    fn = lib.token_rows_attention_fwd
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = ([ptr, i64, i64, i64, ptr, i64, ptr, ptr, i64, i64, i64]
                   + [ctypes.c_int] * 8 + [ptr])
    fn.restype = ctypes.c_int
    sb, sg, sl, _ = qkv_g.stride()
    ob, og, ol, _ = out.stride()
    with torch.cuda.device(dev):
        status = fn(qkv_g.data_ptr(), sb, sg, sl, qkv_cls.data_ptr(), qkv_cls.stride(0),
                    None if seq_bias is None else seq_bias.data_ptr(), out.data_ptr(), ob, og, ol,
                    B, G, L, heads, dim_head, *tile, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "token_rows_attention")
    launches += 1
    return out


def bwd_scratch(p: dict, device):
    """The backward's fp32 scratch under the plan ``p``: (kv_part,
    row_stats or None), each written before it is read."""
    f32 = torch.float32
    return (torch.empty(p["kv_part"], dtype=f32, device=device),
            None if p["row_stats"] is None else torch.empty(p["row_stats"], dtype=f32,
                                                            device=device))


def token_rows_attention_bwd_cuda(qkv_g, qkv_cls, seq_bias, d_tok, *, heads: int,
                                  dim_head: int):
    """Launch the backward kernels under :func:`plan`; same results as
    :func:`token_rows_attention_bwd_plain`. ``d_tok`` may be any strided view
    whose last axis is contiguous; a view whose start or strides are not
    16-byte aligned is copied first. Scratch it allocates
    (:func:`bwd_scratch`): the fp32 partials of the CLS key and value
    gradients, and above 16 positions the rows' softmax statistics."""
    global bwd_launches
    _check_kernel_args(qkv_g, qkv_cls, seq_bias, heads, dim_head)
    B, G, L, c3 = qkv_g.shape
    dev = qkv_g.device
    d_tok = d_tok.to(qkv_g.dtype)
    if d_tok.stride(-1) != 1:
        d_tok = d_tok.contiguous()
    if d_tok.shape != (B, G, L, heads * dim_head) or d_tok.device != dev:
        raise ValueError(f"token_rows_attention: cotangent {tuple(d_tok.shape)} does not match"
                         f" qkv {tuple(qkv_g.shape)}")
    # the launches stage rows by 16-byte copies
    qkv_g, qkv_cls, d_tok = (_aligned16(t) for t in (qkv_g, qkv_cls, d_tok))
    p = plan(B, G, L, heads, dim_head, _sms(dev))
    if p["tiled"]:
        launch = [p["groups_per_tile"], p["heads_per_block"], p["bwd_runs"], 0, 0, p["threads"]]
    else:
        launch = [0, 0, 0, p["groups_per_block"], p["row_chunks"], p["threads"]]
    d_qkv = _empty_grouped(qkv_g, c3)
    d_qkvc = torch.empty((B, 1, c3), dtype=qkv_cls.dtype, device=dev)
    kv_part, row_stats = bwd_scratch(p, dev)
    lib = _build.load("token_rows_attention_bwd")
    fn = lib.token_rows_attention_bwd
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = ([ptr, i64, i64, i64, ptr, i64, ptr, ptr, i64, i64, i64, ptr, i64, i64, i64,
                    ptr, i64, ptr, ptr] + [ctypes.c_int] * 11 + [ptr])
    fn.restype = ctypes.c_int
    sb, sg, sl, _ = qkv_g.stride()
    tb, tg, tl, _ = d_tok.stride()
    ob, og, ol, _ = d_qkv.stride()
    with torch.cuda.device(dev):
        status = fn(qkv_g.data_ptr(), sb, sg, sl, qkv_cls.data_ptr(), qkv_cls.stride(0),
                    None if seq_bias is None else seq_bias.data_ptr(),
                    d_tok.data_ptr(), tb, tg, tl, d_qkv.data_ptr(), ob, og, ol,
                    d_qkvc.data_ptr(), d_qkvc.stride(0), kv_part.data_ptr(),
                    None if row_stats is None else row_stats.data_ptr(),
                    B, G, L, heads, dim_head, *launch,
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "token_rows_attention_bwd")
    bwd_launches += 1
    return d_qkv, d_qkvc


class TokenRowsAttentionFunction(torch.autograd.Function):
    """The token rows with their recompute backward (the ``custom_vjp`` of
    ``pallas_attention.py:719-741``): kernels for CUDA tensors, plain
    versions for CPU tensors. ``seq_bias`` gets a zero gradient, as in the
    JAX package."""

    @staticmethod
    def forward(ctx, qkv_g, qkv_cls, seq_bias, heads, dim_head):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(qkv_g, qkv_cls, seq_bias)
        ctx.heads, ctx.dim_head = heads, dim_head
        fwd = token_rows_attention_cuda if qkv_g.is_cuda else token_rows_attention_plain
        return fwd(qkv_g, qkv_cls, seq_bias, heads=heads, dim_head=dim_head)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_tok):
        qkv_g, qkv_cls, seq_bias = ctx.saved_tensors
        bwd = token_rows_attention_bwd_cuda if qkv_g.is_cuda else token_rows_attention_bwd_plain
        d_qkv, d_qkvc = bwd(qkv_g, qkv_cls, seq_bias, d_tok, heads=ctx.heads,
                            dim_head=ctx.dim_head)
        d_bias = torch.zeros_like(seq_bias) if ctx.needs_input_grad[2] else None
        return d_qkv, d_qkvc, d_bias, None, None


def token_rows_attention(qkv_g, qkv_cls, seq_bias, *, heads: int, dim_head: int):
    """The token rows of a divided attention from packed ``[q|k|v]`` qkv,
    differentiable. Same arguments and result as
    :func:`token_rows_attention_plain`. CPU tensors take the plain versions;
    CUDA tensors take the kernels or raise. There is no fallback between the
    two."""
    return TokenRowsAttentionFunction.apply(qkv_g, qkv_cls, seq_bias, heads, dim_head)


def cls_row_plain(qkv_g, qkv_cls, row_bias, *, heads: int, dim_head: int):
    """The CLS row over all G*L tokens and itself, in plain PyTorch and
    differentiated by autograd (``_cls_row_xla``, ``pallas_attention.py:744-766``):
    fp32 logits and softmax, the token probabilities rounded to v's dtype
    before their product, the CLS term's probability rounded to the CLS
    value's dtype and added in that dtype. ``row_bias``: fp32 bias
    broadcastable to (B, G, L), or None. Returns (B, 1, H*dh) in qkv's dtype.
    """
    f32 = torch.float32
    B = qkv_g.shape[0]
    scale = dim_head ** -0.5
    _, k, v = _split(qkv_g, heads, dim_head)  # (B, G, L, H, dh)
    qc, kc, vc = _split(qkv_cls[:, 0], heads, dim_head)  # (B, H, dh)
    qc = (qc * scale).to(f32)
    lr = torch.einsum("bhd,bglhd->bhgl", qc, k.to(f32))
    if row_bias is not None:
        lr = lr + row_bias.to(f32)[:, None]
    ls = (qc * kc.to(f32)).sum(dim=-1)  # (B, H)
    m = torch.maximum(lr.amax(dim=(2, 3)), ls)
    pr = torch.exp(lr - m[:, :, None, None])
    ps = torch.exp(ls - m)
    z = pr.sum(dim=(2, 3)) + ps
    out = (torch.einsum("bhgl,bglhd->bhd", (pr / z[:, :, None, None]).to(v.dtype), v)
           + (ps / z)[:, :, None].to(vc.dtype) * vc)
    return out.reshape(B, 1, heads * dim_head)
