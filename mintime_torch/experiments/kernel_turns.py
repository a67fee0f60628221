"""The port's kernels of this tree against another checkout's, in turns, on
one card: each kernel's device time, its plain version's, the card's bound
for the work and a library call that does the same work (a yardstick the
port never calls), at the shapes the main paths launch it at.

Each tree is measured by a process of its own (its ``mintime_torch`` on
``PYTHONPATH``, its kernels built into its own ``mintime_torch/.build/``), in
the order other, this, this, other, so that a drift of the card's clocks
falls on both alike. Without ``--other`` this tree alone is measured, once.
Both trees are measured by this file's row builders, which call only what
every tree's ``mintime_torch`` has: the kernels and their plain versions,
``utils.profiling``'s ``device_ms`` and ``_profile``, and the probes.

For each tree:

  geglu_ffn      at ``FFN_SHAPES`` (the flagship's token rows D=512 M=6272
                 and CLS rows M=8, the conv model's D=256 M=81920 and M=8):
                 :func:`ffn_fwd_row` (the output against the plain version,
                 device and host ms, PyTorch's three calls by device ms);
  geglu_ffn_bwd  at ``FFN_SHAPES``: :func:`ffn_bwd_row` (each gradient
                 against the plain version, device and host ms);
  dw_conv, dw_conv_wgrad, conv3x3  the probes' ``run(check=True)``
                 (``dw_conv_cuda_vs_cudnn``, ``dw_conv_bwd_cuda_vs_cudnn``,
                 ``dw_conv3x3_cuda_vs_cudnn``): ms by CUDA events beside
                 cuDNN's, relative error against the plain version;
  divided_attention, divided_attention_bwd  at :func:`divided_cases` (the
                 flagship's time and space axes at batch 8 with masked
                 frames, the conv model's tap-10 time axis and its space
                 axis at L = 80, 112, 192, 256, and the flagship's axes as a
                 TP=2 model rank runs them): :func:`divided_fwd_row` and
                 :func:`divided_bwd_row` (outputs or each gradient against
                 the plain version, the kernel's and SDPA's device and host
                 ms);
  token_rows_attention, token_rows_attention_bwd  at ``TOKEN_ROWS_CASES``
                 (the conv time axis G = 1280 L = 8, masked G = 96, and G =
                 96 at L = 33, 49, 64, masked and not): :func:`token_rows_row`
                 and :func:`token_rows_bwd_row`;
  grouped_attention  at flagship width (B = 8, both axes, masked and not)
                 and ``GROUPED_EDGES``: :func:`grouped_row`;
  chunked_attention  at ``CHUNKED_CASES`` (the attention probe's time and
                 space axes at B = 32 and its packing, and the kernel's
                 edges): :func:`chunked_row`. A case that a tree's kernel
                 refuses (the CLS row of an older kernel holds at most 12288
                 keys) gives a row with the error and no times; only this
                 tree's refusals count as failures.

Each row but the probes' also holds two reruns bitwise equal or not and
three calls' CUDA launches by name under ``torch.profiler``. Every row
carries ``digest``, a hash of the bits of one call's outputs. Both trees
draw the same inputs, so with ``--same-bits NAME ...`` the named kernels
must give the same digest in every turn of both trees (a change that must
leave their results as they were).

Run on a machine with a card, from the root of a checkout, with another
checkout unpacked in a directory (for example by ``git archive``):
``python -m mintime_torch.experiments.kernel_turns [--other DIR] [--out FILE]
[--kernels NAME ...] [--same-bits NAME ...]``.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # this tree
TAG = "kernel_turns "  # prefix of the lines a measuring process prints
TOL = 2e-2  # max abs error of a kernel against its plain version

KERNELS = ("geglu_ffn", "geglu_ffn_bwd", "dw_conv", "dw_conv_wgrad", "conv3x3",
           "divided_attention", "divided_attention_bwd", "token_rows_attention",
           "token_rows_attention_bwd", "grouped_attention", "chunked_attention")

#: the FFN's shapes on the main paths: (model width, hidden width, [(M, calls per
#: forward, calls per train step)]) for the flagship (the token and CLS rows of
#: 8 videos, 9 layers) and the Convolutional TimeSformer (4 layers)
FFN_SHAPES = ((512, 2048, ((8 * 16 * 49, 9, 8), (8, 9, 9))),
              (256, 1024, ((8 * 8 * 1280, 4, 3), (8, 4, 4))))
#: the conv model's whole-slice attentions at tap blocks 4-13 (6 x 64 heads,
#: batch 8, no masks): (G, L, axis, launches per forward and per train step).
#: Tap block 10 (192 channel tokens) runs both axes, four layers each; 80, 112
#: and 256 are the other long axes the kernels take (tap blocks 4-6, 7-9, and
#: the limit)
CONV_LONG_AXES = ((192, 8, "time", 4), (8, 80, "space", 0), (8, 112, "space", 0),
                  (8, 192, "space", 4), (8, 256, "space", 0))
#: the flagship's attention as a TP=2 model rank runs it: half the heads,
#: inputs from a seed of their own
TP_HEADS, TP_SEED = 4, 18
#: (G, L, seq mask, launches a forward or a train step) of the token-row
#: kernels' rows: the conv time axis (four layers), and with no calls
#: masked G = 96 and the long axes the kernels take (no main path)
TOKEN_ROWS_CASES = ((1280, 8, False, 4), (96, 8, True, 0)) + tuple(
    (96, L, masked, 0) for L in (33, 49, 64) for masked in (False, True))
#: (G, L, D, masked) of the grouped kernel's edges: one key, one past a
#: 16-row tile, the longest group, and a head width that is no multiple of 8;
#: masked ones also mask every token key of some rows
GROUPED_EDGES = ((8, 1, 64, False), (8, 17, 64, True), (8, 33, 64, False), (4, 64, 64, True),
                 (16, 49, 30, True))
#: (tag, G, L, P, B, masked row, calls) of the chunked attention's rows: the
#: attention probe's two axes at its packing (B = 32, each launched once by
#: the probe's row), then its edges with no calls: G no multiple of P, an odd
#: L padded to Lp > L, a tile of 128 rows, more CLS-row keys (G*L) than one
#: block's shared memory holds, and a video whose token keys are all masked
#: but the CLS key (its CLS row sees only itself)
CHUNKED_CASES = (("time", 49, 16, 4, 32, False, 1), ("space", 16, 49, 2, 32, False, 1),
                 ("edge", 13, 16, 4, 2, False, 0), ("edge", 10, 13, 3, 2, False, 0),
                 ("edge", 49, 16, 8, 2, False, 0), ("edge", 112, 128, 1, 2, False, 0),
                 ("edge", 16, 49, 2, 2, True, 0))


def _max_err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def _numel(*tensors) -> int:
    return sum(0 if t is None else t.numel() for t in tensors)


def _grad_err(names, got, want) -> list[dict]:
    """Per gradient: its max abs error, the plain version's max |value| and
    the limit 2e-2 * max(1, max |plain|)."""
    rows = []
    for n, g, w in zip(names, got, want):
        top = float(w.float().abs().max())
        rows.append({"grad": n, "max_abs_err": float((g.float() - w.float()).abs().max()),
                     "max_plain": top, "limit": TOL * max(1.0, top)})
    return rows


def ffn_weights(r, dim, hidden):
    """W0, b0, W1, b1 at unit fan-in scale."""
    return (r(2 * hidden, dim, sc=dim ** -0.5), r(2 * hidden, sc=0.02),
            r(dim, hidden, sc=hidden ** -0.5), r(dim, sc=0.02))


def _geglu_plain_ops(x, w0, b0, w1, b1):
    """The FFN forward as PyTorch's own calls in bf16: ``F.linear``, the
    GEGLU gate (``F.gelu`` and a product), ``F.linear``; a yardstick the port
    never calls."""
    import torch.nn.functional as F

    val, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
    return F.linear(val * F.gelu(gate), w1, b1)


def ffn_fwd_row(args, calls):
    """The FFN forward vs its plain version, its device time (``ms``: the
    kernels' durations under ``torch.profiler``), the host's ms per call by
    CUDA events over back-to-back calls, the plain version's device time, the
    bound and the same function as PyTorch's three calls (cuBLAS products
    around the gate), by device time."""
    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.utils.profiling import device_ms

    x, w0, b0, w1, b1 = args
    m, dim = x.shape
    hidden = w1.shape[1]
    plain = ffn.geglu_ffn_plain(*args)
    nbytes = 2 * (2 * m * dim + w0.numel() + b0.numel() + w1.numel() + b1.numel())
    b_ms, b_by = bound_ms(nbytes, 2 * m * 3 * dim * hidden)
    call = lambda: ffn.geglu_ffn_cuda(*args)  # noqa: E731
    return {
        "shape": f"D={dim} H={hidden} M={m}", "calls": calls,
        "max_abs_err": _max_err(call(), plain), "ms": device_ms(call), "host_ms": time_ms(call),
        "plain_ms": device_ms(lambda: ffn.geglu_ffn_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "cublas_products_ms": device_ms(lambda: _geglu_plain_ops(*args)),
        "cublas_products_max_abs_err": _max_err(_geglu_plain_ops(*args), plain),
    }


def ffn_bwd_row(args, calls):
    """The FFN backward vs its plain version (per gradient), its device time
    (``ms``; ``host_ms``, by CUDA events over back-to-back calls, reads the
    host where the kernels finish sooner than the wrapper issues them), the
    plain version's and the bound."""
    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.utils.profiling import device_ms

    x, w0, b0, w1, dout = args
    m, dim = x.shape
    grads = _grad_err(("dx", "dw0", "db0", "dw1", "db1"), ffn.geglu_ffn_bwd_cuda(*args),
                      ffn.geglu_ffn_bwd_plain(*args))
    # read x, W0, b0, W1, dout; write dx (bf16) and the fp32 weight and bias gradients
    nbytes = (2 * (2 * m * dim + w0.numel() + b0.numel() + w1.numel() + m * dim)
              + 4 * (w0.numel() + b0.numel() + w1.numel() + dim))
    flops = 2 * m * dim * 8 * w1.shape[1]  # h, dprod, dx, dW0 (2H wide) and dW1 (H wide)
    b_ms, b_by = bound_ms(nbytes, flops)
    call = lambda: ffn.geglu_ffn_bwd_cuda(*args)  # noqa: E731
    return {
        "shape": f"D={dim} H={w1.shape[1]} M={m}", "calls": calls,
        "max_abs_err": max(g["max_abs_err"] for g in grads), "grads": grads,
        "ms": device_ms(call), "host_ms": time_ms(call),
        "plain_ms": device_ms(lambda: ffn.geglu_ffn_bwd_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def _attention_inputs(axis, gen, B=8, F=16, n=49, H=8, dh=64):
    """Flagship qkv for one axis with invalid frames and two identities."""
    import torch

    from mintime_torch.ops.attention import build_frame_mask
    from mintime_torch.ops.divided_attention import mask_to_bias

    inner = H * dh
    qkv = torch.randn(B, F, n, 3 * inner, generator=gen).cuda().bfloat16()
    qkvc = torch.randn(B, 1, 3 * inner, generator=gen).cuda().bfloat16()
    mask = torch.ones(B, F, dtype=torch.bool)
    mask[1, 10:] = False
    mask[5, 4:] = False
    ids = torch.ones(B, F, F, dtype=torch.bool)
    ids[:, :8, 8:] = False
    ids[:, 8:, :8] = False
    rb = mask_to_bias(mask.cuda())
    if axis == "time":
        return (qkv.transpose(1, 2), qkvc, mask_to_bias(build_frame_mask(mask, ids).cuda()),
                rb[:, None, :])
    return qkv, qkvc, None, rb[:, :, None]


def divided_cases(gen):
    """The whole-slice attention's shapes: the flagship's two axes (launched 8
    times a forward and 9 a train step each), ``CONV_LONG_AXES`` and the
    flagship's axes at ``TP_HEADS``, as (shape, (qkv, qkv_cls, seq_bias,
    row_bias), heads, launches per forward, launches per train step)."""
    import torch

    cases = []
    for axis in ("time", "space"):
        args = _attention_inputs(axis, gen)
        B, G, L, _ = args[0].shape
        cases.append((f"{axis} B={B} G={G} L={L} H=8 dh=64", args, 8, 8, 9))
    B, H, dh = 8, 6, 64
    for G, L, axis, calls in CONV_LONG_AXES:
        if axis == "time":  # the (B, F, C, ·) layout seen as its transpose, as the model passes it
            qkv = torch.randn(B, L, G, 3 * H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
        else:
            qkv = torch.randn(B, G, L, 3 * H * dh, generator=gen).cuda().bfloat16()
        qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
        cases.append((f"conv {axis} B={B} G={G} L={L} H={H} dh={dh}", (qkv, qkvc, None, None), H,
                      calls, calls))
    tp_gen = torch.Generator().manual_seed(TP_SEED)
    for axis in ("time", "space"):
        args = _attention_inputs(axis, tp_gen, H=TP_HEADS)
        B, G, L, _ = args[0].shape
        cases.append((f"tp2 {axis} B={B} G={G} L={L} H={TP_HEADS} dh=64", args, TP_HEADS, 8, 9))
    return cases


def _dense_row_bias(rbias, B, G):
    """The CLS-row bias for the one-call yardstick, which needs one."""
    import torch

    return torch.zeros(B, G, 1, device="cuda") if rbias is None else rbias


def divided_fwd_row(shape, args, H, calls):
    """The whole-slice attention forward against its plain version, its
    device time (``ms``: the call's four launches finish quicker than Python
    issues them, so a host clock over back-to-back calls, ``host_ms``,
    reads the host), the plain version's, the bound and one dense masked
    ``scaled_dot_product_attention`` call by device time. The yardstick must
    compute the function: within 2e-2 of the plain version."""
    import torch.nn.functional as F

    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.experiments.attn_kernel_variants import dense_inputs, split_dense
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.utils.profiling import device_ms

    qkv, qkvc, sb, rbias = args
    B, G, L, _ = qkv.shape
    dh = 64
    kw = dict(heads=H, dim_head=dh)
    plain = da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw)
    inner = H * dh
    nbytes = (2 * (qkv.numel() + qkvc.numel() + B * G * L * inner + B * inner)
              + 4 * _numel(sb, rbias))
    b_ms, b_by = bound_ms(nbytes, 4 * B * H * dh * (G * L * (1 + L) + G * L + 1))
    lq, lk, lv, lmask = dense_inputs(qkv, qkvc, sb, _dense_row_bias(rbias, B, G), H, dh)
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)  # noqa: E731
    lib_err = _max_err(split_dense(sdpa(), G, L), plain)
    if not lib_err <= TOL:
        raise RuntimeError(f"the one-call attention yardstick differs by {lib_err}")
    kernel = lambda: da.divided_attention_cuda(qkv, qkvc, sb, rbias, **kw)  # noqa: E731
    return {
        "shape": shape, "calls": calls, "max_abs_err": _max_err(kernel(), plain),
        "ms": device_ms(kernel), "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa),
        "library": "scaled_dot_product_attention, one dense masked call",
        "library_max_abs_err": lib_err,
    }


#: largest share of the backward's bf16 d_qkv values that may differ from
#: the fp32 plain version's
DIFFERING_LIMIT = 0.05


def divided_bwd_row(shape, args, H, calls, gen):
    """The backward kernel vs its plain version (per gradient, unit-scale
    cotangents), its device time (``ms``; ``host_ms`` by CUDA events over
    back-to-back calls, which reads the host where the kernels finish sooner
    than the wrapper issues them), the plain version's, the bound and the
    backward of one dense masked SDPA call, by device time too
    (``library_host_ms`` beside it)."""
    import torch
    import torch.nn.functional as F

    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.experiments.attn_kernel_variants import dense_inputs
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.utils.profiling import device_ms

    qkv, qkvc, sb, rbias = args
    B, G, L, _ = qkv.shape
    dh = 64
    inner = H * dh
    r = lambda *s: torch.randn(*s, generator=gen).cuda().bfloat16()  # noqa: E731
    d_tok, d_cls = r(B, G, L, inner), r(B, 1, inner)
    kw = dict(heads=H, dim_head=dh)
    fwd_args = (qkv, qkvc, sb, rbias, d_tok, d_cls)
    got = da.divided_attention_bwd_cuda(*fwd_args, **kw)
    want = da.divided_attention_bwd_plain(*fwd_args, **kw)
    grads = _grad_err(("d_qkv", "d_qkvc"), got, want)
    differing = float((got[0] != want[0]).float().mean())
    del got, want
    nbytes = (2 * (2 * qkv.numel() + 2 * qkvc.numel() + d_tok.numel() + d_cls.numel())
              + 4 * _numel(sb, rbias))
    T = 1 + L  # token rows: logits, dP, dq over T keys; dk, dv over L; CLS row over G*L keys
    b_ms, b_by = bound_ms(nbytes, 2 * B * H * dh * (G * L * (3 * T + 2 * L) + 4 * G * L))
    lq, lk, lv, lmask = (t.requires_grad_() if t.dtype != torch.bool else t
                         for t in dense_inputs(qkv, qkvc, sb, _dense_row_bias(rbias, B, G), H, dh))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)
    lgrad = r(*lout.shape)
    sdpa_bwd = lambda: torch.autograd.grad(lout, (lq, lk, lv), lgrad, retain_graph=True)  # noqa: E731
    kernel = lambda: da.divided_attention_bwd_cuda(*fwd_args, **kw)  # noqa: E731
    return {
        "shape": shape, "calls": calls,
        "max_abs_err": max(g["max_abs_err"] for g in grads), "grads": grads,
        "ms": device_ms(kernel), "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: da.divided_attention_bwd_plain(*fwd_args, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(sdpa_bwd), "library_host_ms": time_ms(sdpa_bwd),
        "library": "backward of one dense masked scaled_dot_product_attention call",
        "d_qkv_differing": differing, "differing_limit": DIFFERING_LIMIT,
    }


def token_rows_inputs(gen, G, masked, B=8, F=8, H=6, dh=64):
    """The Convolutional TimeSformer's time axis: qkv (B, F, G, 3*H*dh) seen
    as its (B, G, F, ·) transpose, the CLS qkv, and with ``masked`` a
    seq_bias that masks frames (column 0 the CLS key, always kept)."""
    import torch

    from mintime_torch.ops.attention import build_frame_mask
    from mintime_torch.ops.divided_attention import mask_to_bias

    qkv = torch.randn(B, F, G, 3 * H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    sb = None
    if masked:
        mask = torch.ones(B, F, dtype=torch.bool)
        mask[1, 5:] = False
        mask[6, 2:] = False
        sb = mask_to_bias(build_frame_mask(mask, None).cuda())
    return qkv, qkvc, sb


def token_rows_bwd_inputs(gen, case):
    """qkv, qkv_cls and seq_bias of :func:`token_rows_inputs` at one of
    ``TOKEN_ROWS_CASES`` and a unit-scale cotangent, which arrives as the
    transposed view of the natural layout, as in the model."""
    import torch

    G, L, masked, _ = case
    qkv, qkvc, sb = token_rows_inputs(gen, G, masked, F=L)
    d_tok = torch.randn(qkv.shape[0], L, G, 6 * 64, generator=gen).cuda().bfloat16().transpose(1, 2)
    return qkv, qkvc, sb, d_tok


def _token_rows_as_sdpa(qkv, qkvc, sb, H, dh):
    """The same token rows as one ``scaled_dot_product_attention`` call over
    (B*G, H, L, 1+L): q of each group's L rows, k and v with the CLS row's
    prepended, and with ``sb`` a boolean mask. Built outside the timed call;
    the port never calls it."""
    import torch

    from mintime_torch.ops.divided_attention import NEG

    B, G, L, _ = qkv.shape
    t = qkv.unflatten(-1, (3, H, dh)).reshape(B * G, L, 3, H, dh).permute(2, 0, 3, 1, 4)
    c = qkvc[:, 0].unflatten(-1, (3, H, dh)).repeat_interleave(G, dim=0)[:, :, :, None]
    q = t[0].contiguous()
    k, v = (torch.cat([c[:, i], t[i]], dim=2).contiguous() for i in (1, 2))
    mask = None if sb is None else (sb > NEG / 2).repeat_interleave(G, dim=0)[:, None]
    return q, k, v, mask


def _token_rows_shape(G, L, masked, calls, B=8, H=6, dh=64) -> str:
    return (f"{'' if calls or L == 8 else 'edge '}time B={B} G={G} L={L} H={H} dh={dh}"
            + (" seq_bias" if masked else ""))


def token_rows_row(case, gen):
    """The token-row forward kernel at one of ``TOKEN_ROWS_CASES`` against
    its plain version, its device time (``ms``; ``host_ms`` by CUDA events
    over back-to-back calls), the plain version's, the bound and one
    ``scaled_dot_product_attention`` call over the same groups, by device
    time too (``library_host_ms`` beside it). The yardstick must compute the
    function: within 2e-2 of the plain version."""
    import torch.nn.functional as F

    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.ops import token_rows as tr
    from mintime_torch.utils.profiling import device_ms

    G, L, masked, calls = case
    H, dh = 6, 64
    qkv, qkvc, sb = token_rows_inputs(gen, G, masked, F=L)
    B = qkv.shape[0]
    kw = dict(heads=H, dim_head=dh)
    plain = tr.token_rows_attention_plain(qkv, qkvc, sb, **kw)
    kernel = lambda: tr.token_rows_attention_cuda(qkv, qkvc, sb, **kw)  # noqa: E731
    nbytes = (2 * (qkv.numel() + qkvc.numel() + plain.numel())
              + 4 * (0 if sb is None else sb.numel()))
    flops = 4 * B * G * H * L * (1 + L) * dh  # logits and PV over 1 + L keys
    b_ms, b_by = bound_ms(nbytes, flops)
    lq, lk, lv, lmask = _token_rows_as_sdpa(qkv, qkvc, sb, H, dh)
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)  # noqa: E731
    lib_err = _max_err(sdpa().transpose(1, 2).reshape(plain.shape), plain)
    if not lib_err <= TOL:
        raise RuntimeError(f"the one-call token-row yardstick differs by {lib_err}")
    return {
        "shape": _token_rows_shape(G, L, masked, calls), "calls": calls,
        "max_abs_err": _max_err(kernel(), plain), "ms": device_ms(kernel),
        "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: tr.token_rows_attention_plain(qkv, qkvc, sb, **kw)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa),
        "library_host_ms": time_ms(sdpa),
        "library": "scaled_dot_product_attention over (B*G, H, L, 1+L)",
        "library_max_abs_err": lib_err,
    }


def token_rows_bwd_row(case, gen):
    """The token-row backward kernel at one of ``TOKEN_ROWS_CASES`` against
    its plain version per gradient (unit-scale cotangents), its device time
    (``ms``; ``host_ms`` beside it), the plain version's, the bound and the
    backward of one ``scaled_dot_product_attention`` call over the same
    groups by device time (``library_host_ms`` beside it)."""
    import torch

    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.ops import token_rows as tr
    from mintime_torch.utils.profiling import device_ms

    G, L, masked, calls = case
    H, dh = 6, 64
    args = token_rows_bwd_inputs(gen, case)
    qkv, qkvc, sb, d_tok = args
    B = qkv.shape[0]
    kw = dict(heads=H, dim_head=dh)
    grads = _grad_err(("d_qkv", "d_qkvc"), tr.token_rows_attention_bwd_cuda(*args, **kw),
                      tr.token_rows_attention_bwd_plain(*args, **kw))
    nbytes = (2 * (2 * qkv.numel() + 2 * qkvc.numel() + d_tok.numel())
              + 4 * (0 if sb is None else sb.numel()))
    T = 1 + L  # logits, dP and dq over T keys; dK and dV over L rows; dk_cls, dv_cls
    b_ms, b_by = bound_ms(nbytes, 2 * B * G * H * dh * (3 * L * T + 2 * L * L + 2 * L))
    lq, lk, lv, lmask = _token_rows_as_sdpa(qkv, qkvc, sb, H, dh)
    lq, lk, lv = (t.requires_grad_() for t in (lq, lk, lv))
    lout = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)
    lgrad = torch.randn(lout.shape, generator=gen).cuda().bfloat16()
    sdpa_bwd = lambda: torch.autograd.grad(lout, (lq, lk, lv), lgrad, retain_graph=True)  # noqa: E731
    kernel = lambda: tr.token_rows_attention_bwd_cuda(*args, **kw)  # noqa: E731
    return {
        "shape": _token_rows_shape(G, L, masked, calls), "calls": calls,
        "max_abs_err": max(g["max_abs_err"] for g in grads), "grads": grads,
        "ms": device_ms(kernel), "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: tr.token_rows_attention_bwd_plain(*args, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(sdpa_bwd), "library_host_ms": time_ms(sdpa_bwd),
        "library": "backward of scaled_dot_product_attention over (B*G, H, L, 1+L)",
    }


def grouped_inputs(gen, G, L, masked, B=8, H=8, D=64, edge=False):
    """Flagship-width q (pre-scaled), k, v (B, H, G, L, D; v at scale 0.5,
    so outputs stay below 2 and one bf16 step below 2e-2), the CLS k and v
    in bf16, and with ``masked`` a key mask (keys dropped at random, the CLS
    column kept; each row's own key kept too, or with ``edge`` every token
    key of every third row of the first video dropped) as (bool mask, fp32
    bias)."""
    import torch

    from mintime_torch.ops.divided_attention import mask_to_bias

    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    q, k, v = r(B, H, G, L, D, sc=D ** -0.5), r(B, H, G, L, D), r(B, H, G, L, D, sc=0.5)
    kc, vc = r(B, H, 1, D), r(B, H, 1, D)
    mask = None
    if masked:
        mask = torch.rand(B, L, 1 + L, generator=gen) > 0.3
        mask[..., 0] = True
        if edge:
            mask[0, ::3, 1:] = False
        else:
            mask[:, torch.arange(L), 1 + torch.arange(L)] = True
        mask = mask.cuda()
    return (q, k, v, kc, vc, None if mask is None else mask_to_bias(mask)), mask


def grouped_row(args, mask, H, calls, tag=""):
    """The grouped-attention kernel vs its plain version on ``args``, its
    time, the plain version's, the bound and one SDPA call over the groups
    with the CLS key prepended, all by device time."""
    import torch
    import torch.nn.functional as F

    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.ops import grouped_attention as ga
    from mintime_torch.utils.profiling import device_ms

    q, k, v, kc, vc, bias = args
    B, _, G, L, D = q.shape
    plain = ga.fused_grouped_attention_plain(*args, heads=H)
    # read q, k, v, k_cls, v_cls and the bias, write out
    nbytes = 2 * (4 * q.numel() + 2 * kc.numel()) + 4 * _numel(bias)
    b_ms, b_by = bound_ms(nbytes, 4 * B * H * G * L * (1 + L) * D)
    lq = q.reshape(B, H * G, L, D)
    lk, lv = (torch.cat([c[:, :, None].expand(B, H, G, 1, D), t], dim=3)
              .reshape(B, H * G, 1 + L, D) for c, t in ((kc, k), (vc, v)))
    lmask = None if mask is None else mask[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask, scale=1.0)  # noqa: E731
    kernel = lambda: ga.fused_grouped_attention_cuda(*args, heads=H)  # noqa: E731
    return {
        "shape": f"{tag}B={B} H={H} G={G} L={L} D={D}" + (" masked" if mask is not None else ""),
        "calls": calls, "max_abs_err": _max_err(kernel(), plain), "ms": device_ms(kernel),
        "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: ga.fused_grouped_attention_plain(*args, heads=H)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa),
        "library": "scaled_dot_product_attention over (B, H*G, L, 1+L), CLS prepended",
        "library_max_abs_err": _max_err(sdpa().reshape(plain.shape), plain),
    }


def chunked_inputs(case):
    """The attention probe's inputs (``make_inputs``, numpy seed 0: about a
    tenth of the keys masked) at a case's shape, and the call's keywords;
    a masked row masks every token key of video 0, token rows and CLS row,
    and keeps the CLS key of its token rows."""
    from mintime_torch.experiments import attn_kernel_variants as attn_probe
    from mintime_torch.ops.divided_attention import NEG

    _, G, L, P, B, masked_row, _ = case
    qkv, qkvc, sb, rb = attn_probe.make_inputs(G, L, batch=B)
    if masked_row:
        sb[0, :, 0], sb[0, :, 1:] = 0.0, NEG
        rb[0] = NEG
    return (qkv, qkvc, sb, rb), dict(heads=attn_probe.H, dim_head=attn_probe.DH, P=P)


def chunked_row(case):
    """The chunked attention against its plain version (limit 2e-2 at the
    probe's axes, 2e-2 * max(1, max |plain|) at the edges), two reruns
    bitwise equal or not, its device time (``ms``; ``host_ms`` by CUDA
    events beside it), the plain version's, the bound and one dense masked
    ``scaled_dot_product_attention`` call (the probe's variant D) by device
    time."""
    import torch
    import torch.nn.functional as F

    from mintime_torch.experiments import attn_kernel_variants as attn_probe
    from mintime_torch.experiments import bound_ms, time_ms
    from mintime_torch.ops import chunked_attention as ca
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.utils.profiling import device_ms

    tag, G, L, P, B, masked_row, calls = case
    args, kw = chunked_inputs(case)
    qkv, qkvc, sb, rb = args
    H, dh = kw["heads"], kw["dim_head"]
    kernel = lambda: ca.chunked_attention_cuda(*args, **kw)  # noqa: E731
    plain = ca.chunked_attention_plain(*args, **kw)
    got = kernel()
    top = max(float(p.float().abs().max()) for p in plain)
    # read qkv, the CLS row's qkv and both biases once, write both outputs;
    # the work of the divided attention (the dense tiles' masked products
    # are no part of the function)
    nbytes = (2 * (qkv.numel() + qkvc.numel() + plain[0].numel() + plain[1].numel())
              + 4 * (sb.numel() + rb.numel()))
    b_ms, b_by = bound_ms(nbytes, 4 * B * H * dh * (G * L * (1 + L) + G * L + 1))
    lq, lk, lv, lmask = attn_probe.dense_inputs(qkv, qkvc, sb, rb)
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)  # noqa: E731
    row = {
        "shape": f"{tag} B={B} G={G} L={L} H={H} dh={dh} P={P} Lp={ca.padded_sizes(G, L, P)[1]}"
                 + (" masked row" if masked_row else ""),
        "calls": calls, "max_abs_err": _max_err(got, plain), "max_plain": top,
        "limit": TOL if calls else TOL * max(1.0, top), "bitwise_reruns": _bitwise(kernel),
        "ms": device_ms(kernel), "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: ca.chunked_attention_plain(*args, **kw), iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa, iters=5),
        "library": "scaled_dot_product_attention, one dense masked call",
        "library_max_abs_err": _max_err(attn_probe.split_dense(sdpa(), G, L), plain),
        "kernel_vs_divided_plain": _max_err(
            got, da.divided_attention_plain(qkv, qkvc, sb, rb, heads=H, dim_head=dh)),
    }
    del args, qkv, qkvc, sb, rb, plain, got, lq, lk, lv, lmask
    torch.cuda.empty_cache()
    return row


def _launches(call) -> list:
    """Three calls' CUDA launches by name: [name, launches, ms over the three]."""
    from mintime_torch.utils.profiling import _profile

    prof = _profile(lambda: [call() for _ in range(3)], calls=3)
    return [[k["name"][:60], k["launches"], k["ms"]] for k in prof["top_kernels"]]


def _outputs(call) -> list:
    import torch

    got = call()
    return [got] if isinstance(got, torch.Tensor) else list(got)


def _bitwise(call) -> bool:
    import torch

    first = _outputs(call)
    return all(all(torch.equal(a, b) for a, b in zip(_outputs(call), first)) for _ in range(2))


def _digest(call) -> str:
    """A hash of the bits of one call's outputs."""
    import torch

    h = hashlib.sha256()
    for t in _outputs(call):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _probe_rows(name, kernels, out) -> None:
    """The depthwise kernels through their probes' ``run(check=True)`` (ms by
    CUDA events beside cuDNN's), each row with the digest of one call on the
    probe's inputs at its geometry."""
    import torch

    from mintime_torch.experiments import dw_conv3x3_cuda_vs_cudnn as xc
    from mintime_torch.experiments import dw_conv_bwd_cuda_vs_cudnn as dwb
    from mintime_torch.experiments import dw_conv_cuda_vs_cudnn as dwf
    from mintime_torch.ops import dw_conv

    if name not in kernels:
        return
    probe = {"dw_conv": dwf, "dw_conv_wgrad": dwb, "conv3x3": xc}[name]
    for row in probe.run(check=True):
        if name == "dw_conv":
            H, W, C, K = row["H"], row["W"], row["C"], row["K"]
            x, w, b = dwf.make_inputs(H, W, C, K)
            call = lambda: dw_conv.dw_conv_bias_silu_cuda(x, w, b, K=K)  # noqa: E731
            shape = f"N={row['N']} {H}x{W} C={C} K={K}"
        elif name == "dw_conv_wgrad":
            if row["stride"] != 1:  # cuDNN's only: the kernel takes stride 1
                continue
            H, C, K = row["H"], row["C"], row["K"]
            x, dy, _ = dwb.make_inputs(H, C, K, 1)
            call = lambda: dw_conv.dw_conv_wgrad_cuda(x, dy, K=K)  # noqa: E731
            shape = f"N={row['N']} {H}x{H} C={C} K={K}"
        else:
            H, W, C, relu = row["H"], row["W"], row["C"], row["relu"]
            x, w = xc.make_inputs(H, W, C)
            call = lambda: dw_conv.dw_conv3x3_cuda(x, w, relu=relu)  # noqa: E731
            shape = f"N={row['N']} {H}x{W} C={C} relu={int(relu)}"
        out({"kernel": name, **row, "shape": shape, "digest": _digest(call),
             "within": row["check_rel_err"] <= probe.CHECK_REL})
        del x, call
        torch.cuda.empty_cache()


def measure(label: str, kernels) -> None:
    """Measure the ``mintime_torch`` this process imports; print one line a row."""
    import torch

    from mintime_torch.experiments import card
    from mintime_torch.ops import chunked_attention as ca
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.ops import grouped_attention as ga
    from mintime_torch.ops import token_rows as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    out = lambda row: print(TAG + json.dumps({"tree": label, "card": smi, **row}), flush=True)  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    for dim, hidden, shapes in FFN_SHAPES if "geglu_ffn" in kernels else ():
        w0, b0, w1, b1 = ffn_weights(r, dim, hidden)
        for m, calls, _ in shapes:
            args = (r(m, dim), w0, b0, w1, b1)
            row = ffn_fwd_row(args, calls)
            call = lambda: ffn.geglu_ffn_cuda(*args)  # noqa: E731
            out({"kernel": "geglu_ffn", **row, "bitwise_reruns": _bitwise(call),
                 "digest": _digest(call),
                 "within": row["max_abs_err"] <= TOL, "launches_3_calls": _launches(call)})
            del args
        torch.cuda.empty_cache()
    for dim, hidden, shapes in FFN_SHAPES if "geglu_ffn_bwd" in kernels else ():
        w0, b0, w1, _ = ffn_weights(r, dim, hidden)
        for m, _, calls in shapes:
            args = (r(m, dim), w0, b0, w1, r(m, dim))
            row = ffn_bwd_row(args, calls)
            call = lambda: ffn.geglu_ffn_bwd_cuda(*args)  # noqa: E731
            out({"kernel": "geglu_ffn_bwd", **row, "bitwise_reruns": _bitwise(call),
                 "digest": _digest(call),
                 "within": all(g["max_abs_err"] <= g["limit"] for g in row["grads"]),
                 "launches_3_calls": _launches(call)})
            del args
        torch.cuda.empty_cache()
    for name in ("dw_conv", "dw_conv_wgrad", "conv3x3"):
        _probe_rows(name, kernels, out)

    for shape, args, H, calls, _ in divided_cases(gen) if "divided_attention" in kernels else ():
        row = divided_fwd_row(shape, args, H, calls)
        call = lambda: da.divided_attention_cuda(*args, heads=H, dim_head=64)  # noqa: E731
        out({"kernel": "divided_attention", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call),
             "within": row["max_abs_err"] <= TOL, "launches_3_calls": _launches(call)})
        del args
    if "divided_attention_bwd" in kernels:
        for shape, args, H, _, calls in divided_cases(gen):
            row = divided_bwd_row(shape, args, H, calls, gen)
            d_tok = torch.randn(*args[0].shape[:3], H * 64, generator=gen).cuda().bfloat16()
            d_cls = torch.randn(args[0].shape[0], 1, H * 64, generator=gen).cuda().bfloat16()
            call = lambda: da.divided_attention_bwd_cuda(*args, d_tok, d_cls, heads=H,  # noqa: E731
                                                         dim_head=64)
            out({"kernel": "divided_attention_bwd", **row, "bitwise_reruns": _bitwise(call),
                 "digest": _digest(call),
                 "within": all(g["max_abs_err"] <= g["limit"] for g in row["grads"])
                 and row["d_qkv_differing"] <= row["differing_limit"],
                 "launches_3_calls": _launches(call)})
            del args, d_tok, d_cls

    for case in TOKEN_ROWS_CASES if "token_rows_attention" in kernels else ():
        row = token_rows_row(case, gen)
        qkv, qkvc, sb = token_rows_inputs(gen, case[0], case[2], F=case[1])
        call = lambda: tr.token_rows_attention_cuda(qkv, qkvc, sb, heads=6, dim_head=64)  # noqa: E731
        out({"kernel": "token_rows_attention", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call),
             "within": row["max_abs_err"] <= TOL, "launches_3_calls": _launches(call)})
        del qkv, qkvc, sb
    for case in TOKEN_ROWS_CASES if "token_rows_attention_bwd" in kernels else ():
        row = token_rows_bwd_row(case, gen)
        args = token_rows_bwd_inputs(gen, case)
        call = lambda: tr.token_rows_attention_bwd_cuda(*args, heads=6, dim_head=64)  # noqa: E731
        out({"kernel": "token_rows_attention_bwd", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call),
             "within": all(g["max_abs_err"] <= g["limit"] for g in row["grads"]),
             "launches_3_calls": _launches(call)})
        del args

    grouped = [((G, L, masked), "", 1) for G, L in ((49, 16), (16, 49))
               for masked in (True, False)]
    grouped += [(edge, "edge ", 0) for edge in GROUPED_EDGES]
    edge_gen = torch.Generator().manual_seed(12)
    for shape, tag, calls in grouped if "grouped_attention" in kernels else ():
        if tag:
            G, L, D, masked = shape
            args, mask = grouped_inputs(edge_gen, G, L, masked, B=2, D=D, edge=True)
        else:
            args, mask = grouped_inputs(gen, *shape)
        row = grouped_row(args, mask, 8, calls, tag)
        call = lambda: ga.fused_grouped_attention_cuda(*args, heads=8)  # noqa: E731
        out({"kernel": "grouped_attention", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call), "within": row["max_abs_err"] <= TOL,
             "launches_3_calls": _launches(call)})
        del args, mask

    for case in CHUNKED_CASES if "chunked_attention" in kernels else ():
        try:
            row = chunked_row(case)
        except (ValueError, RuntimeError) as e:  # a kernel that does not take the shape
            _, G, L, P, B = case[:5]
            out({"kernel": "chunked_attention", "shape": f"{case[0]} B={B} G={G} L={L} P={P}",
                 "refused": str(e)[:200], "within": label != "this"})
            continue
        args, kw = chunked_inputs(case)
        call = lambda: ca.chunked_attention_cuda(*args, **kw)  # noqa: E731
        out({"kernel": "chunked_attention", **row, "digest": _digest(call),
             "within": row["max_abs_err"] <= row["limit"], "launches_3_calls": _launches(call)})
        del args
        torch.cuda.empty_cache()


def _run_tree(root: Path, label: str, kernels) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", label,
                           "--kernels", *kernels],
                          cwd=root, env=env, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} ({root}) failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rows = [json.loads(ln[len(TAG):]) for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
    print(f"{label}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of another checkout to measure in turns")
    ap.add_argument("--out", type=Path, help="write every row here as JSON lines")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the kernels to measure (default: all)")
    ap.add_argument("--same-bits", nargs="+", choices=KERNELS, default=[],
                    help="kernels whose outputs must keep their bits in every turn of both trees")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure, args.kernels)
        return
    order = [("this", ROOT)] if args.other is None else [
        ("other", args.other.resolve()), ("this", ROOT), ("this", ROOT), ("other", args.other.resolve())]
    rows, failed = [], []
    for turn, (label, root) in enumerate(order):
        try:
            rows += [dict(r, turn=turn) for r in _run_tree(root, label, args.kernels)]
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            print(e, flush=True)
            failed.append(turn)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    bad = [r for r in rows if not r["within"] or r.get("bitwise_reruns") is False]
    digests = collections.defaultdict(set)
    for r in rows:
        if r["kernel"] in args.same_bits:
            digests[r["kernel"], r["shape"]].add(r.get("digest"))
    changed = sorted(k for k, d in digests.items() if len(d) > 1)
    for kernel, shape in changed:
        print(f"{kernel} {shape}: other bits in another turn or tree", flush=True)
    for r in rows:
        if "refused" in r:
            print(f"turn {r['turn']} {r['tree']:5s} {r['kernel']:24s} {r['shape']:40s}"
                  f" refused: {r['refused']}")
            continue
        print(f"turn {r['turn']} {r['tree']:5s} {r['kernel']:24s} {r['shape']:40s} ms {r['ms']:.4f}"
              + (f" host_ms {r['host_ms']:.4f}" if "host_ms" in r else "")
              + (f" library_ms {r['library_ms']:.4f}" if r.get("library_ms") else "")
              + (f" cublas_products_ms {r['cublas_products_ms']:.4f}"
                 if "cublas_products_ms" in r else "")
              + ("" if r["within"] else " OFF")
              + (" NOT-BITWISE" if r.get("bitwise_reruns") is False else ""))
        if "launches_3_calls" in r:
            print("    " + "; ".join(f"{n} x{k} {ms:.4f}" for n, k, ms in r["launches_3_calls"]))
    if args.same_bits:
        print(f"same bits in every turn: {len(digests) - len(changed)} of {len(digests)} shapes of"
              f" {', '.join(args.same_bits)}", flush=True)
    if bad or failed or changed:
        raise SystemExit(f"{len(bad)} rows off their limits or not bitwise on reruns;"
                         f" {len(changed)} shapes whose bits changed; turns that failed: {failed}")


if __name__ == "__main__":
    main()
