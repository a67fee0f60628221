"""Fused GEGLU feed-forward (counterpart of ``mintime_tpu/ops/pallas_ffn.py``:
``geglu_ffn`` at ``:229-247``, ``_fwd_kernel`` at ``:57-74``, ``_bwd_kernel``
at ``:77-129`` and the ``custom_vjp`` at ``:205-226``).

``out = (val * gelu_erf(gate)) @ w1.T + b1`` with ``[val | gate] = x @ w0.T
+ b0``. Weights are in PyTorch's Linear layout: ``w0 (2H, D)``, ``w1 (D, H)``.

:func:`geglu_ffn` is differentiable through :class:`GegluFFNFunction`. For
CUDA tensors its forward runs the kernel ``csrc/geglu_ffn.cu`` and its
backward ``csrc/geglu_ffn_bwd.cu``; for CPU tensors they run
:func:`geglu_ffn_plain` and :func:`geglu_ffn_bwd_plain`. The plain versions
repeat the kernels' arithmetic: fp32 accumulation, the up-projection rounded
to the input dtype before the gate math, gate math in fp32, the product (and
in the backward ``dh``) rounded again before the next product, weight and
bias gradients accumulated in fp32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mintime_torch.ops import _build

#: forward kernel launches since the last reset (one per :func:`geglu_ffn_cuda` call,
#: whatever number of CUDA launches its plan runs)
launches = 0
#: backward kernel launches since the last reset (one per :func:`geglu_ffn_bwd_cuda` call)
bwd_launches = 0

_KERNEL_DIMS = (256, 512)  # the model widths the kernels are instantiated for
_KERNEL_CHUNK = 64
_FWD_ROWS = 128  # rows of a forward block's tile, both launches: two warpgroups of 64
_FWD_K = 64  # k depth of a forward ring stage; split slices are whole stages
_UP_COLS = (64, 8, 4)  # hidden columns (val and gate each) of a launch-A block, widest first
_DOWN_COLS = (128, 16)  # output columns of a launch-B block, widest first
_BWD_ROWS = 128  # rows per block of the backward's dh kernel (its column-sum tiles)
_TILE = 128  # output tile of the backward's products, rows and columns
_TILE_K = 32  # k depth of a product's stage; split slices are whole stages


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def geglu_ffn_plain(x, w0, b0, w1, b1):
    """Plain PyTorch version of the fused FFN (any device, any float dtype)."""
    f32 = torch.float32
    h = (x.to(f32) @ w0.to(f32).T + b0.to(f32)).to(x.dtype)
    val, gate = h.to(f32).chunk(2, dim=-1)
    prod = (val * F.gelu(gate)).to(x.dtype)
    return (prod.to(f32) @ w1.to(f32).T + b1.to(f32)).to(x.dtype)


def _dgelu(z):
    """Derivative of the exact (erf) GELU (``pallas_ffn.py:51-54``)."""
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    return cdf + z * torch.exp(-0.5 * z * z) * 0.3989422804014327


def geglu_ffn_bwd_plain(x, w0, b0, w1, dout):
    """Plain PyTorch version of the backward kernel.

    Returns ``(dx, dw0, db0, dw1, db1)``: ``dx`` in x's shape and dtype, the
    weight and bias gradients in fp32 in the weights' layout.
    """
    f32, dt = torch.float32, x.dtype
    x2 = x.reshape(-1, x.shape[-1]).to(f32)
    d2 = dout.reshape(-1, x.shape[-1]).to(dt).to(f32)
    h = (x2 @ w0.to(f32).T + b0.to(f32)).to(dt).to(f32)
    val, gate = h.chunk(2, dim=-1)
    g = F.gelu(gate)
    prod = (val * g).to(dt).to(f32)
    dprod = d2 @ w1.to(f32)
    dh = torch.cat([dprod * g, dprod * val * _dgelu(gate)], dim=-1).to(dt).to(f32)
    dx = (dh @ w0.to(f32)).to(dt).reshape(x.shape)
    return dx, dh.T @ x2, dh.sum(0), d2.T @ prod, d2.sum(0)


def fwd_plan(m: int, dim: int, hidden: int, sms: int) -> dict:
    """How the forward's launches tile an (m, dim) input with hidden width
    ``hidden`` on a card of ``sms`` SMs. Both launches take row tiles of
    ``rows``. Launch A (x W0^T, then the gate) gives a block ``up`` hidden
    columns, val and gate each; launch B (prod W1^T) gives a block ``down``
    output columns and splits k = hidden into ``slices`` of ``k_chunk`` (the
    last one shorter), whose fp32 partials an ordered reduce adds. Each takes
    its widest tile whose blocks still give every SM one, else its narrowest;
    launch B then splits k until it has a block an SM, where the stages
    allow. ``prod`` and ``partial`` are the scratch the wrapper allocates, in
    elements (bf16 and fp32); ``launches`` the kernels a call runs."""
    tiles = -(-m // _FWD_ROWS)
    up = next((c for c in _UP_COLS if tiles * (hidden // c) >= sms), _UP_COLS[-1])
    down = next((c for c in _DOWN_COLS if tiles * (dim // c) >= sms), _DOWN_COLS[-1])
    out_tiles = tiles * (dim // down)
    stages = hidden // _FWD_K
    per_slice = stages if out_tiles >= sms else max(1, stages // -(-sms // out_tiles))
    slices = -(-stages // per_slice)
    return {"rows": _FWD_ROWS, "up": up, "up_blocks": tiles * (hidden // up), "down": down,
            "slices": slices, "k_chunk": per_slice * _FWD_K, "down_blocks": out_tiles * slices,
            "prod": m * hidden, "partial": slices * m * dim if slices > 1 else 0,
            "launches": 2 if slices == 1 else 3}


def _split(rows: int, cols: int, k: int, sms: int) -> tuple[int, int]:
    """(slices, slice length) for one product with a ``rows x cols`` output
    reduced over ``k``: one slice while its 128 x 128 tiles alone give every
    SM a block, else as many as keep its blocks within one wave of two
    blocks an SM (a second, part-filled wave would leave SMs idle), in
    slices of whole 32-deep stages, none empty."""
    tiles = -(-rows // _TILE) * -(-cols // _TILE)
    if tiles >= sms or k <= _TILE_K:
        return 1, k
    s = min(max(1, 2 * sms // tiles), -(-k // _TILE_K))
    chunk = _TILE_K * -(-(-(-k // s)) // _TILE_K)
    return -(-k // chunk), chunk


def product_splits(m: int, dim: int, hidden: int, sms: int) -> dict[str, tuple[int, int]]:
    """How the backward's three products split their reductions:
    ``{"dw0": (S, chunk), "dw1": ..., "dx": ...}``. dW0 = dh^T x (2H x D) and
    dW1 = dout^T prod (D x H) reduce over the M rows, dx = dh W0 (M x D)
    over 2H; slice s covers ``[s * chunk, min(K, (s + 1) * chunk))``. Each
    product with S > 1 needs ``S * its output`` fp32 scratch
    (:func:`split_scratch`)."""
    return {"dw0": _split(2 * hidden, dim, m, sms), "dw1": _split(dim, hidden, m, sms),
            "dx": _split(m, dim, 2 * hidden, sms)}


def split_scratch(m: int, dim: int, hidden: int, splits: dict) -> dict[str, int]:
    """fp32 elements of each product's split-K partials (0 when S = 1)."""
    out = {"dw0": 2 * hidden * dim, "dw1": dim * hidden, "dx": m * dim}
    return {k: (splits[k][0] * n if splits[k][0] > 1 else 0) for k, n in out.items()}


def _check_kernel_args(x2, w0, b0, w1, b1=None, dout=None):
    dim = x2.shape[-1]
    hidden = w1.shape[1]
    named = {"x": x2, "w0": w0, "b0": b0, "w1": w1, "b1": b1, "dout": dout}
    for name, t in named.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"geglu_ffn: {name} is not on the card with x")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"geglu_ffn kernel takes bf16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"geglu_ffn kernel needs a contiguous {name}")
        if t.data_ptr() % 32:
            raise ValueError(f"geglu_ffn kernel needs {name} aligned to 32 bytes")
    if dim not in _KERNEL_DIMS:
        raise ValueError(f"geglu_ffn kernel is built for widths {_KERNEL_DIMS}, got {dim}")
    if hidden % _KERNEL_CHUNK:
        raise ValueError(f"geglu_ffn kernel needs hidden % {_KERNEL_CHUNK} == 0, got {hidden}")
    shapes = {"w0": (2 * hidden, dim), "b0": (2 * hidden,), "w1": (dim, hidden), "b1": (dim,),
              "dout": tuple(x2.shape)}
    if any(named[k] is not None and tuple(named[k].shape) != v for k, v in shapes.items()):
        got = {k: tuple(t.shape) for k, t in named.items() if t is not None}
        raise ValueError(f"geglu_ffn: inconsistent shapes {got} for width {dim}")


def fwd_scratch(x2, hidden: int, plan: dict):
    """The forward's scratch for ``x2 (M, D)`` under ``plan``: prod (M, H) in
    x's dtype and, with split slices, the fp32 partials (S, M, D), else None."""
    m, dim = x2.shape
    prod = torch.empty((m, hidden), dtype=x2.dtype, device=x2.device)
    partial = (torch.empty((plan["slices"], m, dim), dtype=torch.float32, device=x2.device)
               if plan["slices"] > 1 else None)
    return prod, partial


def _fwd_launch(x2, w0, b0, w1, b1):
    """Run the forward's launches on ``x2 (M, D)``, M > 0; returns ``(out,
    prod)``, prod being launch A's product (the card tests check it alone)."""
    m, dim = x2.shape
    hidden = w1.shape[1]
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    plan = fwd_plan(m, dim, hidden, sms)
    out = torch.empty_like(x2)
    prod, partial = fwd_scratch(x2, hidden, plan)
    lib = _build.load("geglu_ffn")
    fn = lib.geglu_ffn_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        status = fn(x2.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    out.data_ptr(), prod.data_ptr(),
                    None if partial is None else partial.data_ptr(), m, dim, hidden, plan["up"],
                    plan["down"], plan["slices"], plan["k_chunk"], stream)
    _build.check(status, "geglu_ffn")
    return out, prod


def geglu_ffn_cuda(x, w0, b0, w1, b1):
    """Launch the CUDA kernels on ``x (..., D)`` bf16, D = 256 or 512 (two or
    three launches, :func:`fwd_plan`); returns a new tensor."""
    global launches
    x2 = x.reshape(-1, x.shape[-1])
    _check_kernel_args(x2, w0, b0, w1, b1)
    if x2.shape[0] == 0:
        return torch.empty_like(x2).reshape(x.shape)
    out, _ = _fwd_launch(x2, w0, b0, w1, b1)
    launches += 1
    return out.reshape(x.shape)


def geglu_ffn_bwd_cuda(x, w0, b0, w1, dout):
    """Launch the backward kernels; same results as :func:`geglu_ffn_bwd_plain`.

    Scratch it allocates: ``dh (M, 2H)`` and ``prod (M, H)`` in bf16, the
    per-row-tile column sums of ``dh`` and ``dout`` and the split products'
    partials (:func:`product_splits`) in fp32.
    """
    global bwd_launches
    x2 = x.reshape(-1, x.shape[-1])
    d2 = dout.reshape(-1, x.shape[-1]).to(x.dtype).contiguous()
    if d2.data_ptr() % 32:  # a view into a larger gradient
        d2 = d2.clone()
    _check_kernel_args(x2, w0, b0, w1, dout=d2)
    m, dim = x2.shape
    hidden = w1.shape[1]
    dev, f32 = x.device, torch.float32
    dx = torch.empty_like(x2)
    dw0 = torch.empty((2 * hidden, dim), dtype=f32, device=dev)
    db0 = torch.empty(2 * hidden, dtype=f32, device=dev)
    dw1 = torch.empty((dim, hidden), dtype=f32, device=dev)
    db1 = torch.empty(dim, dtype=f32, device=dev)
    if m == 0:
        return dx.reshape(x.shape), dw0.zero_(), db0.zero_(), dw1.zero_(), db1.zero_()
    tiles = -(-m // _BWD_ROWS)
    dh = torch.empty((m, 2 * hidden), dtype=x.dtype, device=dev)
    prod = torch.empty((m, hidden), dtype=x.dtype, device=dev)
    db0_part = torch.empty((tiles, 2 * hidden), dtype=f32, device=dev)
    db1_part = torch.empty((tiles, dim), dtype=f32, device=dev)
    splits = product_splits(m, dim, hidden,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
    parts = {k: torch.empty(n, dtype=f32, device=dev) if n else None
             for k, n in split_scratch(m, dim, hidden, splits).items()}
    lib = _build.load("geglu_ffn_bwd")
    fn = lib.geglu_ffn_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        status = fn(x2.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), d2.data_ptr(),
                    dx.data_ptr(), dw0.data_ptr(), db0.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                    dh.data_ptr(), prod.data_ptr(), db0_part.data_ptr(), db1_part.data_ptr(),
                    ptr(parts["dx"]), ptr(parts["dw0"]), ptr(parts["dw1"]), m, dim, hidden,
                    *splits["dx"], *splits["dw0"], *splits["dw1"],
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "geglu_ffn_bwd")
    bwd_launches += 1
    return dx.reshape(x.shape), dw0, db0, dw1, db1


class GegluFFNFunction(torch.autograd.Function):
    """The fused FFN with its fused backward (the ``custom_vjp`` of
    ``pallas_ffn.py:205-226``): kernels for CUDA tensors, plain versions for
    CPU tensors. Gradients come back in their inputs' dtypes, so bf16
    weights cast from fp32 masters pass their gradient through bf16 as in
    the JAX package."""

    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        ctx.save_for_backward(x, w0, b0, w1)
        ctx.b1_dtype = b1.dtype
        if x.is_cuda:
            return geglu_ffn_cuda(x, w0, b0, w1, b1)
        return geglu_ffn_plain(x, w0, b0, w1, b1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        x, w0, b0, w1 = ctx.saved_tensors
        bwd = geglu_ffn_bwd_cuda if x.is_cuda else geglu_ffn_bwd_plain
        dx, dw0, db0, dw1, db1 = bwd(x, w0, b0, w1, dout)
        return dx, dw0.to(w0.dtype), db0.to(b0.dtype), dw1.to(w1.dtype), db1.to(ctx.b1_dtype)


def geglu_ffn(x, w0, b0, w1, b1):
    """Fused GEGLU FFN over the last axis of ``x`` (any leading shape),
    differentiable.

    CPU tensors take the plain versions; CUDA tensors take the kernels or
    raise. There is no fallback between the two.
    """
    return GegluFFNFunction.apply(x, w0, b0, w1, b1)
