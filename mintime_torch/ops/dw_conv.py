"""Depthwise convolution at stride 1 with SAME padding: the forward fused
with bias and SiLU, Xception's plain 3 x 3 forward with an optional ReLU
prologue, and the weight gradient (counterparts of the probes
``experiments/dw_conv_pallas_vs_xla.py``: ``dw_kernel`` at ``:24-35`` through
``pallas_dwconv`` at ``:38-59``, and ``experiments/dw_conv_bwd_pallas_vs_xla.py``:
``_flat_kernel`` ``:128-153``, ``_chan_kernel`` ``:188-203`` and
``_roll_kernel`` ``:231-254`` through ``pl_flat_wgrad`` ``:164``,
``pl_chan_wgrad`` ``:206`` and ``pl_roll_wgrad`` ``:257``).

Layouts are the JAX probes': NHWC activations, ``(K, K, C)`` fp32 weights
and ``(C,)`` bias for the forward; the weight gradient is ``(K, K, 1, C)``
fp32 (HWIO with one input channel per group).

    y[n, h, w, c] = silu(Σ_{kh, kw} x_pad[n, h+kh, w+kw, c] · w[kh, kw, c] + b[c])
    dW[kh, kw, 0, c] = Σ_{n, oh, ow} x_pad[n, oh+kh, ow+kw, c] · dy[n, oh, ow, c]

``x_pad`` is x with ``K // 2`` zeros on each side of H and W. Xception's
variant (:func:`dw_conv3x3_cuda`, no TPU counterpart: the JAX package leaves
it to XLA) takes the layout of the model that calls it, ``F.conv2d``'s: x
``(N, C, H, W)`` in channels-last memory and the module's ``(C, 1, 3, 3)``
weights in x's dtype, no bias:

    y[n, c, h, w] = Σ_{kh, kw} relu?(x)_pad[n, c, h+kh, w+kw] · w[c, 0, kh, kw]

The three TPU weight-gradient kernels compute one function in three lane
layouts, so one kernel is their counterpart; ``_roll_kernel`` returns it with
its taps flipped, a fault of that probe (``tests/test_torch_dw_conv.py``
shows it).

The plain versions accumulate in fp32 with the weights in fp32, as the Pallas
kernel does (``xla_dwconv`` casts the weights to x's dtype first). For CUDA
tensors :func:`dw_conv_bias_silu` and :func:`dw_conv_wgrad` launch
``csrc/dw_conv.cu`` and ``csrc/dw_conv_wgrad.cu`` or raise; neither has a
VJP, so the kernel paths raise on inputs that require grad.
:func:`on_kernel` says where Xception's layers take the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mintime_torch.ops import _build

#: forward kernel launches since the last reset (one per :func:`dw_conv_bias_silu_cuda` call)
launches = 0
#: weight-gradient kernel launches since the last reset (one per :func:`dw_conv_wgrad_cuda` call)
wgrad_launches = 0
#: plain 3 x 3 kernel launches since the last reset (one per :func:`dw_conv3x3_cuda` call)
conv3x3_launches = 0

_KERNEL_K = (3, 5)  # the kernel sizes the kernels are instantiated for (EfficientNet's)
_MAX_CT = 64  # channels of a forward block's tile, at most
_MAX_THREADS = 256  # threads of a forward block, at most
_RING_BYTES = 200 * 1024  # the forward's row ring, at most (the card gives a block 227 KB)
_COLS = 7  # output columns a forward thread slides over (R in csrc/dw_conv.cu)


def reset_launches() -> None:
    global launches, wgrad_launches, conv3x3_launches
    launches = wgrad_launches = conv3x3_launches = 0


def load() -> None:
    """Build and load the forward kernels' library now (a model that will
    call them does so when it is built, not in its first call)."""
    _build.load("dw_conv")


def plan(H: int, W: int, C: int, K: int) -> tuple[int, int]:
    """The forward kernel's launch plan, ``(ct, threads)``, for both its
    variants.

    A block owns ``ct`` channels of one image and a ring of K + 1 padded rows
    of them; a thread owns a channel pair and 7 consecutive output columns
    (the last group of a row masked where 7 does not divide W), so a row is
    ``ceil(W / 7) * ct / 2`` items. With one row in flight a block, what
    hides the loads' latency on the card is several blocks an SM (measured
    at Xception's and EfficientNet-B0's shapes, PERF.md §6), so tiles stay
    small. When C is a multiple of 8 (16-byte staging), ``ct`` is the
    divisor of C, a multiple of 8 and at most 64, whose items fill whole
    warps best, the larger on a tie; otherwise C rounded up to even (at most
    64), the last tile masked. ``ct`` halves while the ring would pass
    200 KB. ``threads`` is half the row's items where that fills whole warps
    (two items a thread), else the items rounded up to a warp, at most 256.
    """
    groups = -(-W // _COLS)

    def warps_filled(ct):
        items = groups * ct // 2
        return items / (32 * -(-items // 32))

    if C % 8 == 0:
        ct = max((d for d in range(8, min(C, _MAX_CT) + 1, 8) if C % d == 0),
                 key=lambda d: (warps_filled(d), d))
    else:
        ct = min(_MAX_CT, C + C % 2)
    while ct > 8 and (K + 1) * (groups * _COLS + K - 1) * ct * 2 > _RING_BYTES:
        ct = ct // 2 + (ct // 2) % (8 if C % 8 == 0 else 2)
    items = groups * ct // 2
    threads = items // 2 if items % 64 == 0 else 32 * -(-items // 32)
    return ct, min(_MAX_THREADS, threads)


def _pad(x, K):
    p = K // 2
    return F.pad(x, (0, 0, p, p, p, p))


def dw_conv_bias_silu_plain(x, w, b, *, K: int):
    """Plain PyTorch version of the forward kernel.

    Args:
      x: (N, H, W, C) activations.
      w: (K, K, C) weights (used in fp32).
      b: (C,) bias (used in fp32).
    Returns silu(conv + b), (N, H, W, C) in x's dtype.
    """
    _, H, W, _ = x.shape
    xp = _pad(x.float(), K)
    w = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for kh in range(K):
        for kw in range(K):
            acc += xp[:, kh:kh + H, kw:kw + W] * w[kh, kw]
    y = acc + b.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def dw_conv3x3_plain(x, w, *, relu: bool):
    """Plain PyTorch version of the plain 3 x 3 kernel.

    Args:
      x: (N, C, H, W) activations.
      w: (C, 1, 3, 3) weights (used in fp32).
      relu: apply max(x, 0) first.
    Returns the depthwise conv, (N, C, H, W) in x's dtype.
    """
    H, W = x.shape[2:]
    xf = F.relu(x.float()) if relu else x.float()
    xp = F.pad(xf, (1, 1, 1, 1))
    w = w.float()
    acc = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            acc += xp[:, :, kh:kh + H, kw:kw + W] * w[:, 0, kh, kw, None, None]
    return acc.to(x.dtype)


def dw_conv_wgrad_plain(x, dy, *, K: int):
    """Plain PyTorch version of the weight-gradient kernel: K² shifted
    multiply-reduces in fp32 (the probes' ``xla_shift_wgrad``). ``x``, ``dy``
    (N, H, W, C); returns (K, K, 1, C) fp32."""
    _, H, W, C = x.shape
    xp = _pad(x.float(), K)
    dyf = dy.float()
    taps = [(xp[:, kh:kh + H, kw:kw + W] * dyf).sum(dim=(0, 1, 2))
            for kh in range(K) for kw in range(K)]
    return torch.stack(taps).reshape(K, K, 1, C)


def _check_common(what, x, K, tensors):
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (N, H, W, C), got {tuple(x.shape)}")
    if K not in _KERNEL_K:
        raise ValueError(f"{what} kernel takes an odd K in {_KERNEL_K} (SAME padding of K // 2),"
                         f" got {K}")
    for name, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: {name} is not on the card with x")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs {name} contiguous")
        if t.requires_grad:
            raise ValueError(f"{what} has no backward (nor has the probe): {name} requires grad")


def dw_conv_bias_silu_cuda(x, w, b, *, K: int):
    """Launch the forward kernel; same result as :func:`dw_conv_bias_silu_plain`,
    x in bf16, w and b in fp32."""
    global launches
    _check_common("dw_conv_bias_silu", x, K, (("x", x), ("w", w), ("b", b)))
    N, H, W, C = x.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("dw_conv_bias_silu kernel takes bf16 x and fp32 w and b")
    if w.shape != (K, K, C) or b.shape != (C,):
        raise ValueError(f"dw_conv_bias_silu: w {tuple(w.shape)} / b {tuple(b.shape)} do not"
                         f" match (K, K, C) = {(K, K, C)}")
    out = torch.empty_like(x)
    ct, threads = plan(H, W, C, K)
    fn = _build.load("dw_conv").dw_conv_bias_silu_fwd
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 4 + [ctypes.c_int] * 7 + [ptr]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, W, C, K,
                    ct, threads, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "dw_conv_bias_silu")
    launches += 1
    return out


def dw_conv_wgrad_cuda(x, dy, *, K: int):
    """Launch the weight-gradient kernel (per-block fp32 partials, then a
    second launch that sums them in order: no atomics, so reruns give the
    same bits); same result as :func:`dw_conv_wgrad_plain`, x and dy in bf16."""
    global wgrad_launches
    if dy.shape != x.shape:
        raise ValueError(f"dw_conv_wgrad kernel takes stride 1 (dy shaped as x {tuple(x.shape)}),"
                         f" got dy {tuple(dy.shape)}")
    _check_common("dw_conv_wgrad", x, K, (("x", x), ("dy", dy)))
    if x.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16:
        raise ValueError("dw_conv_wgrad kernel takes bf16 x and dy")
    N, H, W, C = x.shape
    lib = _build.load("dw_conv_wgrad")
    plan = lib.dw_conv_wgrad_chunks
    plan.argtypes = [ctypes.c_int] * 5
    plan.restype = ctypes.c_int
    chunks = plan(N, H, W, C, K)
    if chunks < 1:
        raise ValueError(f"dw_conv_wgrad kernel does not take N={N} H={H} W={W} C={C} K={K}")
    partial = torch.empty((chunks, K, K, C), dtype=torch.float32, device=x.device)
    out = torch.empty((K, K, 1, C), dtype=torch.float32, device=x.device)
    fn = lib.dw_conv_wgrad
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 4 + [ctypes.c_int] * 6 + [ptr]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), out.data_ptr(),
                    N, H, W, C, K, chunks, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "dw_conv_wgrad")
    wgrad_launches += 1
    return out


def _refusal(x, w) -> str | None:
    """Why Xception's depthwise layer (``x`` (N, C, H, W), ``w`` its
    (C, 1, 3, 3) weight) cannot run on the plain 3 x 3 kernel, or None
    where it can: on the card, bf16, x in channels-last memory, the weight
    dense as (C, 9) (a module's is, in either memory format), no gradient
    wanted (the kernel has no backward) and a shape the shape rule admits.
    The rule: alone on the card at 1,536 images the kernel (with the ReLU it
    absorbs) beat cuDNN (plus the ReLU's pass) at every depthwise shape of
    Xception at 224 px, 7 to 109 columns and 64 to 1,536 channels (PERF.md
    §6). Narrower maps, whose 7-column groups are mostly masked, and channel
    counts that 16-byte copies cannot stage were not measured."""
    if x.dim() != 4 or w.dim() != 4:
        return f"x {tuple(x.shape)} and w {tuple(w.shape)} must be (N, C, H, W) and (C, 1, 3, 3)"
    N, C, H, W = x.shape
    if w.shape != (C, 1, 3, 3):
        return f"w {tuple(w.shape)} is not {(C, 1, 3, 3)}"
    if W < _COLS or C % 8:
        return f"the shape rule keeps W={W} C={C} on cuDNN (it takes W >= {_COLS}, C % 8 == 0)"
    if N > 65535:
        return f"N={N} passes the grid's 65,535 images"
    if not x.is_cuda or w.device != x.device:
        return "x and w are not on the card together"
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return f"the kernel takes bf16 x and w, got {x.dtype} and {w.dtype}"
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return "the kernel has no backward: x or w requires grad"
    if not x.is_contiguous(memory_format=torch.channels_last):
        return "the kernel needs x in channels-last memory"
    if w.stride()[0::2] != (9, 3) or w.stride(3) != 1:
        return f"w strides {w.stride()} are not those of a dense (C, 1, 3, 3)"
    return None


def on_kernel(x, w) -> bool:
    """Whether Xception's depthwise layer runs on :func:`dw_conv3x3_cuda`
    (see :func:`_refusal`); otherwise the module's own ``F.conv2d`` (cuDNN
    on the card)."""
    return _refusal(x, w) is None


def dw_conv3x3_cuda(x, w, *, relu: bool):
    """Launch the plain 3 x 3 kernel; same result as :func:`dw_conv3x3_plain`,
    x bf16 (N, C, H, W) in channels-last memory, w bf16 (C, 1, 3, 3). Raises
    where :func:`on_kernel` is false."""
    global conv3x3_launches
    why = _refusal(x, w)
    if why is not None:
        raise ValueError(f"dw_conv3x3: {why}")
    N, C, H, W = x.shape
    out = torch.empty_like(x)
    ct, threads = plan(H, W, C, 3)
    fn = _build.load("dw_conv").dw_conv3x3_fwd
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 3 + [ctypes.c_int] * 7 + [ptr]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, int(relu), ct,
                    threads, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "dw_conv3x3")
    conv3x3_launches += 1
    return out


def dw_conv_bias_silu(x, w, b, *, K: int):
    """Depthwise conv (stride 1, SAME) + bias + SiLU, NHWC. CPU tensors take
    the plain version; CUDA tensors take the kernel or raise."""
    fwd = dw_conv_bias_silu_cuda if x.is_cuda else dw_conv_bias_silu_plain
    return fwd(x, w, b, K=K)


def dw_conv_wgrad(x, dy, *, K: int):
    """Weight gradient of the stride-1 SAME depthwise conv, (K, K, 1, C) fp32.
    CPU tensors take the plain version; CUDA tensors take the kernel or raise."""
    fn = dw_conv_wgrad_cuda if x.is_cuda else dw_conv_wgrad_plain
    return fn(x, dy, K=K)

