"""Grouped attention with a CLS key and value over pre-split q, k, v
(counterpart of ``mintime_tpu/ops/pallas_attention.py``: ``_kernel`` at
``:35-68`` and ``fused_grouped_attention`` at ``:71-112``, the v1 kernel).

Per (b, h, g) and query row ``r``, with q arriving pre-scaled:

    P   = softmax([q_r k_cls | q_r K^T] + bias[b, r])   (fp32 logits, fp32 softmax)
    out = P[1:] V + P[0] v_cls                           (P rounded to v's dtype,
                                                          fp32 sums)

``bias`` (B, L, 1+L) fp32, column 0 the CLS key, is shared over heads and
groups (the JAX kernel's block index ``p // heads``); None means zeros. The
output is in q's dtype.

:func:`fused_grouped_attention` runs :func:`fused_grouped_attention_plain`
for CPU tensors and the kernel ``csrc/grouped_attention.cu`` for CUDA
tensors. The JAX function has no VJP, so neither has the kernel path: it
raises on inputs that require grad instead of dropping their gradient.
"""

from __future__ import annotations

import ctypes

import torch

from mintime_torch.ops import _build
from mintime_torch.ops.divided_attention import mask_to_bias  # noqa: F401  (re-exported)

#: kernel launches since the last reset (one per :func:`fused_grouped_attention_cuda` call)
launches = 0

_KERNEL_MAX_D = 64
_KERNEL_MAX_L = 64


def reset_launches() -> None:
    global launches
    launches = 0


def fused_grouped_attention_plain(q_g, k_g, v_g, k_cls, v_cls, bias, *, heads: int):
    """Plain PyTorch version of the kernel.

    Args:
      q_g, k_g, v_g: (B, H, G, L, D), q pre-scaled.
      k_cls, v_cls: (B, H, 1, D).
      bias: (B, L, 1+L) fp32 additive mask (column 0 the CLS key) or None.
      heads: H (the JAX signature's; the bias is shared over heads).
    Returns (B, H, G, L, D) in q's dtype.
    """
    f32 = torch.float32
    _check_heads(q_g, heads)
    q, k = q_g.to(f32), k_g.to(f32)
    logits = torch.cat([(q * k_cls.to(f32)[:, :, None]).sum(-1, keepdim=True),
                        torch.einsum("bhgld,bhgmd->bhglm", q, k)], dim=-1)
    if bias is not None:
        logits = logits + bias.to(f32)[:, None, None]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = (p / p.sum(dim=-1, keepdim=True)).to(v_g.dtype).to(f32)
    out = torch.einsum("bhglm,bhgmd->bhgld", attn[..., 1:], v_g.to(f32))
    out = out + attn[..., :1] * v_cls.to(f32)[:, :, None]
    return out.to(q_g.dtype)


def _check_heads(q_g, heads):
    if q_g.dim() != 5 or q_g.shape[1] != heads:
        raise ValueError(f"fused_grouped_attention: q {tuple(q_g.shape)} is not (B, {heads}, G, L, D)")


def _check_kernel_args(q_g, k_g, v_g, k_cls, v_cls, bias, heads):
    _check_heads(q_g, heads)
    B, H, G, L, D = q_g.shape
    if k_g.shape != q_g.shape or v_g.shape != q_g.shape \
            or k_cls.shape != (B, H, 1, D) or v_cls.shape != (B, H, 1, D):
        raise ValueError("fused_grouped_attention: q, k, v must be (B, H, G, L, D) and k_cls,"
                         f" v_cls (B, H, 1, D); got {[tuple(t.shape) for t in (q_g, k_g, v_g, k_cls, v_cls)]}")
    if not (1 <= L <= _KERNEL_MAX_L and D % 2 == 0 and 2 <= D <= _KERNEL_MAX_D):
        raise ValueError(f"fused_grouped_attention kernel takes 1 <= L <= {_KERNEL_MAX_L} and even"
                         f" D <= {_KERNEL_MAX_D}, got L={L}, D={D}")
    for name, t in (("q", q_g), ("k", k_g), ("v", v_g), ("k_cls", k_cls), ("v_cls", v_cls)):
        if not t.is_cuda or t.device != q_g.device:
            raise ValueError(f"fused_grouped_attention: {name} is not on the card with q")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"fused_grouped_attention kernel takes bf16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_grouped_attention kernel needs {name} contiguous")
        if t.requires_grad:
            raise ValueError("fused_grouped_attention has no backward (nor has the JAX"
                             f" function): {name} requires grad")
    if bias is not None and (bias.shape != (B, L, 1 + L) or bias.dtype != torch.float32
                             or not bias.is_contiguous() or bias.device != q_g.device):
        raise ValueError("fused_grouped_attention kernel needs bias as contiguous fp32"
                         f" (B, L, 1+L) = {(B, L, 1 + L)} on the card")


def fused_grouped_attention_cuda(q_g, k_g, v_g, k_cls, v_cls, bias, *, heads: int):
    """Launch the CUDA kernel; same arguments and result as
    :func:`fused_grouped_attention_plain`, bf16 only."""
    global launches
    _check_kernel_args(q_g, k_g, v_g, k_cls, v_cls, bias, heads)
    B, H, G, L, D = q_g.shape
    dev = q_g.device
    out = torch.empty_like(q_g)
    fn = _build.load("grouped_attention").grouped_attention_fwd
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 7 + [ctypes.c_int] * 5 + [ptr]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(q_g.data_ptr(), k_g.data_ptr(), v_g.data_ptr(), k_cls.data_ptr(),
                    v_cls.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
                    B, H, G, L, D, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "grouped_attention")
    launches += 1
    return out


def fused_grouped_attention(q_g, k_g, v_g, k_cls, v_cls, bias, *, heads: int):
    """The v1 grouped attention (``pallas_attention.py:71-112``). Same
    arguments and result as :func:`fused_grouped_attention_plain`. CPU
    tensors take the plain version; CUDA tensors take the kernel or raise.
    There is no fallback between the two."""
    fwd = fused_grouped_attention_cuda if q_g.is_cuda else fused_grouped_attention_plain
    return fwd(q_g, k_g, v_g, k_cls, v_cls, bias, heads=heads)
