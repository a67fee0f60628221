"""The arithmetic of the plain reference: float32 with TF32 off, or, for the
control that must fail the comparison, float8 (e4m3, one scale a tensor), the
step below the bfloat16 that the configurations compute in: every product's
operands and result, every norm's output and the residual streams rounded to
float8, where the program stores them in bfloat16, and in the backward the
gradients that flow through those points rounded alike.

Only plain PyTorch; nothing of the program is imported here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: largest finite float8 e4m3 value
FP8_MAX = 448.0


def tf32_off() -> None:
    """Full float32 products on the card: the reference's precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """Float8 rounding of a value and, in the backward, of its gradient."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Numerics:
    """How the reference rounds what it computes: not at all (``"fp32"``), or
    to float8 e4m3 under a per-tensor scale (``"fp8"``), the value and under
    autograd its gradient."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return t
        if t.requires_grad:
            return _RoundFp8.apply(t)
        with torch.no_grad():
            return _fp8(t)

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding, 1, groups))

    def einsum(self, eq: str, a, b):
        return self.q(torch.einsum(eq, self.q(a), self.q(b)))
