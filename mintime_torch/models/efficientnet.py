"""EfficientNet feature-map forward (counterpart of
``mintime_tpu/models/efficientnet.py:36-226``).

Stem → 16 MBConv blocks with squeeze-excite (B0) → head conv + BN + swish,
no pooling: a 224 input gives ``(N, 7, 7, 1280)``. The public boundary is
NHWC like the JAX package; inside, the NHWC input is viewed as NCHW, which
leaves it in PyTorch's channels-last memory format, and the convolutions run
through ``torch.nn.functional.conv2d`` (the JAX package has no kernel of its
own here). BatchNorm follows flax (eps 1e-3, momentum 0.99; see
:class:`BatchNorm`), and in train mode residual blocks drop their branch per
sample with rate ``drop_connect_rate * idx / blocks``. Module and key names
are the reference's (``_conv_stem``, ``_blocks.{i}._depthwise_conv``,
…), so ``mintime_tpu.utils.torch_convert.efficientnet_params_to_torch`` and
:func:`mintime_torch.convert.efficientnet_state_dict` give the same dict.

TF-SAME padding: for stride 2 XLA pads more at the bottom and right than at
the top and left; :func:`same_pad` computes those pads for each input size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class BlockArgs:
    repeats: int
    kernel: int
    stride: int
    expand: int
    in_filters: int
    out_filters: int
    se_ratio: float = 0.25


B0_BLOCKS: tuple[BlockArgs, ...] = (
    BlockArgs(1, 3, 1, 1, 32, 16),
    BlockArgs(2, 3, 2, 6, 16, 24),
    BlockArgs(2, 5, 2, 6, 24, 40),
    BlockArgs(3, 3, 2, 6, 40, 80),
    BlockArgs(3, 5, 1, 6, 80, 112),
    BlockArgs(4, 5, 2, 6, 112, 192),
    BlockArgs(1, 3, 1, 6, 192, 320),
)

# (width_coefficient, depth_coefficient, resolution, dropout)
SCALING = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """TF channel rounding."""
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def expand_blocks(variant: str) -> list[BlockArgs]:
    """Apply width/depth scaling; one entry per physical block."""
    width, depth, _, _ = SCALING[variant]
    out = []
    for ba in B0_BLOCKS:
        infilt = round_filters(ba.in_filters, width)
        outfilt = round_filters(ba.out_filters, width)
        for r in range(round_repeats(ba.repeats, depth)):
            out.append(BlockArgs(
                repeats=1, kernel=ba.kernel, stride=ba.stride if r == 0 else 1,
                expand=ba.expand, in_filters=infilt if r == 0 else outfilt,
                out_filters=outfilt, se_ratio=ba.se_ratio,
            ))
    return out


def same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``padding="SAME"`` along one axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d with TF-SAME padding (asymmetric where XLA's is)."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if k == 1 and s == 1:
            return F.conv2d(x, self.weight, self.bias, 1, 0, 1, self.groups)
        top, bottom = same_pad(x.shape[2], k, s)
        left, right = same_pad(x.shape[3], k, s)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, s, (top, left), 1, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, s, 0, 1, self.groups)


class BatchNorm(nn.Module):
    """BatchNorm with the reference's parameter names and flax's semantics
    (``mintime_tpu/models/efficientnet.py:123-130``, ``:191-198``).

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch's mean and biased variance and updates the running
    statistics as ``momentum * running + (1 - momentum) * batch`` with the
    **biased** batch variance, as flax does; torch's ``BatchNorm2d`` would
    fold in the unbiased one (PARITY.md #23). The batch statistics are taken
    in fp32 whatever the input dtype. There is no ``num_batches_tracked``,
    so the reference's key names hold.

    With ``sync_group`` (set by :func:`mintime_torch.parallel.mesh.
    data_parallel`) train mode takes the statistics of the global batch, all
    data ranks' rows, as the JAX mesh does: the sum and count, then the sum
    of squared deviations from the global mean, each all-reduced through
    the differentiable ``torch.distributed.nn.functional.all_reduce``.
    """

    momentum = 0.99
    #: scale and shift stay in the parameters' dtype, as flax's BatchNorm
    keep_param_dtype = True
    #: the process group of the data ranks whose batch statistics are pooled
    sync_group = None

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if self.sync_group is not None:
            return self._synced(x)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2).sub(self.eps).clamp_(min=0.0)
        self._update(mean, var)
        return y

    def _synced(self, x):
        from torch.distributed.nn.functional import all_reduce

        dims = [d for d in range(x.dim()) if d != 1]
        shape = [-1 if d == 1 else 1 for d in range(x.dim())]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_tensor([x.numel() / x.shape[1]])
        sums = all_reduce(torch.cat([xf.sum(dims), count]), group=self.sync_group)
        n = sums[-1]
        mean = sums[:-1] / n
        d = xf - mean.view(shape)
        var = all_reduce((d * d).sum(dims), group=self.sync_group) / n
        y = (d * torch.rsqrt(var + self.eps).view(shape) * self.weight.to(xf.dtype).view(shape)
             + self.bias.to(xf.dtype).view(shape))
        self._update(mean.detach(), var.detach())
        return y.to(x.dtype)

    def _update(self, mean, var):
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean.to(self.running_mean.dtype),
                                                       alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var.to(self.running_var.dtype),
                                                      alpha=1.0 - self.momentum)


@dataclass(frozen=True)
class BatchRows:
    """Drop-connect's draws for one data rank's rows ``first:end`` of a
    global batch of ``total`` videos: the masks are drawn from ``generator``
    for the whole batch (each video's frames together) and the rank's rows
    kept, so that the ranks together draw what one process draws. A batch
    padded with cyclic repeats of its first ``distinct`` rows
    (:func:`mintime_torch.parallel.mesh.pad_rows`) draws for those rows and
    repeats their masks with them. Passed where a ``generator`` goes."""

    generator: torch.Generator
    first: int
    end: int
    total: int
    distinct: int | None = None


def drop_connect(x, rate: float, generator: torch.Generator | BatchRows | None):
    """Per-sample stochastic depth (``efficientnet.py:160-165``): keep each
    sample's branch with probability ``1 - rate`` and scale the kept ones by
    ``1 / (1 - rate)``. The draws come from ``generator`` on the CPU (the
    default generator when None), so one seed gives the same masks on every
    device; a :class:`BatchRows` draws for its global batch."""
    keep = 1.0 - rate
    if isinstance(generator, BatchRows):
        r = generator
        per = x.shape[0] // (r.end - r.first)  # frames a video
        n = (r.distinct or r.total) * per
        rows = torch.arange(r.first * per, r.end * per) % n
        mask = torch.rand(n, generator=r.generator)[rows] < keep
    else:
        mask = torch.rand(x.shape[0], generator=generator) < keep
    return x / keep * mask.to(device=x.device, dtype=x.dtype)[:, None, None, None]


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite."""

    def __init__(self, a: BlockArgs):
        super().__init__()
        self.args = a
        expanded = a.in_filters * a.expand
        if a.expand != 1:
            self._expand_conv = SameConv2d(a.in_filters, expanded, 1, bias=False)
            self._bn0 = BatchNorm(expanded)
        self._depthwise_conv = SameConv2d(expanded, expanded, a.kernel, stride=a.stride,
                                          groups=expanded, bias=False)
        self._bn1 = BatchNorm(expanded)
        se_ch = max(1, int(a.in_filters * a.se_ratio))
        self._se_reduce = SameConv2d(expanded, se_ch, 1)
        self._se_expand = SameConv2d(se_ch, expanded, 1)
        self._project_conv = SameConv2d(expanded, a.out_filters, 1, bias=False)
        self._bn2 = BatchNorm(a.out_filters)

    def forward(self, x, drop_rate: float = 0.0, generator: torch.Generator | None = None):
        a = self.args
        inputs = x
        if a.expand != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        x = torch.sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if a.stride == 1 and a.in_filters == a.out_filters:
            if self.training and drop_rate > 0:
                x = drop_connect(x, drop_rate, generator)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Feature-map EfficientNet: ``(N, H, W, 3)`` → ``(N, h, w, C)``.

    ``drop_connect_rate`` is the JAX package's (``efficientnet.py:176``):
    block ``idx`` of ``n`` drops its residual branch at ``rate * idx / n`` in
    train mode, drawing from the ``generator`` given to :meth:`forward`.

    ``tap_block`` (``efficientnet.py:211-226``, the reference's
    ``extract_features_at_block``): the blocks run up to the first whose index
    exceeds ``tap_block``, and the head conv runs only when ``tap_block`` is
    at least the block count. Blocks and layers that never run are not built,
    as flax creates no parameters for them.
    """

    def __init__(self, variant: str = "efficientnet-b0", drop_connect_rate: float = 0.2,
                 tap_block: int | None = None):
        super().__init__()
        self.drop_connect_rate = drop_connect_rate
        width = SCALING[variant][0]
        stem = round_filters(32, width)
        blocks = expand_blocks(variant)
        self.num_blocks = len(blocks)
        ran = blocks if tap_block is None else blocks[:tap_block + 2]
        self._conv_stem = SameConv2d(3, stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm(stem)
        self._blocks = nn.ModuleList(MBConvBlock(b) for b in ran)
        self.feature_dim = ran[-1].out_filters
        if tap_block is None or tap_block >= self.num_blocks:
            self.feature_dim = round_filters(1280, width)
            self._conv_head = SameConv2d(ran[-1].out_filters, self.feature_dim, 1, bias=False)
            self._bn1 = BatchNorm(self.feature_dim)

    def grid(self, size: int) -> int:
        """Side of the feature map for a ``size`` x ``size`` input: each
        stride-2 SAME convolution maps ``s`` to ``ceil(s / 2)``."""
        for stride in [2] + [b.args.stride for b in self._blocks]:
            size = -(-size // stride)
        return size

    def forward(self, x, generator: torch.Generator | None = None):
        x = x.permute(0, 3, 1, 2)  # NHWC data seen as NCHW: channels-last memory
        x = F.silu(self._bn0(self._conv_stem(x)))
        for idx, block in enumerate(self._blocks):
            x = block(x, self.drop_connect_rate * idx / self.num_blocks, generator)
        if hasattr(self, "_conv_head"):
            x = F.silu(self._bn1(self._conv_head(x)))
        return x.permute(0, 2, 3, 1)
