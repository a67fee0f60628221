"""Xception feature-map forward, the MINTIME-XC backbone (counterpart of
``mintime_tpu/models/xception.py:23-147``).

The reference's SenseTime Xception whose ``forward`` returns the final
**pre-ReLU 2048-channel map**: 7 x 7 for a 224 input. Entry convolutions are
VALID, separable convolutions pad 1, and each strided block ends in a 3 x 3 /
2 max-pool padded by 1 (torch's implicit -inf padding). BatchNorm follows
flax with eps 1e-5 and momentum 0.9 (torch's 0.1). Module and key names are
the reference's (``conv1``, ``bn1``, ``block{i}.rep.{j}``, ``.skip``,
``.skipbn``, ``conv3.conv1``, ``conv3.pointwise``, …), the ones
``mintime_tpu.utils.torch_convert.xception_params_to_torch`` and
:func:`mintime_torch.convert.xception_state_dict` emit. The public boundary
is NHWC like the JAX package's. The convolutions run through cuDNN (the JAX
package has no kernel of its own here), except the depthwise 3 x 3 of each
separable convolution: with ``use_kernels``, in inference on the card, it
takes the port's kernel (:func:`mintime_torch.ops.dw_conv.on_kernel` says
where) with the ReLU in front of it as its prologue. The ``nn.ReLU`` of a
block's ``rep`` and the one before ``conv4`` are applied by the separable
convolution that follows them, 32 of the 34. The flows are the spans
``xception.entry``, ``xception.middle`` and ``xception.exit``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from mintime_torch.models.efficientnet import BatchNorm
from mintime_torch.ops import dw_conv
from mintime_torch.utils import profiling
from mintime_torch.utils.profiling import span


class XceptionBatchNorm(BatchNorm):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` under torch's names."""

    momentum = 0.9

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)


class SeparableConv(nn.Module):
    """Depthwise 3 x 3 (``conv1``) then pointwise 1 x 1, both bias-free.
    ``use_kernels`` lets the depthwise layer take the port's kernel where
    :func:`mintime_torch.ops.dw_conv.on_kernel` admits the call."""

    def __init__(self, cin: int, cout: int, use_kernels: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, 1, 1, groups=cin, bias=False)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False)
        self.use_kernels = use_kernels

    def forward(self, x, relu: bool = False):
        """``relu``: apply the ReLU in front of the layer first (the kernel's
        prologue where the depthwise layer takes the kernel)."""
        if self.use_kernels and dw_conv.on_kernel(x, self.conv1.weight):
            x = dw_conv.dw_conv3x3_cuda(x, self.conv1.weight, relu=relu)
        else:
            x = self.conv1(F.relu(x) if relu else x)
        return self.pointwise(x)


class XceptionBlock(nn.Module):
    """Residual block of separable convolutions; ``rep`` is the reference's
    Sequential ``[relu?] sep bn (relu sep bn)* [maxpool]``."""

    def __init__(self, cin: int, cout: int, reps: int, stride: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True,
                 use_kernels: bool = False):
        super().__init__()
        if grow_first:
            chans = [(cin, cout)] + [(cout, cout)] * (reps - 1)
        else:
            chans = [(cin, cin)] * (reps - 1) + [(cin, cout)]
        rep: list[nn.Module] = []
        for a, b in chans:
            rep += [nn.ReLU(), SeparableConv(a, b, use_kernels), XceptionBatchNorm(b)]
        if not start_with_relu:
            rep = rep[1:]
        if stride != 1:
            rep.append(nn.MaxPool2d(3, stride, 1))
        self.rep = nn.Sequential(*rep)
        # each ReLU of the rep is followed by a separable conv, whose prologue it becomes
        self._relu_first = tuple(i > 0 and isinstance(rep[i - 1], nn.ReLU) for i in range(len(rep)))
        if cout != cin or stride != 1:
            self.skip = nn.Conv2d(cin, cout, 1, stride=stride, bias=False)
            self.skipbn = XceptionBatchNorm(cout)

    def forward(self, x):
        skip = self.skipbn(self.skip(x)) if hasattr(self, "skip") else x
        for m, relu in zip(self.rep, self._relu_first):
            if isinstance(m, SeparableConv):
                x = m(x, relu=relu)
            elif not isinstance(m, nn.ReLU):
                x = m(x)
        return x + skip


#: (in, out, reps, stride, start_with_relu, grow_first), the reference's blocks 1-12
BLOCK_SPECS: tuple[tuple, ...] = (
    (64, 128, 2, 2, False, True),
    (128, 256, 2, 2, True, True),
    (256, 728, 2, 2, True, True),
    *[(728, 728, 3, 1, True, True)] * 8,
    (728, 1024, 2, 2, True, False),
)
#: blocks 1-3 are the entry flow, 4-11 the middle, 12 opens the exit
ENTRY_BLOCKS = 3


class Xception(nn.Module):
    """Feature-map Xception: ``(N, H, W, 3)`` → ``(N, h, w, 2048)``, pre-ReLU.
    ``use_kernels`` puts the depthwise layers on the port's kernel where it
    takes them (:class:`SeparableConv`)."""

    feature_dim = 2048

    def __init__(self, use_kernels: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3, 2, 0, bias=False)
        self.bn1 = XceptionBatchNorm(32)
        self.conv2 = nn.Conv2d(32, 64, 3, bias=False)
        self.bn2 = XceptionBatchNorm(64)
        for i, spec in enumerate(BLOCK_SPECS):
            setattr(self, f"block{i + 1}", XceptionBlock(*spec, use_kernels=use_kernels))
        self.conv3 = SeparableConv(1024, 1536, use_kernels)
        self.bn3 = XceptionBatchNorm(1536)
        self.conv4 = SeparableConv(1536, 2048, use_kernels)
        self.bn4 = XceptionBatchNorm(2048)

    def forward(self, x, generator=None):
        """``generator`` is accepted for the classifier's call and unused
        (Xception has no drop-connect)."""
        x = x.permute(0, 3, 1, 2)  # NHWC data seen as NCHW: channels-last memory
        with span(profiling.XCEPTION_ENTRY):
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.relu(self.bn2(self.conv2(x)))
            for i in range(ENTRY_BLOCKS):
                x = getattr(self, f"block{i + 1}")(x)
        with span(profiling.XCEPTION_MIDDLE):
            for i in range(ENTRY_BLOCKS, len(BLOCK_SPECS) - 1):
                x = getattr(self, f"block{i + 1}")(x)
        with span(profiling.XCEPTION_EXIT):
            x = getattr(self, f"block{len(BLOCK_SPECS)}")(x)
            x = self.bn3(self.conv3(x))
            x = self.bn4(self.conv4(x, relu=True))
        return x.permute(0, 2, 3, 1)
