"""SlowFast R-50 video classifier (counterpart of
``mintime_tpu/models/slowfast.py``).

The reference loads this model whole from torch.hub (pytorchvideo's
``slowfast_r50`` with its head replaced by ``Linear(2304, 1)``); the JAX
package builds the same network in Flax. This module builds it in PyTorch
under pytorchvideo's key names, the ones
``mintime_tpu.utils.torch_convert.slowfast_params_from_torch`` reads:

* ``blocks.0.multipathway_blocks.{0,1}.{conv,norm}``: the slow and fast stems
  (then a ``(1, 3, 3)`` max-pool, stride ``(1, 2, 2)``);
* ``blocks.{1..4}.multipathway_blocks.{p}.res_blocks.{j}``: bottlenecks with
  ``branch2.{conv,norm}_{a,b,c}`` and, in each stage's first block,
  ``branch1_{conv,norm}``; the slow pathway's ``conv_a`` is temporal
  (``(3, 1, 1)``) only in res4 and res5, the fast one's in every stage;
* ``blocks.{0..3}.multipathway_fusion.{conv_fast_to_slow,norm}``: fast → slow
  lateral fusion, a ``(7, 1, 1)`` convolution with stride ``(4, 1, 1)`` to
  twice the fast channels, concatenated onto slow;
* ``blocks.5.proj``: the head, ``Linear(2304, num_classes)`` over both
  pathways' global means.

Every convolution pads ``k // 2`` on each side of each axis, as the JAX
package's ``ConvBn3d``. BatchNorm is flax's (momentum 0.9, eps 1e-5, the
running variance fed the biased batch variance): :class:`BatchNorm3d`. The
convolutions are cuDNN's (``F.conv3d``): the JAX package computes them with
``nn.Conv``, outside any Pallas kernel.

Tensors inside the network are ``(N, C, T, H, W)``; :class:`SlowFastR50`
takes the JAX package's ``(N, T, H, W, C)`` and views it as NCTHW, which on
the card leaves it in ``channels_last_3d`` memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mintime_torch.device import resolve_device
from mintime_torch.models.classifier import CastModel
from mintime_torch.models.efficientnet import BatchNorm

ALPHA = 4  # fast/slow frame-rate ratio
BETA_INV = 8  # slow/fast channel ratio

#: (blocks, slow_inner, slow_out, fast_inner, fast_out, slow_temporal) of res2..res5
STAGES = (
    (3, 64, 256, 8, 32, 1),
    (4, 128, 512, 16, 64, 1),
    (6, 256, 1024, 32, 128, 3),
    (3, 512, 2048, 64, 256, 3),
)


class BatchNorm3d(BatchNorm):
    """Flax's BatchNorm as the JAX SlowFast sets it: momentum 0.9, eps 1e-5
    (the biased batch variance, fp32 statistics and parameters as in
    :class:`~mintime_torch.models.efficientnet.BatchNorm`)."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps)


def conv3d(cin: int, cout: int, kernel: tuple, stride: tuple = (1, 1, 1)) -> nn.Conv3d:
    """A bias-free 3-D convolution padded ``k // 2`` on each side of each axis."""
    return nn.Conv3d(cin, cout, kernel, stride, padding=tuple(k // 2 for k in kernel),
                     bias=False)


def conv_bn(x, conv: nn.Conv3d, norm: BatchNorm3d, relu: bool = True):
    x = norm(conv(x))
    return F.relu(x) if relu else x


class ConvBn3d(nn.Module):
    """Convolution, BatchNorm and ReLU under the stem's names ``conv`` and
    ``norm``; :meth:`forward` adds the stem's max-pool with ``pool``."""

    def __init__(self, cin: int, cout: int, kernel: tuple, stride: tuple = (1, 1, 1),
                 pool: bool = False):
        super().__init__()
        self.conv = conv3d(cin, cout, kernel, stride)
        self.norm = BatchNorm3d(cout)
        self.pool = pool

    def forward(self, x):
        x = conv_bn(x, self.conv, self.norm)
        if self.pool:  # pads with -inf, as flax's max_pool
            x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        return x


class BottleneckBranch(nn.Module):
    """``(t, 1, 1)`` → ``(1, 3, 3)`` (spatial stride) → ``(1, 1, 1)``."""

    def __init__(self, cin: int, inner: int, cout: int, temporal_a: int, spatial_stride: int):
        super().__init__()
        self.conv_a = conv3d(cin, inner, (temporal_a, 1, 1))
        self.norm_a = BatchNorm3d(inner)
        self.conv_b = conv3d(inner, inner, (1, 3, 3), (1, spatial_stride, spatial_stride))
        self.norm_b = BatchNorm3d(inner)
        self.conv_c = conv3d(inner, cout, (1, 1, 1))
        self.norm_c = BatchNorm3d(cout)

    def forward(self, x):
        x = conv_bn(x, self.conv_a, self.norm_a)
        x = conv_bn(x, self.conv_b, self.norm_b)
        return conv_bn(x, self.conv_c, self.norm_c, relu=False)


class Bottleneck3d(nn.Module):
    """A residual bottleneck (``mintime_tpu/models/slowfast.py:62-88``): the
    ``branch2`` bottleneck plus the input, or plus a ``(1, 1, 1)``
    convolution of it (``branch1``) where the width or the stride changes."""

    def __init__(self, cin: int, inner: int, cout: int, temporal_a: int,
                 spatial_stride: int = 1):
        super().__init__()
        if cin != cout or spatial_stride != 1:
            self.branch1_conv = conv3d(cin, cout, (1, 1, 1),
                                       (1, spatial_stride, spatial_stride))
            self.branch1_norm = BatchNorm3d(cout)
        self.branch2 = BottleneckBranch(cin, inner, cout, temporal_a, spatial_stride)

    def forward(self, x):
        y = self.branch2(x)
        if hasattr(self, "branch1_conv"):
            x = conv_bn(x, self.branch1_conv, self.branch1_norm, relu=False)
        return F.relu(y + x)


class ResStage3d(nn.Module):
    """``blocks`` bottlenecks; the first takes the stage's spatial stride."""

    def __init__(self, blocks: int, cin: int, inner: int, cout: int, temporal_a: int,
                 spatial_stride: int):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            Bottleneck3d(cin if j == 0 else cout, inner, cout, temporal_a,
                         spatial_stride if j == 0 else 1) for j in range(blocks))

    def forward(self, x):
        for block in self.res_blocks:
            x = block(x)
        return x


class LateralFusion(nn.Module):
    """fast → conv ``(7, 1, 1)``, stride ``(ALPHA, 1, 1)``, to twice its
    channels, BatchNorm and ReLU, concatenated onto slow along the channels."""

    def __init__(self, fast_channels: int):
        super().__init__()
        self.conv_fast_to_slow = conv3d(fast_channels, 2 * fast_channels, (7, 1, 1),
                                        (ALPHA, 1, 1))
        self.norm = BatchNorm3d(2 * fast_channels)

    def forward(self, slow, fast):
        return torch.cat([slow, conv_bn(fast, self.conv_fast_to_slow, self.norm)], dim=1)


class MultiPathway(nn.Module):
    """One block of both pathways (``multipathway_blocks``: slow, fast) and
    the lateral fusion after it (``multipathway_fusion``), if any."""

    def __init__(self, slow: nn.Module, fast: nn.Module, fusion: LateralFusion | None):
        super().__init__()
        self.multipathway_blocks = nn.ModuleList([slow, fast])
        if fusion is not None:
            self.multipathway_fusion = fusion

    def forward(self, slow, fast):
        slow, fast = self.multipathway_blocks[0](slow), self.multipathway_blocks[1](fast)
        if hasattr(self, "multipathway_fusion"):
            slow = self.multipathway_fusion(slow, fast)
        return slow, fast


class Head(nn.Module):
    """``proj``: both pathways' global means, concatenated, to the logits."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.proj = nn.Linear(2048 + 256, num_classes)

    def forward(self, slow, fast):
        x = torch.cat([slow.mean(dim=(2, 3, 4)), fast.mean(dim=(2, 3, 4))], dim=1)
        return self.proj(x)


class SlowFastR50(nn.ModuleList):
    """``(slow (N, T/ALPHA, H, W, 3), fast (N, T, H, W, 3))`` → logits
    ``(N, num_classes)`` fp32; the six ``blocks`` of pytorchvideo's net."""

    def __init__(self, num_classes: int = 1):
        fast_stem = 64 // BETA_INV
        blocks = [MultiPathway(ConvBn3d(3, 64, (1, 7, 7), (1, 2, 2), pool=True),
                               ConvBn3d(3, fast_stem, (5, 7, 7), (1, 2, 2), pool=True),
                               LateralFusion(fast_stem))]
        slow_in, fast_in = 64 + 2 * fast_stem, fast_stem
        for idx, (n, s_inner, s_out, f_inner, f_out, s_t) in enumerate(STAGES):
            stride = 1 if idx == 0 else 2
            blocks.append(MultiPathway(
                ResStage3d(n, slow_in, s_inner, s_out, s_t, stride),
                ResStage3d(n, fast_in, f_inner, f_out, 3, stride),
                LateralFusion(f_out) if idx < 3 else None))
            slow_in, fast_in = s_out + (2 * f_out if idx < 3 else 0), f_out
        blocks.append(Head(num_classes))
        super().__init__(blocks)

    def forward(self, slow, fast):
        s, f = slow.permute(0, 4, 1, 2, 3), fast.permute(0, 4, 1, 2, 3)
        for i in range(len(self) - 1):
            s, f = self[i](s, f)
        return self[len(self) - 1](s, f).float()


def temporal_index(frames: int, num: int):
    """``jnp.linspace(0, frames - 1, num).astype(int32)``, the JAX front
    end's frame index, on the host: the same float32 formula
    (``start * (1 - i / div) + stop * i / div``, the stop appended), then
    truncated, as pytorchvideo's ``.long()``."""
    import numpy as np

    if num == 1:
        return np.zeros(1, np.int64)
    div = np.float32(num - 1)
    step = np.arange(num - 1, dtype=np.float32) / div
    out = np.concatenate([np.float32(frames - 1) * step, [np.float32(frames - 1)]])
    return out.astype(np.float32).astype(np.int64)


class SlowFastClassifier(CastModel):
    """The face-sequence front end and :class:`SlowFastR50`
    (``mintime_tpu/models/slowfast.py:172-225``): raw 0..255 frames ``(B, F,
    H, W, 3)`` → ``/ 255``, ``(x - mean) / std`` → a short-side resize to
    ``side_size`` (bilinear, antialiased when it shrinks, as
    ``jax.image.resize``) only when ``min(H, W) != side_size`` → a centre
    crop to ``crop_size`` → the compute dtype → ``num_frames`` fast frames
    and ``num_frames // ALPHA`` slow ones by truncated linspace indices →
    logits ``(B, num_classes)`` fp32.

    ``num_frames`` is the class default 32 wherever the JAX package builds
    the model (its CLIs never pass the yaml's ``num-frames``). Parameters sit
    under ``blocks.``, pytorchvideo's names, so a ``slowfast_r50``
    state_dict loads with :meth:`load_state_dict` (BatchNorm's
    ``num_batches_tracked`` aside). Placement, seeding and dtypes are
    :class:`~mintime_torch.models.classifier.CastModel`'s.
    """

    head_kind = "slowfast"

    def __init__(self, num_classes: int = 1, num_frames: int = 32, mean: float = 0.45,
                 std: float = 0.225, side_size: int = 256, crop_size: int = 256,
                 device: str | torch.device = "cuda", dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype | None = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_frames, self.mean, self.std = num_frames, mean, std
        self.side_size, self.crop_size = side_size, crop_size
        self.blocks = SlowFastR50(num_classes)
        self._place(dev, dtype, param_dtype, seed, children=("blocks",),
                    memory_format=torch.channels_last_3d)

    def front_end(self, frames):
        """``(slow, fast)`` pathway inputs, NTHWC in the compute dtype."""
        B, F_, H, W = frames.shape[:4]
        x = frames.to(device=self.device, dtype=torch.float32) / 255.0
        x = (x - self.mean) / self.std
        if min(H, W) != self.side_size:
            # pytorchvideo's ShortSideScale: the long side floored
            if H < W:
                nh, nw = self.side_size, int(W * self.side_size // H)
            else:
                nh, nw = int(H * self.side_size // W), self.side_size
            x = F.interpolate(x.reshape(B * F_, H, W, 3).permute(0, 3, 1, 2), size=(nh, nw),
                              mode="bilinear", align_corners=False, antialias=True)
            x = x.permute(0, 2, 3, 1).reshape(B, F_, nh, nw, 3)
            H, W = nh, nw
        if (H, W) != (self.crop_size, self.crop_size):
            y0, x0 = max(0, (H - self.crop_size) // 2), max(0, (W - self.crop_size) // 2)
            x = x[:, :, y0:y0 + self.crop_size, x0:x0 + self.crop_size]
        x = x.to(self.compute_dtype)
        fast = x[:, torch.from_numpy(temporal_index(F_, self.num_frames)).to(x.device)]
        slow_idx = temporal_index(self.num_frames, self.num_frames // ALPHA)
        return fast[:, torch.from_numpy(slow_idx).to(x.device)], fast

    def forward(self, frames, *, train: bool = False, generator: torch.Generator | None = None):
        """``train`` picks train mode (batch statistics) for this call;
        ``generator`` is accepted for the train step's signature and unused
        (the network has no dropout)."""
        slow, fast = self.front_end(frames)
        self.blocks.train(train)
        return self._in_compute_dtype("blocks", slow, fast)


def uniform_temporal_subsample(frames, num: int):
    """pytorchvideo's UniformTemporalSubsample on the host: the frames at
    ``linspace(0, t - 1, num)`` truncated (``.long()``), not rounded."""
    import numpy as np

    t = frames.shape[0]
    return frames[np.linspace(0, t - 1, num).astype(int)]


def short_side_scale(frames, size: int):
    """pytorchvideo's ShortSideScale on the host: the short side to ``size``,
    the long side floored, bilinear (cv2's ``INTER_LINEAR``)."""
    import cv2
    import numpy as np

    t, h, w = frames.shape[:3]
    if min(h, w) == size:
        return frames
    if h < w:
        nh, nw = size, int(w * size // h)
    else:
        nh, nw = int(h * size // w), size
    return np.stack([cv2.resize(fr, (nw, nh), interpolation=cv2.INTER_LINEAR) for fr in frames])


def center_crop(frames, size: int):
    h, w = frames.shape[1:3]
    y, x = max(0, (h - size) // 2), max(0, (w - size) // 2)
    return frames[:, y:y + size, x:x + size]


def slowfast_input_pack(frames, num_frames: int = 32, crop_size: int = 256,
                        side_size: int = 256, mean: float = 0.45, std: float = 0.225):
    """Video frames ``(T, H, W, 3)`` uint8 → ``(slow, fast)`` inputs of
    :class:`SlowFastR50` on the host, each with a batch axis of one: subsample,
    ``/ 255``, normalise, scale, crop, slow = ``num_frames // ALPHA`` of the
    fast frames (``mintime_tpu/models/slowfast.py:262-276``)."""
    import numpy as np

    x = uniform_temporal_subsample(frames, num_frames).astype(np.float32) / 255.0
    x = (x - mean) / std
    x = center_crop(short_side_scale(x, side_size), crop_size)
    return uniform_temporal_subsample(x, num_frames // ALPHA)[None], x[None]
