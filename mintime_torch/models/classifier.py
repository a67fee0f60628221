"""End-to-end video classifier: CNN backbone + video head (counterpart of
``mintime_tpu/models/classifier.py:31-100``).

Frames ``(B, F, H, W, 3)`` (uint8 or float, NHWC) → logits ``(B, 1)`` fp32,
plus the last layer's CLS-row attention maps with ``require_attention``.
``backbone`` is EfficientNet-B0 (MINTIME-EF, 1280 channels) or Xception
(MINTIME-XC, 2048 channels); ``"none"`` takes pre-extracted feature maps
``(B, F, h, w, C)``.

The model is built on ``device`` (default ``"cuda"``, which raises when
there is no card), computes in ``dtype`` (default bf16 on the card, fp32 on
the CPU) and keeps its parameters in ``param_dtype`` (default ``dtype``),
with weights drawn from ``torch.Generator().manual_seed(seed)``: the same
seed gives the same weights on every machine.

Serving keeps bf16 parameters on the card. Training keeps fp32 master
parameters (``param_dtype=torch.float32``) and computes in bf16 as the JAX
train state does (``classifier.py:43``, flax ``promote_dtype``): each forward
casts the parameters to the compute dtype once, so their gradients pass
through bf16 and land in fp32. Modules that compute in fp32 in the JAX
package declare ``keep_param_dtype`` (BatchNorm, the TimeSformer's output
projection, the baseline head) and stay in the parameter dtype.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from mintime_torch.config import ModelConfig
from mintime_torch.device import default_dtype, resolve_device
from mintime_torch.models.baseline import Baseline, video_logits
from mintime_torch.models.efficientnet import EfficientNet
from mintime_torch.models.timesformer import SizeInvariantTimeSformer
from mintime_torch.models.xception import Xception
from mintime_torch.ops import dw_conv
from mintime_torch.utils import profiling
from mintime_torch.utils.profiling import span

BACKBONES = ("efficientnet-b0", "xception", "none")
HEADS = ("timesformer", "baseline")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the spirit of the JAX package's: truncated normal
    (std 0.02, cut at ±2σ) for Linear, Embedding and the CLS token, LeCun
    normal for convolutions, zero biases, unit norms."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(getattr(m, "cls_token", None), nn.Parameter):
            nn.init.trunc_normal_(m.cls_token, std=0.02, a=-0.04, b=0.04, generator=generator)


def _cast_names(module: nn.Module) -> list[str]:
    """The parameters of ``module`` that a forward casts to the compute
    dtype: all but those under a module that declares ``keep_param_dtype``."""
    kept = tuple(f"{name}." if name else "" for name, m in module.named_modules()
                 if getattr(m, "keep_param_dtype", False))
    return [name for name, _ in module.named_parameters() if not name.startswith(kept)]


class CastModel(nn.Module):
    """An end-to-end model of the port: children (an ``extractor`` and a
    ``head``, unless :meth:`_place` names others), weights drawn from a seed,
    placed on a device in a memory format for its convolutions, and kept in
    a parameter dtype that each forward casts to the compute dtype.

    Subclasses build their children, then call :meth:`_place`.
    """

    def _place(self, device: torch.device, dtype: torch.dtype | None,
               param_dtype: torch.dtype | None, seed: int,
               children: tuple[str, ...] = ("extractor", "head"),
               memory_format: torch.memory_format = torch.channels_last) -> None:
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.compute_dtype = dtype or default_dtype(device)
        self.to(device=device, dtype=param_dtype or self.compute_dtype)
        if device.type == "cuda":
            self.to(memory_format=memory_format)
        self._cast_names = {child: _cast_names(getattr(self, child))
                            for child in children if hasattr(self, child)}

    def __call__(self, *args, **kwargs):
        """The model's call under the span ``model.forward``."""
        with span(profiling.MODEL_FORWARD):
            return super().__call__(*args, **kwargs)

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype (``compute_dtype`` is what the forward runs in)."""
        return next(self.parameters()).dtype

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _in_compute_dtype(self, child: str, *args, **kwargs):
        """Run the child module ``child`` with the parameters listed in
        ``_cast_names`` cast to the compute dtype; a plain call when
        parameters and compute share a dtype. The cast is the span
        ``model.cast``, the call ``model.<child>``; the extractor's rows
        count as ``faces_run``, and under a profile on the card its call's
        device time as ``extractor_device_us`` (:func:`profiling.device_timer`)."""
        module, names = getattr(self, child), self._cast_names[child]
        timer = contextlib.nullcontext()
        if child == "extractor":
            profiling.count(profiling.FACES_RUN, args[0].shape[0])
            timer = profiling.device_timer(profiling.EXTRACTOR_DEVICE_US,
                                           profiling.EXTRACTOR_TIMED, args[0].device)
        if self.dtype == self.compute_dtype or not names:
            with span(profiling.MODEL + child), timer:
                return module(*args, **kwargs)
        with span(profiling.MODEL_CAST):
            cast = {n: module.get_parameter(n).to(self.compute_dtype) for n in names}
        with span(profiling.MODEL + child), timer:
            return torch.func.functional_call(module, cast, args, kwargs)


class MintimeVideoClassifier(CastModel):
    """Flagship model: EfficientNet-B0 (or Xception) per face, then the
    Size-Invariant TimeSformer (or the baseline MLP head) per video.

    ``use_kernels`` routes the TimeSformer's FFNs and divided attentions
    through the CUDA kernels on the card (their plain versions on the CPU),
    and Xception's depthwise layers in inference (``F.conv2d`` elsewhere).
    ``freeze_backbone`` detaches the feature maps and keeps the backbone in
    eval mode.
    """

    def __init__(self, config: ModelConfig, backbone: str = "efficientnet-b0",
                 head: str = "timesformer", require_attention: bool = False,
                 freeze_backbone: bool = False, use_kernels: bool = False,
                 device: str | torch.device = "cuda", dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype | None = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}; choose from {BACKBONES}")
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; choose from {HEADS}")
        self.config = config
        self.backbone, self.head_kind = backbone, head
        self.require_attention = require_attention and head == "timesformer"
        self.freeze_backbone = freeze_backbone
        if backbone == "efficientnet-b0":
            self.extractor = EfficientNet("efficientnet-b0")
        elif backbone == "xception":
            self.extractor = Xception(use_kernels)
        if head == "timesformer":
            self.head = SizeInvariantTimeSformer(config, require_attention, use_kernels)
        else:
            self.head = Baseline(config)
        self._place(dev, dtype, param_dtype, seed)
        if use_kernels and backbone == "xception" and dev.type == "cuda":
            dw_conv.load()  # Xception's depthwise kernel, built now rather than in the first call

    def forward(self, frames, mask=None, identities_mask=None, size_embedding=None,
                positions=None, *, train: bool = False, generator: torch.Generator | None = None):
        """``train`` picks train mode for this call, as the JAX package's
        ``train`` argument does: batch statistics and drop-connect in the
        backbone (unless ``freeze_backbone``), dropout in the head.
        ``generator`` drives drop-connect."""
        B, F_ = frames.shape[:2]
        cd = self.compute_dtype
        if self.backbone == "none":
            feats = frames.to(cd)
        else:
            x = frames.reshape((B * F_,) + frames.shape[2:]).to(cd)
            self.extractor.train(train and not self.freeze_backbone)
            feats = self._in_compute_dtype("extractor", x, generator=generator)
            if self.freeze_backbone:
                feats = feats.detach()
            feats = feats.reshape((B, F_) + feats.shape[1:])

        self.head.train(train)
        if self.head_kind == "baseline":
            face_logits = self._in_compute_dtype("head", feats.reshape((B * F_,) + feats.shape[2:]))
            return video_logits(face_logits, B, F_).float()

        out = self._in_compute_dtype("head", feats, mask=mask, identities_mask=identities_mask,
                                     size_embedding=size_embedding, positions=positions)
        if self.require_attention:
            logits, attns = out
            return logits.float(), attns
        return out.float()
