"""The frame-level classifier of extractor pretraining (counterpart of
``mintime_tpu/pretrain_extractor.py:28-47``): EfficientNet-B0 features →
global mean pool → ``fc`` Linear(1280, 1) → one fp32 logit a frame.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mintime_torch.device import resolve_device
from mintime_torch.models.classifier import CastModel
from mintime_torch.models.efficientnet import EfficientNet


class FrameClassifier(CastModel):
    """Frames ``(B, H, W, 3)`` (uint8 or float, NHWC) → logits ``(B, 1)``
    fp32. ``head_kind = "frame"`` routes frame-only batches through
    :func:`mintime_torch.train.model_inputs`. Placement, seeding and dtypes
    are :class:`~mintime_torch.models.classifier.CastModel`'s; the ``fc``
    layer computes in fp32, as the JAX ``nn.Dense`` promotes the bf16 pool
    to its fp32 parameters."""

    head_kind = "frame"

    def __init__(self, device: str | torch.device = "cuda", dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype | None = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.extractor = EfficientNet("efficientnet-b0")
        self.fc = nn.Linear(self.extractor.feature_dim, 1)
        self.fc.keep_param_dtype = True
        self._place(dev, dtype, param_dtype, seed, children=("extractor",))

    def forward(self, frames, *, train: bool = False, generator: torch.Generator | None = None):
        """``train`` picks train mode (batch statistics, drop-connect drawn
        from ``generator``) for this call."""
        self.extractor.train(train)
        feats = self._in_compute_dtype("extractor", frames.to(self.compute_dtype),
                                       generator=generator)
        pooled = feats.mean(dim=(1, 2)).float()
        return F.linear(pooled, self.fc.weight.float(), self.fc.bias.float())
