"""Frame-level MLP head (counterpart of ``mintime_tpu/models/baseline.py``).

Global-average-pools an NHWC feature map and applies two stacked Linear
layers with no nonlinearity between them (reference ``mlp_head.{0,1}``). The
video logit is the mean of the F per-face logits (:func:`video_logits`).
"""

from __future__ import annotations

import torch
from torch import nn

from mintime_torch.config import ModelConfig


class Baseline(nn.Module):
    """Per-face MLP head over NHWC feature maps ``(N, h, w, C)``."""

    #: computes in its parameters' dtype (see :meth:`forward`)
    keep_param_dtype = True

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.mlp_head = nn.Sequential(
            nn.Linear(config.channels, config.mlp_dim),
            nn.Linear(config.mlp_dim, config.num_classes),
        )

    def forward(self, x):
        """In the parameters' dtype, as the JAX head's ``Dense`` layers
        promote a bf16 feature map to their fp32 parameters."""
        return self.mlp_head(x.mean(dim=(1, 2)).to(self.mlp_head[0].weight.dtype))


def video_logits(face_logits: torch.Tensor, batch: int, num_frames: int) -> torch.Tensor:
    """Mean of the per-face logits of each video."""
    return face_logits.reshape(batch, num_frames, -1).mean(dim=1)
