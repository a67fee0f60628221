"""The Convolutional TimeSformer: EfficientNet-B0 tapped at
``efficient-net-block`` and frozen, a divided-attention head over the
``F * C`` channel maps. Training only, over ``mintime_classifier``'s
interface; its extractor's parameters take no gradient and only decay."""

from __future__ import annotations

import numpy as np
import torch

from harness import files
from reference import efficientnet as eff, timesformer as tsf
from reference.numerics import Numerics

_base = files.module("families", "mintime_classifier")
model, program_config = _base.model, _base.program_config


def spec(cfg: dict) -> list:
    m = model(cfg)
    tap = m["efficient_net_block"]
    g = eff.grid(m["image_size"], tap)
    c = eff.feature_channels(tap)
    return eff.param_spec("extractor", tap) + tsf.param_spec("head", m, g * g,
                                                             m["num_frames"] * c)


class Training(_base.Training):
    def _model(self, train, device):
        return train.conv_training_model(self.mc.model, device=device)


def logits(sd: dict, batch: dict, cfg: dict, num: Numerics, train: bool = False,
           generator=None, checkpoint: bool = False):
    m = model(cfg)
    frames = batch["frames"]
    B, F = frames.shape[:2]
    with torch.no_grad():  # frozen, in eval mode
        feats = eff.forward(sd, "extractor", frames.reshape((B * F,) + frames.shape[2:]).float(),
                            num, False, tap=m["efficient_net_block"])
    feats = feats.reshape((B, F) + feats.shape[1:])
    return tsf.conv_head(sd, "head", feats, batch["size_embedding"], m, num, checkpoint)


reference_batches = _base.reference_batches


def trained(key: str) -> bool:
    return not key.startswith("extractor.")
