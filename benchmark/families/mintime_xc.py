"""MINTIME-XC: Xception on every face, the Size-Invariant TimeSformer over the
assembled sequence at ``channels`` 2048. Scoring only, over
``mintime_classifier``'s serving interface: the program's side is that
family's ``Serving`` (the predict CLI's load, ``assemble_inputs``,
``predict_assembled``); the reference's is the plain Xception
(``reference/xception.py``), then the same plain head and assembly.

Both sides load the seeded weights with ``bn1``'s running statistics set by
:func:`calibrated`, so that the frames' 0-255 scale leaves the stem at unit
scale (the configuration's ``assumed``)."""

from __future__ import annotations

import numpy as np
import torch

from harness import files
from reference import assembly, timesformer as tsf, xception as xc
from reference.numerics import Numerics

_base = files.module("families", "mintime_classifier")
model, program_config, _stack = _base.model, _base.program_config, _base._stack
SERVE_BLOCK = _base.SERVE_BLOCK

#: the tiny sizes of ``benchmark/tests``' CPU runs: a 2 x 2 map at 64 px
TINY_MODEL = {"image-size": 64, "num-patches": 4, "num-frames": 8, "dim": 64, "depth": 1,
              "heads": 2, "dim-head": 32}
#: the frames' pixel mean and variance that ``bn1`` is calibrated to:
#: uniform noise over 0-255
PIXEL_MEAN, PIXEL_VAR = 127.5, 255.0 ** 2 / 12


def spec(cfg: dict) -> list:
    m = model(cfg)
    return (xc.param_spec("extractor")
            + tsf.param_spec("head", m, m["channels"], m["num_frames"] * m["num_patches"]))


def calibrated(sd: dict) -> dict:
    """``sd`` with ``extractor.bn1``'s running statistics those of ``conv1``'s
    output for pixels of mean ``PIXEL_MEAN`` and variance ``PIXEL_VAR``,
    independent from pixel to pixel: per channel, the mean times the sum of
    its weights and the variance times the sum of their squares."""
    w = sd["extractor.conv1.weight"]
    return {**sd, "extractor.bn1.running_mean": PIXEL_MEAN * w.sum(dim=(1, 2, 3)),
            "extractor.bn1.running_var": PIXEL_VAR * w.square().sum(dim=(1, 2, 3))}


class Serving(_base.Serving):
    """MINTIME-XC as the predict CLI serves it (``backbone`` xception)."""

    def __init__(self, cfg: dict, sd: dict, device):
        super().__init__(cfg, calibrated(sd), device)


def logits(sd: dict, batch: dict, cfg: dict, num: Numerics, want_maps: bool = False):
    m = model(cfg)
    frames = batch["frames"]
    B, F = frames.shape[:2]
    feats = xc.forward(sd, "extractor", frames.reshape((B * F,) + frames.shape[2:]).float(), num)
    feats = feats.reshape((B, F) + feats.shape[1:])
    return tsf.size_invariant(sd, "head", feats, batch["mask"], batch["identities_mask"],
                              batch["size_embedding"], batch["positions"], m, num, want_maps)


class ReferenceServing(_base.ReferenceServing):
    """The plain reference (``num``: float32, or the control's float8) over
    its own assembly of the same videos."""

    def __init__(self, cfg: dict, sd: dict, device, num: Numerics):
        super().__init__(cfg, calibrated(sd), device, num)

    @torch.no_grad()
    def predict(self, items: list) -> list:
        m, out = model(self.cfg), []
        for i in range(0, len(items), SERVE_BLOCK):
            chunk = items[i:i + SERVE_BLOCK]
            lg, maps = logits(self.sd, _stack(chunk), self.cfg, self.num, want_maps=True)
            for b, it in enumerate(chunk):
                shares, frames = assembly.aggregate([mp[b].cpu().numpy() for mp in maps],
                                                    m["num_frames"], it["plan"]["cum_frames"])
                out.append((1.0 / (1.0 + np.exp(-float(lg[b, 0]))), shares, frames))
        return out
