"""MINTIME-EF: EfficientNet-B0 on every face, the Size-Invariant TimeSformer
over the assembled sequence. The program's side (serving and training
through the port's entry points) and the reference's (plain float32, or the
control's float8) over the same interface:

* serving: ``prepare(videos, traffic) -> items``, ``predict(items) ->
  [(probability, identity shares, combined frame attention)]``, the last
  the softmax over the frames that the shares are summed from;
* training: ``prepare(videos, traffic, labels, batch) -> batches``,
  ``step(batch) -> loss``, ``params() -> {name: tensor}``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import assembly, efficientnet as eff, timesformer as tsf
from reference.numerics import Numerics

SERVE_BLOCK = 8  # videos a reference forward


def model(cfg: dict) -> dict:
    """The model section, snake_case, with MINTIME's default of two identities
    where the yaml names none (the conv model's)."""
    return {"max_identities": 2, **{k.replace("-", "_"): v for k, v in cfg["model"].items()}}


def spec(cfg: dict) -> list:
    m = model(cfg)
    return (eff.param_spec("extractor")
            + tsf.param_spec("head", m, m["channels"], m["num_frames"] * m["num_patches"]))


def program_config(cfg: dict):
    from mintime_torch.config import config_from_dict

    return config_from_dict({k: cfg.get(k, {}) for k in ("model", "training", "test")})


def _dtype(cfg: dict, device) -> torch.dtype | None:
    return getattr(torch, cfg["compute_dtype"]) if torch.device(device).type == "cuda" else None


# ------------------------------------------------------------------ program

class Serving:
    """The classifier as the predict CLI serves it (``load_predict_models``),
    fed by ``assemble_inputs`` and scored by ``predict_assembled``."""

    def __init__(self, cfg: dict, sd: dict, device):
        from mintime_torch.models.classifier import MintimeVideoClassifier

        self.mc, self.device = program_config(cfg), torch.device(device)
        self.model = MintimeVideoClassifier(
            self.mc.model, backbone=cfg["backbone"], head=cfg["head"], require_attention=True,
            use_kernels=True, device=self.device, dtype=_dtype(cfg, device),
            param_dtype=getattr(torch, cfg["param_dtype"]))
        self.model.load_state_dict(sd)

    def prepare(self, videos: list, traffic: dict) -> list:
        from mintime_torch import predict

        vh, vw = traffic["video_hw"]
        return [predict.assemble_inputs(v, (vw, vh), self.mc, self.device) for v in videos]

    def predict(self, items: list) -> list:
        from mintime_torch import predict

        return [(r.probability, list(r.identity_attentions), r.aggregated_attentions[2])
                for r in predict.predict_assembled(items, self.model, None, self.mc)]


class Training:
    """``make_train_step`` on the training model (fp32 masters computing in
    bf16, kernels on) with the configuration's optimizer and schedule."""

    def __init__(self, cfg: dict, sd: dict, device, seed: int, pos_weight: float):
        from mintime_torch import train

        self.mc = program_config(cfg)
        self.model = self._model(train, device)
        self.model.load_state_dict(sd)
        a = cfg["assumed"]
        self.state = train.create_train_state(self.model, self.mc, a["schedule_steps_per_epoch"],
                                              a["schedule_epochs"], seed=seed)
        self.step_fn = train.make_train_step(self.model, pos_weight)
        self.device = torch.device(device)

    def _model(self, train, device):
        return train.training_model(self.mc.model, device=device)

    def prepare(self, videos, traffic: dict, labels: np.ndarray, batch: int) -> list:
        from mintime_torch import predict

        vh, vw = traffic["video_hw"]
        staged = [predict.assemble_inputs(v, (vw, vh), self.mc, self.device) for v in videos]
        out = []
        for i in range(0, len(staged), batch):
            b = predict.stack_inputs(staged[i:i + batch])
            b["labels"] = labels[i:i + batch]
            out.append(b)
        return out

    def step(self, batch):
        return self.step_fn(self.state, batch)["loss"]

    def params(self) -> dict:
        return dict(self.model.named_parameters())


# ---------------------------------------------------------------- reference

def logits(sd: dict, batch: dict, cfg: dict, num: Numerics, train: bool = False,
           generator: torch.Generator | None = None, want_maps: bool = False,
           checkpoint: bool = False):
    m = model(cfg)
    frames = batch["frames"]
    B, F = frames.shape[:2]
    images = frames.reshape((B * F,) + frames.shape[2:]).float()
    drops = eff.drop_masks(B * F, generator) if train else None
    feats = eff.forward(sd, "extractor", images, num, train, drops, checkpoint=checkpoint)
    feats = feats.reshape((B, F) + feats.shape[1:])
    return tsf.size_invariant(sd, "head", feats, batch["mask"], batch["identities_mask"],
                              batch["size_embedding"], batch["positions"], m, num, want_maps,
                              checkpoint)


def _stack(items: list) -> dict:
    return {k: torch.cat([it[k] for it in items]) for k in
            ("frames", "mask", "identities_mask", "size_embedding", "positions")}


class ReferenceServing:
    """The plain reference (``num``: float32, or the control's float8) over
    its own assembly of the same videos."""

    def __init__(self, cfg: dict, sd: dict, device, num: Numerics):
        self.cfg, self.sd, self.device, self.num = cfg, sd, torch.device(device), num

    def prepare(self, videos: list, traffic: dict) -> list:
        hw = tuple(traffic["video_hw"])
        return [assembly.assemble(v, hw, model(self.cfg), self.device) for v in videos]

    @torch.no_grad()
    def predict(self, items: list) -> list:
        m, out = model(self.cfg), []
        for i in range(0, len(items), SERVE_BLOCK):
            chunk = items[i:i + SERVE_BLOCK]
            lg, maps = logits(self.sd, _stack(chunk), self.cfg, self.num, want_maps=True)
            for b, it in enumerate(chunk):
                x = float(lg[b, 0])
                shares, frames = assembly.aggregate([mp[b].cpu().numpy() for mp in maps],
                                                    m["num_frames"], it["plan"]["cum_frames"])
                out.append((1.0 / (1.0 + np.exp(-x)), shares, frames))
        return out


def reference_batches(videos, traffic: dict, labels: np.ndarray, batch: int, cfg: dict,
                      device) -> list:
    items = ReferenceServing(cfg, {}, device, Numerics()).prepare(videos, traffic)
    out = []
    for i in range(0, len(items), batch):
        b = _stack(items[i:i + batch])
        b["labels"] = torch.as_tensor(labels[i:i + batch], device=device)
        out.append(b)
    return out


def trained(key: str) -> bool:
    """Leaves that take a gradient in the reference (all: the backbone trains)."""
    return True
