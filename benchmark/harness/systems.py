"""The reference's training system: a family's plain forward, the loss, the
gradient by autograd and SGD, over the program's training interface
(``prepare``, ``step``, ``params``), so that it can also stand in the
program's place as the control."""

from __future__ import annotations

import torch

from reference import training
from reference.numerics import Numerics

BUFFERS = ("running_mean", "running_var")


class ReferenceTraining:
    def __init__(self, fam, cfg: dict, sd: dict, device, seed: int, pos_weight: float,
                 num: Numerics):
        self.fam, self.cfg, self.seed, self.pw, self.num = fam, cfg, seed, pos_weight, num
        self.device = torch.device(device)
        self.leaves = {k: v.detach().clone() for k, v in sd.items() if not k.endswith(BUFFERS)}
        self.buffers = {k: v for k, v in sd.items() if k.endswith(BUFFERS)}
        self.k = 0
        #: each leaf's norm of the last step's gradient (0 for none)
        self.grad_norms: dict = {}

    def prepare(self, raw, traffic: dict, labels, batch: int) -> list:
        return self.fam.reference_batches(raw, traffic, labels, batch, self.cfg, self.device)

    def lr(self, step: int) -> float:
        return learning_rate(self.cfg, step)

    def step(self, batch: dict):
        t = {k.replace("-", "_"): v for k, v in self.cfg["training"].items()}
        gen = training.step_generator(self.seed, self.k)
        live = {k: v.requires_grad_(self.fam.trained(k)) for k, v in self.leaves.items()}
        lg = self.fam.logits({**live, **self.buffers}, batch, self.cfg, self.num, train=True,
                             generator=gen, checkpoint=True)
        loss = training.bce(lg, batch["labels"], self.pw)
        names = [k for k, v in live.items() if v.requires_grad]
        grads = dict(zip(names, torch.autograd.grad(loss, [live[k] for k in names],
                                                    allow_unused=True)))
        for v in live.values():
            v.requires_grad_(False)
        self.grad_norms = {k: 0.0 if grads.get(k) is None else float(grads[k].double().norm())
                           for k in live}
        training.sgd(self.leaves, grads, self.lr(self.k), t["weight_decay"])
        self.k += 1
        return loss.detach()

    def params(self) -> dict:
        return self.leaves


def learning_rate(cfg: dict, step: int) -> float:
    t = {k.replace("-", "_"): v for k, v in cfg["training"].items()}
    a = cfg["assumed"]
    return training.learning_rate(t, step, a["schedule_steps_per_epoch"], a["schedule_epochs"])
