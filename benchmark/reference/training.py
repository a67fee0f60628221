"""MINTIME's training step as plain float32 PyTorch: binary cross-entropy on
the logits with ``pos_weight`` (``BCEWithLogitsLoss``), the gradient by
autograd, and SGD without momentum whose weight decay is added to the
gradient, at the learning rate the schedule gives the step (``cosinelr``:
from ``lr`` down a cosine to a tenth of it over all the run's steps;
``steplr``: times ``gamma`` every ``step_size`` epochs). Every parameter is
updated, also one that gets no gradient (the frozen extractor decays).

Drop-connect's masks of step ``k`` come from a CPU generator seeded with the
first word of ``numpy.random.SeedSequence((seed, k))``, as the JAX training
step folds the step into its key.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def bce(logits, labels, pos_weight: float):
    x, y = logits.reshape(-1), labels.reshape(-1).to(logits.dtype)
    return ((1 - y) * x + (1 + (pos_weight - 1) * y) * F.softplus(-x)).mean()


def learning_rate(t: dict, step: int, steps_per_epoch: int, epochs: int) -> float:
    if t["scheduler"] == "cosinelr":
        total = max(1, steps_per_epoch * epochs)
        frac = min(step, total) / total
        return t["lr"] * (0.9 * 0.5 * (1 + math.cos(math.pi * frac)) + 0.1)
    if t["scheduler"] == "steplr":
        every = t["step_size"] * steps_per_epoch
        return t["lr"] * t["gamma"] ** (step // every) if every > 0 else t["lr"]
    return t["lr"]


def step_generator(seed: int, step: int) -> torch.Generator:
    word = int(np.random.SeedSequence((seed, step)).generate_state(1)[0])
    return torch.Generator().manual_seed(word)


@torch.no_grad()
def sgd(params: dict, grads: dict, lr: float, weight_decay: float) -> None:
    for k, p in params.items():
        g = grads.get(k)
        d = weight_decay * p if g is None else g + weight_decay * p
        p.sub_(lr * d)
