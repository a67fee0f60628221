"""Training step of the port (counterpart of ``mintime_tpu/train.py``).

A train step is eager PyTorch: the classifier's forward in train mode, the
BCE-with-``pos_weight`` loss, the backward (through the CUDA backward kernels
of the FFN and the divided attention when ``use_kernels`` is on and the model
is on the card), and a ``torch.optim`` update. The semantics are the JAX
package's (``train.py:11-16``):

* SGD and Adam take coupled weight decay (decay added to the gradient, which
  is torch's ``weight_decay``); AdamW takes decoupled decay. SGD has no
  momentum, Adam and AdamW optax's defaults (betas 0.9 / 0.999, eps 1e-8).
* The learning rate follows :func:`make_schedule` per step, as optax's
  schedules do: step ``k`` (counting from 0) uses ``schedule(k)``.
* Parameters that a ``trainable_mask`` freezes get no update at all (optax's
  ``set_to_zero``). Every other parameter is updated even when no gradient
  reaches it (``freeze_backbone``): JAX hands it a zero gradient, so coupled
  decay and Adam still move it.
* Drop-connect in the backbone draws from a CPU ``torch.Generator`` seeded
  from ``(seed, step)``, as the JAX step folds the step into its key.

With a ``mesh`` (:mod:`mintime_torch.parallel.mesh`) the steps take this data
rank's rows of each global batch: the forward runs in
``DistributedDataParallel`` with BatchNorm statistics and drop-connect masks
of the global batch, each rank's loss is its rows' sum over the global row
count times the number of data ranks (so DDP's mean of the ranks' gradients
is the global batch's gradient, unequal last batches included), and the
metrics are sums over the ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from mintime_torch.config import MintimeConfig
from mintime_torch.models.classifier import MintimeVideoClassifier
from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer
from mintime_torch.models.efficientnet import BatchRows
from mintime_torch.parallel.mesh import all_sum, axis_rank, axis_size, data_parallel
from mintime_torch.utils import profiling
from mintime_torch.utils.profiling import span


def bce_with_logits(logits, labels, pos_weight: float = 1.0, weights=None):
    """``torch.nn.BCEWithLogitsLoss(pos_weight=...)`` semantics
    (``train.py:50-63``): mean over elements of ``(1-y)x + (1 + (w-1)y) *
    softplus(-x)``; with ``weights`` (the per-sample ``valid`` mask of padded
    partial batches) a weighted mean over the real samples only."""
    per = _bce_terms(logits, labels, pos_weight)
    if weights is None:
        return per.mean()
    w = torch.as_tensor(weights, device=per.device).float().reshape(-1)
    return (per * w).sum() / w.sum().clamp(min=1.0)


def _bce_terms(logits, labels, pos_weight: float = 1.0):
    """The per-sample terms that :func:`bce_with_logits` averages."""
    x = logits.float().reshape(-1)
    y = torch.as_tensor(labels, device=x.device).float().reshape(-1)
    return (1.0 - y) * x + (1.0 + (pos_weight - 1.0) * y) * F.softplus(-x)


def make_schedule(cfg: MintimeConfig, steps_per_epoch: int,
                  num_epochs: int) -> Callable[[int], float]:
    """Learning rate of update ``step`` (from 0), as optax's schedules in
    ``train.py:66-81``: ``steplr`` multiplies by ``gamma`` every ``step_size``
    epochs (staircase); ``cosinelr`` falls along a cosine from ``lr`` to
    ``lr * 0.1`` over the whole run and stays there; anything else is
    constant."""
    t = cfg.training
    name = t.scheduler.lower()
    if name == "steplr":
        every = t.step_size * steps_per_epoch
        if every <= 0:
            return lambda step: t.lr
        return lambda step: t.lr * t.gamma ** (step // every)
    if name == "cosinelr":
        decay_steps = max(1, num_epochs * steps_per_epoch)

        def cosine(step: int) -> float:
            frac = min(step, decay_steps) / decay_steps
            return t.lr * (0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.1)

        return cosine
    return lambda step: t.lr


def make_optimizer(cfg: MintimeConfig, named_params, trainable_mask=None) -> torch.optim.Optimizer:
    """The reference's optimizer (``train.py:84-115``) over ``named_params``
    (``model.named_parameters()``). A ``trainable_mask`` (a dict of name →
    bool, or a callable that makes one from the named parameters) leaves the
    frozen ones out, so they are never updated."""
    named = dict(named_params)
    if trainable_mask is not None:
        mask = trainable_mask(named) if callable(trainable_mask) else trainable_mask
        named = {k: p for k, p in named.items() if mask[k]}
    params = list(named.values())
    t = cfg.training
    name = t.optimizer.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=t.lr, weight_decay=t.weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=t.lr, weight_decay=t.weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=t.lr, weight_decay=t.weight_decay)
    raise ValueError(f"invalid optimizer {t.optimizer!r} (train.py:185-193)")


def _block_index(name: str) -> int | None:
    """None outside the extractor, the block index inside ``_blocks.{i}``,
    -1 for the extractor's stem and head."""
    parts = name.split(".")
    if "extractor" not in parts:
        return None
    if "_blocks" in parts:
        return int(parts[parts.index("_blocks") + 1])
    return -1


def extractor_unfreeze_mask(unfreeze_blocks: int):
    """Reference partial-unfreeze policy (``train.py:118-154``): only the
    extractor's last ``unfreeze_blocks`` blocks train, its stem, head and other
    blocks are frozen, and every parameter outside the extractor trains. The
    block count comes from the parameter names (``_blocks.{i}``). Returns a
    callable for :func:`make_optimizer`'s ``trainable_mask``."""

    def mask(named_params: Mapping[str, Any]) -> dict[str, bool]:
        idx = {name: _block_index(name) for name in named_params}
        present = sorted({i for i in idx.values() if i is not None and i >= 0})
        kept = set(present[len(present) - min(unfreeze_blocks, len(present)):])
        return {name: i is None or i in kept for name, i in idx.items()}

    return mask


def model_inputs(batch: Mapping[str, Any], head: str, device) -> tuple:
    """The model's positional inputs from a batch dict (numpy arrays or
    tensors), on ``device`` (``train.py:157-168``)."""
    if head in ("baseline", "slowfast", "frame"):
        keys = ("frames",)
    elif head == "conv_timesformer":
        keys = ("frames", "mask", "size_embedding")
    else:
        keys = ("frames", "mask", "identities_mask", "size_embedding", "positions")
    return tuple(torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in keys)


@dataclass
class TrainState:
    """What a train step updates: the model (its parameters and BatchNorm
    statistics), the optimizer and its state, the schedule and the step
    count; ``seed`` seeds the per-step drop-connect generator."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    seed: int = 0


def training_model(config, device: str | torch.device = "cuda", seed: int = 0):
    """The flagship classifier as the JAX train state holds it: fp32
    parameters and BatchNorm statistics, computing in bf16 on the card (fp32
    on the CPU), kernels on. ``device`` defaults to the card and raises
    without one."""
    return MintimeVideoClassifier(config, use_kernels=True, device=device,
                                  param_dtype=torch.float32, seed=seed)


def conv_training_model(config, device: str | torch.device = "cuda", seed: int = 0):
    """The Convolutional TimeSformer (``--model 3``) as the JAX train state
    holds it: fp32 parameters and BatchNorm statistics, computing in bf16 on
    the card (fp32 on the CPU), kernels on; its extractor stays frozen.
    ``device`` defaults to the card and raises without one."""
    return ConvolutionalTimeSformer(config, use_kernels=True, device=device,
                                    param_dtype=torch.float32, seed=seed)


def slowfast_training_model(config, device: str | torch.device = "cuda", seed: int = 0):
    """SlowFast R-50 (``--model 2``) as the JAX train state holds it: fp32
    parameters and BatchNorm statistics, computing in bf16 on the card (fp32
    on the CPU), the class's front end (32 fast frames at 256 px) as the JAX
    CLIs build it. ``device`` defaults to the card and raises without one."""
    from mintime_torch.models.slowfast import SlowFastClassifier

    return SlowFastClassifier(num_classes=config.num_classes, device=device,
                              param_dtype=torch.float32, seed=seed)


def create_train_state(model, cfg: MintimeConfig, steps_per_epoch: int = 1000,
                       num_epochs: int = 30, trainable_mask=None, seed: int = 0) -> TrainState:
    return TrainState(model, make_optimizer(cfg, model.named_parameters(), trainable_mask),
                      make_schedule(cfg, steps_per_epoch, num_epochs), 0, seed)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of drop-connect for one step."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1)[0]))


def forward_loss(model, batch: Mapping[str, Any], pos_weight: float = 1.0, *, train: bool,
                 generator: torch.Generator | None = None, mesh=None, net=None):
    """(loss, logits (B,)) of the model on one batch. With a ``mesh``,
    ``batch`` holds this data rank's rows, ``net`` (the model's
    ``DistributedDataParallel`` wrapper, or the model) runs them, and the
    loss is the rank's share described in the module's docstring (summed
    over the ranks and divided by their count, the global batch's loss)."""
    dev = model.device
    logits = (net or model)(*model_inputs(batch, model.head_kind, dev), train=train,
                            generator=generator)
    valid = batch.get("valid")
    weights = None if valid is None else torch.as_tensor(valid).to(dev)
    labels = torch.as_tensor(batch["labels"]).to(dev)
    if mesh is None:
        return bce_with_logits(logits, labels, pos_weight, weights=weights), logits.reshape(-1)
    per = _bce_terms(logits, labels, pos_weight)
    w = torch.ones_like(per) if weights is None else weights.float().reshape(-1)
    total = all_sum(mesh, w.sum()).clamp(min=1.0)
    loss = axis_size(mesh) * (per * w).sum() / total
    return loss, logits.reshape(-1)


def _local_rows(batch, mesh, device) -> tuple[int, int, int, int]:
    """(first, end, total, distinct) of this data rank's rows of the global
    batch: ``distinct`` counts its valid rows, the rows that a padded batch
    repeats (:func:`mintime_torch.parallel.mesh.pad_rows`)."""
    n = len(batch.get("labels", ()))
    world = axis_size(mesh)
    counts = torch.zeros(world + 1, dtype=torch.float64, device=device)
    counts[axis_rank(mesh)] = n
    valid = batch.get("valid")
    counts[world] = n if valid is None else float(torch.as_tensor(valid).float().sum())
    counts = all_sum(mesh, counts).cpu().round().long()
    rows, distinct = counts[:world], int(counts[world])
    if not rows.all():  # every rank sees it, so none is left waiting
        raise ValueError(f"data ranks got {rows.tolist()} rows of a batch: a training batch "
                         "needs at least one row a data rank")
    first = int(rows[:axis_rank(mesh)].sum())
    return first, first + n, int(rows.sum()), distinct


def make_train_step(model, pos_weight: float = 1.0, mesh=None) -> Callable:
    """``train_step(state, batch) → metrics`` (``train.py:194-240``): one
    forward and backward in train mode and one optimizer update. The metrics
    stay on the device: ``loss``, and over the valid samples ``correct``,
    ``positive`` (predicted fake) and ``count``. With a ``mesh`` the batch is
    this data rank's rows and the metrics are the global batch's. The step
    is the span ``step`` (its number the argument) over ``step.forward``,
    ``step.backward`` and ``step.optimizer`` (twice: the gradients cleared
    before the backward, the update after it); a host mask counts its faces
    (``faces_valid``)."""
    net = model if mesh is None else data_parallel(model, mesh)

    def train_step(state: TrainState, batch) -> dict[str, torch.Tensor]:
        with span(profiling.STEP, step=state.step):
            m = model
            if isinstance(batch.get("mask"), np.ndarray):
                profiling.count(profiling.FACES_VALID, np.count_nonzero(batch["mask"]))
            generator = step_generator(state.seed, state.step)
            if axis_size(mesh) > 1:
                generator = BatchRows(generator, *_local_rows(batch, mesh, m.device))
            with span(profiling.STEP_FORWARD):
                loss, logits = forward_loss(m, batch, pos_weight, train=True, generator=generator,
                                            mesh=mesh, net=net)
            opt = state.optimizer
            with span(profiling.STEP_OPTIMIZER):
                opt.zero_grad(set_to_none=True)
            with span(profiling.STEP_BACKWARD):
                loss.backward()
            with span(profiling.STEP_OPTIMIZER):
                lr = state.schedule(state.step)
                for group in opt.param_groups:
                    group["lr"] = lr
                    for p in group["params"]:
                        if p.grad is None:  # JAX's zero gradient, e.g. a frozen backbone
                            p.grad = torch.zeros_like(p)
                opt.step()
            state.step += 1
            with torch.no_grad():
                preds = (torch.sigmoid(logits) >= 0.5).int()
                labels = torch.as_tensor(batch["labels"]).to(m.device).reshape(-1).int()
                valid = batch.get("valid")
                valid = (torch.ones(preds.shape, device=m.device) if valid is None
                         else torch.as_tensor(valid).to(m.device).reshape(-1).float())
                metrics = {"loss": loss.detach(), "correct": ((preds == labels) * valid).sum(),
                           "positive": (preds * valid).sum(), "count": valid.sum()}
                if mesh is not None:
                    metrics = _all_sum_metrics(metrics, mesh)
                # free the autograd graph (~1 host ms) inside the step's span, not after it
                del loss, logits
                return metrics

    return train_step


def _all_sum_metrics(metrics: dict, mesh) -> dict:
    """Metrics summed over the data ranks; the loss, each rank's share
    times the rank count, back to the global mean."""
    keys = list(metrics)
    out = all_sum(mesh, torch.stack([metrics[k].float() for k in keys]))
    out = dict(zip(keys, out))
    out["loss"] = out["loss"] / axis_size(mesh)
    return out


def make_eval_step(model, pos_weight: float = 1.0, mesh=None) -> Callable:
    """``eval_step(state, batch) → {"logits", "loss"}`` in eval mode
    (``train.py:243-254``). With a ``mesh`` the batch is this data rank's
    rows, ``logits`` theirs and ``loss`` the global batch's."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> dict[str, torch.Tensor]:
        if mesh is not None and len(batch.get("labels", ())) == 0:
            # a rank without rows of this batch still joins the batch's sums
            zero = torch.zeros((), device=model.device)
            loss, logits = all_sum(mesh, zero) * 0, zero.new_zeros(0)
        else:
            loss, logits = forward_loss(model, batch, pos_weight, train=False, mesh=mesh)
        if mesh is not None:
            loss = _all_sum_metrics({"loss": loss}, mesh)["loss"]
        return {"logits": logits, "loss": loss}

    return eval_step


def pos_weight_from_labels(labels) -> float:
    """class_weights = #pristine / #fake (``train.py:296-303``)."""
    labels = np.asarray(labels)
    pos = int((labels == 1).sum())
    neg = int((labels == 0).sum())
    return neg / max(pos, 1)
