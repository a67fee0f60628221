"""Training loop: epochs, validation, early stopping, checkpoints, logs
(counterpart of ``mintime_tpu/train_loop.py:29-188``).

:func:`fit` runs ``num_epochs + 1`` epochs over any iterables of batch dicts
(numpy arrays or tensors under the keys of
:func:`mintime_torch.train.model_inputs`, plus ``labels`` and optionally
``valid``), validates after each, saves a ``checkpoint_<epoch>`` when the
validation loss improves, stops after ``patience`` epochs without
improvement, and logs the reference's scalar tags (``Training/Loss``,
``Training/Accuracy``, ``Training/Learning_Rate``, ``Validation/Loss``,
``Validation/Accuracy``). The on-disk data pipeline and the command line
(``main``) are a later slice of the port.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np

from mintime_torch.config import MintimeConfig
from mintime_torch.train import TrainState, make_eval_step, make_train_step
from mintime_torch.utils.checkpoint import save_train_state


@dataclass
class ScalarLogger:
    """Scalar log with the reference's TensorBoard tags: ``scalars.jsonl``
    (one ``{tag, value, step}`` object per line) plus a TensorBoard event file
    from :mod:`mintime_torch.utils.tb_events`; ``MINTIME_TB=0`` turns the
    event file off."""

    log_dir: str

    def __post_init__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if os.environ.get("MINTIME_TB", "1") != "0":
            from mintime_torch.utils.tb_events import EventFileWriter

            self._tb = EventFileWriter(self.log_dir)

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@dataclass
class FitResult:
    best_val_loss: float
    epochs_run: int
    checkpoints: list = field(default_factory=list)


def fit(state: TrainState, train_loader, val_loader, cfg: MintimeConfig, num_epochs: int = 30,
        patience: int = 5, pos_weight: float = 1.0, models_output_path: str = "models_out",
        log_dir: str = "runs/exp", log_every: int = 100) -> tuple[TrainState, FitResult]:
    """Run the training loop; returns (state, FitResult). Step metrics stay on
    the device and are read once per ``log_every`` steps."""
    train_step = make_train_step(state.model, pos_weight)
    eval_step = make_eval_step(state.model, pos_weight)
    logger = ScalarLogger(log_dir)
    not_improved = 0
    previous_loss = math.inf
    result = FitResult(best_val_loss=math.inf, epochs_run=0)

    for epoch in range(num_epochs + 1):
        if not_improved == patience:  # train.py:316-317
            break
        t0 = time.time()
        tot_loss = tot_correct = tot_count = tot_pos = 0.0
        pending: list[dict] = []

        def drain():
            nonlocal tot_loss, tot_correct, tot_count, tot_pos
            for m in pending:
                tot_loss += float(m["loss"])
                tot_correct += int(m["correct"])
                tot_count += int(m["count"])
                tot_pos += int(m["positive"])
            pending.clear()

        n_batches = 0
        for batch in train_loader:
            pending.append(train_step(state, batch))
            n_batches += 1
            if n_batches % log_every == 0:
                drain()
                print(f"epoch {epoch} [{n_batches}] loss {tot_loss / n_batches:.4f} "
                      f"acc {tot_correct / max(tot_count, 1):.4f} pos {int(tot_pos)} "
                      f"neg {int(tot_count - tot_pos)} {time.time() - t0:.0f}s")
        drain()
        train_loss = tot_loss / max(n_batches, 1)
        train_acc = tot_correct / max(tot_count, 1)

        # validation (train.py:404-442)
        val_loss_sum = val_correct = val_count = 0.0
        n_val = 0
        for batch in val_loader:
            out = eval_step(state, batch)
            logits = out["logits"].float().cpu().numpy()
            labels = np.asarray(batch["labels"]).reshape(-1)
            if "valid" in batch:  # drop the pads of a partial batch
                keep = np.asarray(batch["valid"]).reshape(-1) > 0
                logits, labels = logits[keep], labels[keep]
            val_loss_sum += float(out["loss"])
            val_correct += int(((1 / (1 + np.exp(-logits)) >= 0.5) == (labels >= 0.5)).sum())
            val_count += len(labels)
            n_val += 1
        val_loss = val_loss_sum / max(n_val, 1)
        val_acc = val_correct / max(val_count, 1)

        print(f"epoch {epoch}: train_loss {train_loss:.4f} acc {train_acc:.4f} "
              f"| val_loss {val_loss:.4f} acc {val_acc:.4f}")
        logger.add_scalar("Training/Loss", train_loss, epoch)
        logger.add_scalar("Training/Accuracy", train_acc, epoch)
        logger.add_scalar("Training/Learning_Rate", state.schedule(state.step), epoch)
        logger.add_scalar("Validation/Loss", val_loss, epoch)
        logger.add_scalar("Validation/Accuracy", val_acc, epoch)

        if previous_loss <= val_loss:  # train.py:124-128
            not_improved += 1
        else:
            not_improved = 0
            result.best_val_loss = val_loss
            result.checkpoints.append(save_train_state(models_output_path, state, step=epoch))
        previous_loss = val_loss
        result.epochs_run = epoch + 1

    logger.close()
    return state, result
