"""Training loop and command line: epochs, validation, early stopping,
checkpoints, logs (counterpart of ``mintime_tpu/train_loop.py``).

:func:`fit` runs epochs ``starting_epoch`` to ``num_epochs`` (so
``num_epochs + 1`` from 0) over any iterables of batch dicts (numpy arrays or
tensors under the keys of :func:`mintime_torch.train.model_inputs`, plus
``labels`` and optionally ``valid``), validates after each, saves a
``checkpoint_<epoch>`` when the validation loss improves, stops after
``patience`` epochs without improvement, and logs the reference's scalar
tags (``Training/Loss``, ``Training/Accuracy``, ``Training/Learning_Rate``,
``Validation/Loss``, ``Validation/Accuracy``).

``python -m mintime_torch.train_loop`` runs :func:`main`: the JAX CLI's
flags plus ``--device``; manifests and a faces tree on disk through the
train- and val-mode :class:`~mintime_torch.data.dataset.DeepfakesDataset`
and the port's :class:`~mintime_torch.data.loader.DataLoader`, any
``--model`` (0 baseline, 1 TimeSformer, 2 SlowFast, 3 Convolutional
TimeSformer), and resumption from the last checkpoint. Under ``torchrun
--nproc_per_node N -m mintime_torch.train_loop ...`` (``WORLD_SIZE`` in the
environment) it trains data-parallel over a mesh
(:mod:`mintime_torch.parallel.mesh`): each rank loads and steps its rows of
every global batch, rank 0 alone prints, logs and writes checkpoints, and
every rank resumes from the same file. The module imports torch inside its
functions only: a spawned loader worker runs the parent's main module again,
and under ``python -m`` that is this one.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from mintime_torch.config import MintimeConfig

if TYPE_CHECKING:
    from mintime_torch.train import TrainState


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
        log_dir: str = "runs/exp", log_every: int = 100,
        starting_epoch: int = 0, mesh=None) -> tuple[TrainState, FitResult]:
    """Run the training loop from epoch ``starting_epoch``; returns (state,
    FitResult). Step metrics stay on the device and are read once per
    ``log_every`` steps, with the pass's progress and ETA (the loader's
    length, where it has one). With a ``mesh`` the loaders give this data
    rank's rows, the steps' metrics are the global batches', the validation
    counts are summed over the ranks, and rank 0 alone prints, logs and
    writes the checkpoints (the others wait for each write)."""
    from mintime_torch.parallel.mesh import all_sum, barrier, is_main
    from mintime_torch.train import make_eval_step, make_train_step
    from mintime_torch.utils.checkpoint import save_train_state

    import torch

    train_step = make_train_step(state.model, pos_weight, mesh=mesh)
    eval_step = make_eval_step(state.model, pos_weight, mesh=mesh)
    main_rank = is_main(mesh)
    logger = ScalarLogger(log_dir) if main_rank else None
    not_improved = 0
    previous_loss = math.inf
    result = FitResult(best_val_loss=math.inf, epochs_run=0)

    for epoch in range(starting_epoch, num_epochs + 1):
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

        total = len(train_loader) if hasattr(train_loader, "__len__") else None
        n_batches = 0
        for batch in train_loader:
            pending.append(train_step(state, batch))
            n_batches += 1
            if n_batches % log_every == 0 and main_rank:
                drain()
                elapsed = time.time() - t0
                eta = f"ETA {elapsed / n_batches * (total - n_batches):.0f}s" if total \
                    else f"{elapsed:.0f}s"
                print(f"epoch {epoch} [{n_batches}/{total or '?'}] "
                      f"loss {tot_loss / n_batches:.4f} "
                      f"acc {tot_correct / max(tot_count, 1):.4f} pos {int(tot_pos)} "
                      f"neg {int(tot_count - tot_pos)} {eta}")
        drain()
        train_loss = tot_loss / max(n_batches, 1)
        train_acc = tot_correct / max(tot_count, 1)

        # validation (train.py:404-442)
        val_loss_sum = val_correct = val_count = 0.0
        n_val = 0
        for batch in val_loader:
            out = eval_step(state, batch)
            logits = out["logits"].float().cpu().numpy()
            labels = np.asarray(batch.get("labels", np.zeros(0))).reshape(-1)
            if "valid" in batch:  # drop the pads of a partial batch
                keep = np.asarray(batch["valid"]).reshape(-1) > 0
                logits, labels = logits[keep], labels[keep]
            val_loss_sum += float(out["loss"])
            val_correct += int(((1 / (1 + np.exp(-logits)) >= 0.5) == (labels >= 0.5)).sum())
            val_count += len(labels)
            n_val += 1
        if mesh is not None:
            val_correct, val_count = (int(v) for v in all_sum(
                mesh, torch.tensor([val_correct, val_count], dtype=torch.int64,
                                   device=state.model.device)).cpu())
        val_loss = val_loss_sum / max(n_val, 1)
        val_acc = val_correct / max(val_count, 1)

        if main_rank:
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
            path = os.path.join(os.path.abspath(models_output_path), f"checkpoint_{epoch}")
            if main_rank:
                path = save_train_state(models_output_path, state, step=epoch)
            barrier(mesh)
            result.checkpoints.append(path)
        previous_loss = val_loss
        result.epochs_run = epoch + 1

    if logger is not None:
        logger.close()
    return state, result


def build_training_model(model: int, cfg: MintimeConfig, extractor_model: int = 0,
                         freeze_backbone: bool = False, use_kernels: bool = True,
                         device="cuda", seed: int = 0):
    """The model ``--model`` names as the JAX train state holds it: fp32
    parameters and BatchNorm statistics, computing in bf16 on the card (fp32
    on the CPU), weights drawn from ``seed``. 0 the baseline head and 1 the
    Size-Invariant TimeSformer, each on EfficientNet-B0 (``extractor_model``
    0) or Xception (1); 2 SlowFast R-50; 3 the Convolutional TimeSformer.
    ``use_kernels`` routes the TimeSformers' attention and FFNs through the
    CUDA kernels (the baseline and SlowFast have none)."""
    import torch

    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer
    from mintime_torch.train import slowfast_training_model

    if model == 2:
        return slowfast_training_model(cfg.model, device=device, seed=seed)
    if model == 3:
        return ConvolutionalTimeSformer(cfg.model, use_kernels=use_kernels, device=device,
                                        param_dtype=torch.float32, seed=seed)
    if model not in (0, 1):
        raise ValueError(f"unknown --model {model}: 0 baseline, 1 TimeSformer, 2 SlowFast, "
                         "3 Convolutional TimeSformer")
    head = "baseline" if model == 0 else "timesformer"
    return MintimeVideoClassifier(
        cfg.model, backbone="efficientnet-b0" if extractor_model == 0 else "xception", head=head,
        freeze_backbone=freeze_backbone, use_kernels=use_kernels and head == "timesformer",
        device=device, param_dtype=torch.float32, seed=seed)


def main(argv=None, config: MintimeConfig | None = None) -> FitResult:
    """The training CLI (``mintime_tpu/train_loop.py:191-339``). ``config``
    stands in for the ``--config`` file, for a caller without yaml."""
    import argparse
    import contextlib
    import sys

    p = argparse.ArgumentParser("mintime-torch train (train.py parity)")
    p.add_argument("--config", default="configs/size_invariant_timesformer.yaml")
    p.add_argument("--model", type=int, default=1,
                   help="0 baseline | 1 timesformer | 2 slowfast | 3 conv-timesformer")
    p.add_argument("--extractor_model", type=int, default=0, help="0 effnet | 1 xception")
    # parsed and never read, as by the JAX CLI (ROADMAP.md queue 3 item 4)
    p.add_argument("--extractor_weights", default=None)
    p.add_argument("--freeze_backbone", action="store_true", default=False)
    p.add_argument("--extractor_unfreeze_blocks", type=int, default=-1,
                   help="train only the extractor's last k blocks (train.py:152-170)")
    p.add_argument("--train_list_file", required=True)
    p.add_argument("--validation_list_file", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--video_path", default=None,
                   help="root of the original .mp4s for size buckets when no"
                        " video_dims.json sidecars exist (train.py:50)")
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--resume", default="")
    p.add_argument("--random_state", type=int, default=42)
    p.add_argument("--models_output_path", default="models_out")
    p.add_argument("--logger_name", default="runs/train")
    p.add_argument("--identities_ordering", type=int, default=0)
    p.add_argument("--deepfake_methods", type=int, nargs="*", default=None,
                   help="keep only these 8_cls method ids (train.py:217-224)")
    p.add_argument("--max_videos", type=int, default=-1)
    p.add_argument("--restore_epoch", action="store_true", default=False,
                   help="parse the starting epoch out of the resume filename")
    p.add_argument("--errors_logs_file", default=None)
    p.add_argument("--fused_attention", type=int, choices=(0, 1), default=None,
                   help="the CUDA kernels: on by default on the card, off on the CPU "
                        "(where the kernel path runs their plain versions)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)
    if opt.errors_logs_file:  # stderr redirect (train.py:96-98)
        sys.stderr = open(opt.errors_logs_file, "w")
    from mintime_torch.parallel.mesh import launch_mesh

    mesh = launch_mesh(opt.device)

    from mintime_torch.config import load_config
    from mintime_torch.data.dataset import DeepfakesDataset
    from mintime_torch.data.loader import DataLoader
    from mintime_torch.data.manifest import load_manifest
    from mintime_torch.device import resolve_device
    from mintime_torch.parallel.mesh import axis_rank, axis_size, is_main
    from mintime_torch.train import create_train_state, extractor_unfreeze_mask, \
        pos_weight_from_labels
    from mintime_torch.utils.checkpoint import epoch_from_name, latest_checkpoint, \
        restore_train_state

    cfg = config if config is not None else load_config(opt.config)
    dev = resolve_device(opt.device)
    say = print if is_main(mesh) else (lambda *a, **k: None)
    shard = None if mesh is None else (axis_rank(mesh), axis_size(mesh))
    train_man = load_manifest(opt.train_list_file, data_path=opt.data_path,
                              deepfake_methods=opt.deepfake_methods, max_videos=opt.max_videos)
    val_man = load_manifest(opt.validation_list_file, data_path=opt.data_path,
                            max_videos=opt.max_videos)
    pos_weight = pos_weight_from_labels(train_man.labels)
    say(f"Train videos: {len(train_man)} Validation videos: {len(val_man)} "
        f"pos_weight {pos_weight:.4f}")

    m = cfg.model

    def dataset(man, mode):
        return DeepfakesDataset(
            man.videos, man.labels, data_path=opt.data_path, image_size=m.image_size,
            num_frames=m.num_frames, num_patches=m.num_patches, max_identities=m.max_identities,
            mode=mode, augmentation=cfg.training.augmentation,
            identities_ordering=opt.identities_ordering, seed=opt.random_state,
            video_path=opt.video_path, device=dev)

    kernels = dev.type == "cuda" if opt.fused_attention is None else bool(opt.fused_attention)
    model = build_training_model(opt.model, cfg, opt.extractor_model, opt.freeze_backbone,
                                 kernels, dev, opt.random_state)
    trainable_mask = None
    if opt.extractor_unfreeze_blocks > -1 and not opt.freeze_backbone:
        trainable_mask = extractor_unfreeze_mask(opt.extractor_unfreeze_blocks)
    with contextlib.ExitStack() as stack:
        train_loader = stack.enter_context(DataLoader(
            dataset(train_man, "train"), cfg.training.bs, num_workers=opt.workers,
            seed=opt.random_state, shard=shard, pad_short=True))
        val_loader = stack.enter_context(DataLoader(
            dataset(val_man, "val"), cfg.training.val_bs, shuffle=False,
            num_workers=opt.workers, shard=shard))
        state = create_train_state(model, cfg, steps_per_epoch=len(train_loader),
                                   num_epochs=opt.num_epochs, trainable_mask=trainable_mask,
                                   seed=opt.random_state)
        starting_epoch = 0
        resume = opt.resume or latest_checkpoint(opt.models_output_path)
        if resume and os.path.exists(resume):
            state = restore_train_state(resume, state)
            if opt.restore_epoch or not opt.resume:  # auto-resume keeps its epoch
                starting_epoch = epoch_from_name(resume) + 1
            say(f"resumed {resume} at epoch {starting_epoch}")
        state, result = fit(state, train_loader, val_loader, cfg, num_epochs=opt.num_epochs,
                            patience=opt.patience, pos_weight=pos_weight,
                            models_output_path=opt.models_output_path,
                            log_dir=opt.logger_name, starting_epoch=starting_epoch, mesh=mesh)
    say(f"best val loss {result.best_val_loss:.4f} after {result.epochs_run} epochs")
    return result


if __name__ == "__main__":
    main()
