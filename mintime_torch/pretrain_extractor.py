"""Frame-level extractor pretraining (counterpart of
``mintime_tpu/pretrain_extractor.py``).

* :class:`FrameClassifier` (:mod:`mintime_torch.models.frame_classifier`):
  EfficientNet-B0 + pooled linear head, one logit a frame;
* :func:`rebalance_frames`: class rebalancing by sampling fraction;
* :func:`custom_video_round`: video aggregation, any frame prob > 0.55 ⇒
  that prob, else the mean;
* :func:`collect_frames`: the face-0 crops of each video (a PNG tree or the
  names a ``crops.pack`` rebuilds), interval-subsampled per class;
* :class:`FramesDataset` (:mod:`mintime_torch.data.frames`);
* :func:`export_extractor`: the trained backbone as a reference-key
  ``Extractor_checkpoint`` state_dict, which
  :func:`mintime_torch.utils.checkpoint.load_model_state` (and the JAX
  package's ``efficientnet_params_from_torch``) reads;
* ``python -m mintime_torch.pretrain_extractor``: :func:`main`, the JAX
  CLI's flags plus ``--device``; under ``torchrun`` data-parallel.

The module imports torch inside its functions only (``FrameClassifier`` is
imported on first use), so the loader's spawned workers start without it.
"""

from __future__ import annotations

import os
import random
from typing import Sequence

import numpy as np

from mintime_torch.config import MintimeConfig
from mintime_torch.data.frames import FramesDataset, pack_crop_names

__all__ = ["FrameClassifier", "FramesDataset", "collect_frames", "custom_video_round",
           "export_extractor", "main", "rebalance_frames"]


def __getattr__(name):
    if name == "FrameClassifier":
        from mintime_torch.models.frame_classifier import FrameClassifier

        return FrameClassifier
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def rebalance_frames(
    paths: Sequence[str],
    labels: Sequence[int],
    rebalancing_real: float = 1.0,
    rebalancing_fake: float = 0.3,
    seed: int = 42,
) -> tuple[list[str], list[int]]:
    """Subsample each class by its rebalancing fraction
    (cross-efficient-vit/train.py:44-122 sampling behavior)."""
    rnd = random.Random(seed)
    out_p, out_l = [], []
    by_class = {0: [], 1: []}
    for p, l in zip(paths, labels):
        by_class[int(l)].append(p)
    for cls, frac in ((0, rebalancing_real), (1, rebalancing_fake)):
        keep = rnd.sample(by_class[cls], int(len(by_class[cls]) * frac))
        out_p += keep
        out_l += [cls] * len(keep)
    order = list(range(len(out_p)))
    rnd.shuffle(order)
    return [out_p[i] for i in order], [out_l[i] for i in order]


def custom_video_round(frame_probs: Sequence[float], threshold: float = 0.55) -> float:
    """Any frame above threshold ⇒ that prob; else mean
    (cross-efficient-vit/utils.py:79-83)."""
    probs = np.asarray(frame_probs, dtype=np.float64)
    for p in probs:
        if p > threshold:
            return float(p)
    return float(probs.mean()) if len(probs) else 0.0


def export_extractor(model, path: str) -> None:
    """Save a trained model's extractor (the ``extractor.`` submodule of a
    :class:`FrameClassifier` or a classifier) as a reference-key fp32 torch
    state dict, the ``Extractor_checkpoint*`` format, with ``torch.save``."""
    import torch

    sd = {k[len("extractor."):]: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in model.state_dict().items() if k.startswith("extractor.")}
    torch.save(sd, path)


def _video_crops(video_dir: str) -> list[str]:
    """The video's face-0 crop paths as ``sorted(glob("**/*_0.png"))`` gives
    them; for a video packed without its PNGs, the names its ``crops.pack``
    rebuilds, sorted the same way."""
    import glob

    from mintime_torch.data.crop_store import CropPack, find_pack

    faces = sorted(glob.glob(os.path.join(video_dir, "**", "*_0.png"), recursive=True))
    pack = find_pack(video_dir) if not faces else None
    if pack:
        faces = sorted(os.path.join(video_dir, n) for n in pack_crop_names(CropPack(pack))
                       if n.endswith("_0.png"))
    return faces


def collect_frames(
    videos: Sequence[str],
    labels: Sequence[float],
    data_path: str,
    frames_per_video: int = 30,
    rebalancing_real: float = 1.0,
    rebalancing_fake: float = 0.3,
    validation: bool = False,
) -> tuple[list[str], list[float]]:
    """Per-video frame-path sampling with class rebalancing, as the JAX
    function does it: per video, ``min_frames = max(int(frames_per_video *
    rebalancing[label]), 1)`` (validation: ``int(max(min_frames / 8, 2))``),
    then an interval subsample of the face-0 crops, which spreads the kept
    crops over the video (the reference keeps the first ones; PARITY.md)."""
    out_p: list[str] = []
    out_l: list[float] = []
    for video, label in zip(videos, labels):
        rebal = rebalancing_real if int(label) == 0 else rebalancing_fake
        min_frames = max(int(frames_per_video * rebal), 1)
        if validation:
            min_frames = int(max(min_frames / 8, 2))
        faces = _video_crops(os.path.join(data_path, video))
        if not faces:
            continue
        interval = len(faces) // min_frames
        if interval > 1:
            faces = faces[::interval]
        faces = faces[:min_frames]
        out_p += faces
        out_l += [float(label)] * len(faces)
    return out_p, out_l


def video_round_accuracy(paths: Sequence[str], probs: Sequence[float], data_path: str,
                         video_labels: dict) -> tuple[float, bool]:
    """``custom_video_round`` accuracy of frame probabilities grouped by the
    manifest video each path lies under (names may be nested, ``method/
    video_id``: each path is matched against the known names component-prefix
    -wise); and whether any path matched a name."""
    by_video: dict = {}
    depths = sorted({len(v.split(os.sep)) for v in video_labels} or {1})
    for path, prob in zip(paths, probs):
        parts = os.path.relpath(path, data_path).split(os.sep)
        key = next((os.sep.join(parts[:d]) for d in depths
                    if os.sep.join(parts[:d]) in video_labels), parts[0])
        by_video.setdefault(key, []).append(prob)
    vids = vcorrect = 0
    for key, p in by_video.items():
        if key not in video_labels:
            continue
        vids += 1
        vcorrect += int((custom_video_round(p) > 0.55) == (video_labels[key] == 1))
    matched = not by_video or bool(by_video.keys() & video_labels.keys())
    return vcorrect / max(vids, 1), matched


def main(argv=None, config: MintimeConfig | None = None):
    """Frame-level extractor pretraining CLI
    (cross-efficient-vit/train.py:126-322 parity): the MINTIME manifests and
    faces layout, :class:`FrameClassifier` trained with BCE/pos_weight and
    SGD/StepLR from the yaml, early stop on the validation loss,
    ``custom_video_round`` video accuracy, a checkpoint and an
    ``Extractor_checkpoint<epoch>`` at each improvement. ``config`` stands in
    for the ``--config`` file, for a caller without yaml. Returns the path
    of the last exported extractor."""
    import argparse
    import contextlib
    import math

    p = argparse.ArgumentParser("mintime-torch extractor pretraining")
    p.add_argument("--config", default="configs/extractor_pretraining.yaml")
    p.add_argument("--train_list_file", required=True)
    p.add_argument("--validation_list_file", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--num_epochs", type=int, default=300)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--max_videos", type=int, default=-1)
    p.add_argument("--models_output_path", default="models_out")
    p.add_argument("--random_state", type=int, default=42)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)

    import torch

    from mintime_torch.config import load_config
    from mintime_torch.data.loader import DataLoader
    from mintime_torch.data.manifest import load_manifest
    from mintime_torch.device import resolve_device
    from mintime_torch.models.frame_classifier import FrameClassifier
    from mintime_torch.parallel.mesh import axis_rank, axis_size, barrier, gather_rows, is_main, \
        launch_mesh
    from mintime_torch.train import create_train_state, make_eval_step, make_train_step
    from mintime_torch.utils.checkpoint import save_train_state

    mesh = launch_mesh(opt.device)
    dev = resolve_device(opt.device)
    say = print if is_main(mesh) else (lambda *a, **k: None)
    shard = None if mesh is None else (axis_rank(mesh), axis_size(mesh))
    cfg = config if config is not None else load_config(opt.config)
    t = cfg.training
    train_man = load_manifest(opt.train_list_file, data_path=opt.data_path,
                              max_videos=opt.max_videos)
    val_man = load_manifest(opt.validation_list_file, data_path=opt.data_path,
                            max_videos=opt.max_videos)
    tr_p, tr_l = collect_frames(train_man.videos, train_man.labels, opt.data_path,
                                t.frames_per_video, t.rebalancing_real, t.rebalancing_fake)
    va_p, va_l = collect_frames(val_man.videos, val_man.labels, opt.data_path,
                                t.frames_per_video, t.rebalancing_real, t.rebalancing_fake,
                                validation=True)
    pos = sum(1 for l in tr_l if l == 1)
    neg = len(tr_l) - pos
    pos_weight = neg / max(pos, 1)  # class_weights (train.py:203)
    say(f"Train images: {len(tr_p)} Validation images: {len(va_p)} "
        f"(0s: {neg} 1s: {pos}) pos_weight {pos_weight:.4f}")

    def dataset(paths, labels, mode):
        return FramesDataset(paths, labels, cfg.model.image_size, mode=mode,
                             augmentation=t.augmentation, seed=opt.random_state, device=dev)

    model = FrameClassifier(device=dev, param_dtype=torch.float32, seed=opt.random_state)
    vlabels = dict(zip(val_man.videos, val_man.labels))
    os.makedirs(opt.models_output_path, exist_ok=True)
    not_improved, previous, best_path = 0, math.inf, None
    with contextlib.ExitStack() as stack:
        train_loader = stack.enter_context(DataLoader(
            dataset(tr_p, tr_l, "train"), t.bs, num_workers=opt.workers, seed=opt.random_state,
            drop_last=True, shard=shard, pad_short=True))
        val_loader = stack.enter_context(DataLoader(
            dataset(va_p, va_l, "val"), t.bs, shuffle=False, num_workers=opt.workers,
            drop_last=True, shard=shard))
        state = create_train_state(model, cfg, steps_per_epoch=len(train_loader),
                                   num_epochs=opt.num_epochs, seed=opt.random_state)
        train_step = make_train_step(model, pos_weight, mesh=mesh)
        eval_step = make_eval_step(model, pos_weight, mesh=mesh)
        for epoch in range(opt.num_epochs + 1):
            if not_improved == opt.patience:
                break
            metrics = [train_step(state, batch) for batch in train_loader]
            tot = sum(float(m["loss"]) for m in metrics)
            correct = sum(int(m["correct"]) for m in metrics)
            count = sum(int(m["count"]) for m in metrics)
            train_loss = tot / max(len(train_loader), 1)
            train_acc = correct / max(count, 1)

            # frame-level val loss + custom_video_round video accuracy
            vtot, logits = 0.0, []
            for batch in val_loader:
                out = eval_step(state, batch)
                vtot += float(out["loss"])
                logits.append(out["logits"].float().cpu().numpy())
            all_probs = [float(x) for x in 1 / (1 + np.exp(-np.concatenate(
                gather_rows(mesh, logits) or [np.zeros(0)])))]
            val_loss = vtot / max(len(val_loader), 1)
            video_acc, matched = video_round_accuracy(va_p[:len(all_probs)], all_probs,
                                                      opt.data_path, vlabels)
            if not matched:
                say("warning: no frame path maps to a manifest video name; "
                    "video_round_acc will be 0 (check --data_path layout)")
            say(f"#{epoch}/{opt.num_epochs} loss:{train_loss:.4f} "
                f"accuracy:{train_acc:.4f} val_loss:{val_loss:.4f} "
                f"video_round_acc:{video_acc:.4f}")

            if previous <= val_loss:
                not_improved += 1
            else:
                not_improved = 0
                best_path = os.path.join(opt.models_output_path, f"Extractor_checkpoint{epoch}")
                if is_main(mesh):
                    save_train_state(opt.models_output_path, state, step=epoch)
                    export_extractor(model, best_path)
                barrier(mesh)
            previous = val_loss
    if best_path:
        say(f"best extractor exported: {best_path}")
    return best_path


if __name__ == "__main__":
    main()
