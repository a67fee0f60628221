"""Dataset evaluation, the reference's ``test.py`` (counterpart of
``mintime_tpu/evaluate.py:22-291``).

A split list and a faces tree (PNG folders or ``crops.pack`` shards) go
through :class:`~mintime_torch.data.dataset.DeepfakesDataset` and
:class:`~mintime_torch.data.loader.DataLoader` (file work in spawned
workers, the evaluation transform on the model's device), the classifier's
forward (the CUDA kernels on the card), then host-side metrics: loss, F1,
accuracy, AUC and per-method errors (test.py:271-290), with the
``--only_multiidentity`` filter (test.py:169-184) and the attention plots
(test.py:248-254).

``python -m mintime_torch.evaluate`` runs :func:`main`, which parses the
JAX CLI's flags plus ``--device``, reads the yaml config and calls
:func:`evaluate_split`; that function takes the config object, so a caller
without yaml builds one in code.

The module imports torch inside its functions only: a spawned loader
worker runs the parent's main module again (multiprocessing's spawn does),
and that module is this one under ``python -m``, so the workers start
without torch.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Mapping, Sequence

from typing import TYPE_CHECKING

import numpy as np

from mintime_torch.config import MintimeConfig
from mintime_torch.utils.metrics import evaluation_report

if TYPE_CHECKING:
    import torch


def filter_multi_identity(videos: Sequence[str], data_path: str) -> list[int]:
    """Indices of the videos with more than one identity (test.py:169-184):
    identity folders, or a pack header's identities where the folders were
    packed away."""
    from mintime_torch.data.crop_store import CropPack, find_pack

    keep = []
    for i, video in enumerate(videos):
        vdir = os.path.join(data_path, video)
        try:
            n_ids = sum(os.path.isdir(os.path.join(vdir, e)) for e in os.listdir(vdir))
        except OSError:
            continue
        if n_ids == 0:
            pack = find_pack(vdir)
            if pack:
                n_ids = len({e[0] for e in CropPack(pack).entries if e[0] is not None})
        if n_ids > 1:
            keep.append(i)
    return keep


def _bce_np(logits, labels) -> float:
    """BCEWithLogitsLoss on the host, the train step's formula at
    ``pos_weight`` 1."""
    x = logits.astype(np.float32).reshape(-1)
    y = labels.astype(np.float32).reshape(-1)
    per = (1.0 - y) * x + np.logaddexp(0.0, -x)
    return float(per.mean())


def _forward(model, state: Mapping[str, torch.Tensor] | None, batch: Mapping[str, Any]):
    """``(logits (B,) numpy, attention maps or None)`` of one batch; ``state``
    replaces the model's parameters and buffers through
    ``torch.func.functional_call``."""
    import torch

    from mintime_torch.train import model_inputs

    with torch.inference_mode():
        inputs = model_inputs(batch, model.head_kind, model.device)
        out = model(*inputs) if state is None else \
            torch.func.functional_call(model, dict(state), inputs)
    logits, attns = out if isinstance(out, tuple) else (out, None)
    return logits.float().cpu().numpy().reshape(-1), attns


def evaluate(
    model,
    state: Mapping[str, torch.Tensor] | None,
    loader,
    save_attention_plots: bool = False,
    heads: int = 8,
    num_frames: int = 16,
    num_patches: int = 49,
) -> dict:
    """The test.py report of the model over a loader's batches: the metrics
    of :func:`~mintime_torch.utils.metrics.evaluation_report`, ``loss`` (the
    mean of the batches' mean losses) and ``n_videos``."""
    all_logits, all_labels, all_mc, losses = [], [], [], []
    for batch in loader:
        logits, attns = _forward(model, state, batch)
        if save_attention_plots and attns is not None:
            _plot_batch_attention(batch, [a.float().cpu().numpy() for a in attns], heads,
                                  num_frames, num_patches)
        labels = np.asarray(batch["labels"]).reshape(-1)
        losses.append(_bce_np(logits, labels))
        all_logits.append(logits)
        all_labels.append(labels)
        if "multiclass_label" in batch:
            all_mc.append(np.asarray(batch["multiclass_label"]).reshape(-1))

    logits = np.concatenate(all_logits) if all_logits else np.zeros(0)
    labels = np.concatenate(all_labels) if all_labels else np.zeros(0)
    mc = np.concatenate(all_mc) if all_mc else None
    report = evaluation_report(logits, labels, mc)
    report["loss"] = float(np.mean(losses)) if losses else float("nan")
    report["n_videos"] = int(len(labels))
    return report


def _plot_batch_attention(batch, attns, heads, num_frames, num_patches):
    from mintime_torch.utils.attention_viz import aggregate_attentions, save_attention_plots

    tpi = batch.get("tokens_per_identity")
    vids = batch.get("video_id")
    if not tpi or not vids:
        return
    for b, (per_id, vid) in enumerate(zip(tpi, vids)):
        names = [name for name, _ in per_id]
        frames_per_identity = [int(tokens / num_patches) for _, tokens in per_id]
        batch_attns = [a[b * heads:(b + 1) * heads] for a in attns]
        agg, _ = aggregate_attentions(batch_attns, heads, num_frames, frames_per_identity)
        save_attention_plots(agg, names, frames_per_identity, num_frames, vid)


def build_model(cfg: MintimeConfig, model_weights: str, extractor_weights: str | None = None,
                model: int = 1, extractor_model: int = 0, require_attention: bool = False,
                use_kernels: bool | None = None, device: str | torch.device = "cuda",
                dtype: torch.dtype | None = None):
    """The model ``--model`` names with its weights from files, fp32
    parameters computing in ``dtype`` (bf16, as the JAX CLI's): 0 the
    baseline head, 1 the Size-Invariant TimeSformer (each on EfficientNet-B0
    for ``extractor_model`` 0, Xception for 1; reference ``.pth`` files or
    the port's checkpoint), 2 SlowFast R-50 (a pytorchvideo ``slowfast_r50``
    state_dict or the port's checkpoint; no hand-written kernel), 3 the
    Convolutional TimeSformer (the port's checkpoint). ``use_kernels``
    defaults to on for the card, off for the CPU; ``dtype`` to bf16."""
    import torch

    from mintime_torch.device import resolve_device
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer
    from mintime_torch.models.slowfast import SlowFastClassifier
    from mintime_torch.utils.checkpoint import load_model_state

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    kernels = dev.type == "cuda" if use_kernels is None else bool(use_kernels)
    if model == 2:  # the class's front end, as mintime_tpu/evaluate.py:213-217 builds it
        net = SlowFastClassifier(num_classes=cfg.model.num_classes, device=dev, dtype=dtype,
                                 param_dtype=torch.float32)
    elif model == 3:
        net = ConvolutionalTimeSformer(cfg.model, use_kernels=kernels, device=dev, dtype=dtype,
                                       param_dtype=torch.float32)
    elif model in (0, 1):
        net = MintimeVideoClassifier(
            cfg.model, backbone="efficientnet-b0" if extractor_model == 0 else "xception",
            head="baseline" if model == 0 else "timesformer", require_attention=require_attention,
            use_kernels=kernels, device=dev, dtype=dtype, param_dtype=torch.float32)
    else:
        raise ValueError(f"unknown --model {model}: 0 baseline, 1 TimeSformer, 2 SlowFast, "
                         "3 Convolutional TimeSformer")
    net.load_state_dict(load_model_state(net, cfg, model_weights, extractor_weights))
    return net


def split_loader(cfg: MintimeConfig, videos: Sequence[str], labels: Sequence[float],
                 multiclass: Sequence[float] | None, data_path: str, batch_size: int,
                 workers: int = 4, video_path: str | None = None, identities_ordering: int = 0,
                 random_state: int = 42, device: str | torch.device = "cuda"):
    """The test-mode dataset of the videos in a :class:`DataLoader`, in
    order; use it in a ``with`` block, which stops its workers."""
    from mintime_torch.data.dataset import DeepfakesDataset
    from mintime_torch.data.loader import DataLoader

    m = cfg.model
    ds = DeepfakesDataset(
        videos, labels, data_path=data_path, image_size=m.image_size, num_frames=m.num_frames,
        num_patches=m.num_patches, max_identities=m.max_identities, mode="test",
        identities_ordering=identities_ordering, multiclass_labels=multiclass,
        video_path=video_path, seed=random_state, device=device)
    return DataLoader(ds, batch_size=batch_size, shuffle=False, num_workers=workers)


def evaluate_split(cfg: MintimeConfig, model_weights: str, test_list_file: str, data_path: str,
                   extractor_weights: str | None = None, video_path: str | None = None,
                   model: int = 1, extractor_model: int = 0, only_multiidentity: bool = False,
                   save_attentions: bool = False, identities_ordering: int = 0,
                   batch_size: int | None = None, workers: int = 4,
                   deepfake_methods: Sequence[int] | None = None, max_videos: int = -1,
                   random_state: int = 42, fused_attention: int | None = None,
                   device: str | torch.device = "cuda") -> dict:
    """The CLI's work for a config object: the split list's videos (pruned,
    filtered, cut and, with ``only_multiidentity``, those of more than one
    identity), the model from its weight files, the report over the split."""
    from mintime_torch.data.manifest import load_manifest
    from mintime_torch.device import resolve_device

    man = load_manifest(test_list_file, data_path=data_path, deepfake_methods=deepfake_methods,
                        max_videos=max_videos, shuffle_seed=random_state)
    videos, labels, mc = man.videos, man.labels, man.multiclass
    if only_multiidentity:
        keep = filter_multi_identity(videos, data_path)
        videos = [videos[i] for i in keep]
        labels = [labels[i] for i in keep]
        mc = [mc[i] for i in keep]
    dev = resolve_device(device)
    net = build_model(cfg, model_weights, extractor_weights, model=model,
                      extractor_model=extractor_model, require_attention=save_attentions,
                      use_kernels=None if fused_attention is None else bool(fused_attention),
                      device=dev)
    with split_loader(cfg, videos, labels, mc, data_path, batch_size or cfg.test.bs, workers,
                     video_path, identities_ordering, random_state, dev) as loader:
        return evaluate(net, None, loader, save_attention_plots=save_attentions,
                        heads=cfg.model.heads, num_frames=cfg.model.num_frames,
                        num_patches=cfg.model.num_patches)


def main(argv=None):
    from mintime_torch.config import load_config

    p = argparse.ArgumentParser("mintime-torch evaluate (test.py parity)")
    p.add_argument("--config", default="configs/size_invariant_timesformer.yaml")
    p.add_argument("--model_weights", required=True,
                   help="the reference's Model_checkpoint file or the port's checkpoint")
    p.add_argument("--extractor_weights", default=None)
    p.add_argument("--test_list_file", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--video_path", default=None,
                   help="root of the original .mp4s for size buckets when no"
                        " video_dims.json sidecars exist (test.py:47)")
    p.add_argument("--model", type=int, default=1,
                   help="0 baseline | 1 timesformer | 2 slowfast | 3 conv-timesformer")
    p.add_argument("--extractor_model", type=int, default=0, help="0 effnet | 1 xception")
    p.add_argument("--only_multiidentity", action="store_true", default=False)
    p.add_argument("--save_attentions", action="store_true", default=False)
    p.add_argument("--identities_ordering", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--deepfake_methods", type=int, nargs="*", default=None,
                   help="keep only these 8_cls method ids (test.py parity)")
    p.add_argument("--max_videos", type=int, default=-1)
    p.add_argument("--random_state", type=int, default=42,
                   help="seeds per-sample RNG (identities_ordering=2) and the numpy "
                        "shuffle-before-truncate that picks the --max_videos subset")
    p.add_argument("--fused_attention", type=int, choices=(0, 1), default=None,
                   help="the CUDA kernels: on by default on the card, off on the CPU "
                        "(where the kernel path runs their plain versions)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = vars(p.parse_args(argv))
    cfg = load_config(opt.pop("config"))
    report = evaluate_split(cfg, **opt)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
