"""Checkpoints of the whole train state and the reference's weight files
(counterpart of ``mintime_tpu/utils/checkpoint.py:19-151``).

A checkpoint holds what the JAX package's holds: the parameters, the
BatchNorm statistics, the optimizer state and the step, here in one
``torch.save`` file named ``checkpoint_<step>`` (the epoch, when the training
loop saves it). :func:`load_model_state` also reads the reference's
``Model_checkpoint*`` / ``Extractor_checkpoint*`` files for serving.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch


def save_train_state(ckpt_dir: str, state, step: int | None = None) -> str:
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    step = state.step if step is None else step
    path = os.path.join(ckpt_dir, f"checkpoint_{step}")
    model = state.model
    payload = {
        "params": {k: v.detach().cpu() for k, v in model.named_parameters()},
        "batch_stats": {k: v.detach().cpu() for k, v in model.named_buffers()},
        "opt_state": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    return path


def restore_train_state(path: str, state):
    """Load a checkpoint into an existing train state (same model and
    optimizer layout), on the state's devices."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict({**ck["params"], **ck["batch_stats"]}, strict=True)
    state.optimizer.load_state_dict(ck["opt_state"])
    state.step = int(ck["step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The ``checkpoint_<step>`` entry of ``ckpt_dir`` with the largest step."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("checkpoint_"):
            try:
                steps.append((int(name.split("_")[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def epoch_from_name(path: str) -> int:
    """The reference's resume convention: the epoch is the digits after
    ``checkpoint`` in the file name (``train.py:298-304``)."""
    base = os.path.basename(path)
    digits = "".join(c for c in base.split("checkpoint")[-1] if c.isdigit())
    return int(digits) if digits else 0


def strip_prefixes(state_dict: Mapping[str, Any], prefixes=("module.",)) -> dict:
    """Drop DataParallel-style key prefixes (the reference's loose loader)."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def _load_torch_state_dict(path: str) -> dict:
    """A ``.pth`` file's dict: a state_dict, a checkpoint of the port's, or
    the ``state_dict()`` of a pickled module."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def _take(model_sd: Mapping[str, torch.Tensor], prefix: str, file_sd: Mapping[str, Any],
          path: str) -> dict[str, torch.Tensor]:
    """The model's keys under ``prefix`` read from a reference state_dict
    (extra keys such as BatchNorm's ``num_batches_tracked`` or a classifier
    layer are ignored); the reference's oversized embedding tables are cut to
    the rows the model indexes."""
    out = {}
    for key, want in model_sd.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        if name not in file_sd:
            raise KeyError(f"{path} has no {name!r} (needed for {key})")
        t = torch.as_tensor(file_sd[name]).detach().to("cpu", torch.float32)
        if t.dim() == 2 and want.dim() == 2 and t.shape[0] > want.shape[0]:
            t = t[:want.shape[0]]  # pos_emb / size_emb: rows past the model's are never indexed
        if t.shape != want.shape:
            raise ValueError(f"{path}: {name!r} has shape {tuple(t.shape)}, "
                             f"the model wants {tuple(want.shape)}")
        out[key] = t
    return out


def load_model_state(model, cfg, model_weights: str,
                     extractor_weights: str | None = None) -> dict[str, torch.Tensor]:
    """The classifier's state dict (CPU, fp32) from weight files, for
    ``model.load_state_dict`` (counterpart of ``load_model_variables``,
    ``mintime_tpu/utils/checkpoint.py:91-151``). ``model_weights`` is either

    * a checkpoint of the port's own (:func:`save_train_state`): parameters
      and BatchNorm statistics, the extractor's included; or
    * a reference ``Model_checkpoint*`` file: the TimeSformer or baseline
      head's state_dict, with ``extractor_weights`` the reference
      ``Extractor_checkpoint*`` state_dict of the EfficientNet-B0 or the
      Xception backbone; or, for SlowFast, a whole pytorchvideo
      ``slowfast_r50`` state_dict (:func:`_slowfast_state`).

    The port keeps the reference's key names, so no key is converted.
    ``cfg`` is accepted for the JAX signature; the model holds its config.
    """
    if os.path.isdir(model_weights):
        raise ValueError(
            f"{model_weights} is a directory: an orbax checkpoint of the JAX package, which the "
            "port cannot read; pass a checkpoint file of the port's (save_train_state) or the "
            "reference's Model_checkpoint / Extractor_checkpoint .pth files")
    loaded = _load_torch_state_dict(model_weights)
    if "params" in loaded and "batch_stats" in loaded:
        state = {**loaded["params"], **loaded["batch_stats"]}
        return {k: v.to("cpu", torch.float32) for k, v in state.items()}
    if getattr(model, "head_kind", None) == "slowfast":
        return _slowfast_state(model.state_dict(), loaded, model_weights)
    if getattr(model, "head_kind", None) == "conv_timesformer":
        raise ValueError(
            "the Convolutional TimeSformer has no reference checkpoint format; pass a "
            "checkpoint file of the port's own (save_train_state)")
    model_sd = model.state_dict()
    state = _take(model_sd, "head.", strip_prefixes(loaded), model_weights)
    if model.backbone != "none":
        if not extractor_weights:
            raise ValueError(f"the {model.backbone} backbone needs its weights: pass "
                             "extractor_weights (the reference's Extractor_checkpoint file)")
        ext = strip_prefixes(_load_torch_state_dict(extractor_weights),
                             ("module.", "efficient_net."))
        state.update(_take(model_sd, "extractor.", ext, extractor_weights))
    return state


def _slowfast_state(model_sd: Mapping[str, torch.Tensor], file_sd: Mapping[str, Any],
                    path: str) -> dict[str, torch.Tensor]:
    """A whole pytorchvideo ``slowfast_r50`` state_dict with ``module.``
    stripped (``mintime_tpu/utils/checkpoint.py:117-124``): every key of the
    model must be there at its shape, and a key the model lacks raises, as the
    JAX converter's check of leftover keys does. BatchNorm's
    ``num_batches_tracked`` has no counterpart and is dropped."""
    sd = {k: v for k, v in strip_prefixes(file_sd).items()
          if not k.endswith("num_batches_tracked")}
    unknown = sorted(set(sd) - set(model_sd))
    if unknown:
        raise ValueError(f"{path}: slowfast_r50 keys the model does not have: "
                         f"{unknown[:8]}{'...' if len(unknown) > 8 else ''}")
    out = {}
    for key, want in model_sd.items():
        if key not in sd:
            raise KeyError(f"{path} has no {key!r}")
        t = torch.as_tensor(sd[key]).detach().to("cpu", torch.float32)
        if t.shape != want.shape:
            raise ValueError(f"{path}: {key!r} has shape {tuple(t.shape)}, "
                             f"the model wants {tuple(want.shape)}")
        out[key] = t
    return out
