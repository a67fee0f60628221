"""Checkpoints of the whole train state (counterpart of
``mintime_tpu/utils/checkpoint.py:19-79``).

A checkpoint holds what the JAX package's holds: the parameters, the
BatchNorm statistics, the optimizer state and the step, here in one
``torch.save`` file named ``checkpoint_<step>`` (the epoch, when the training
loop saves it).
"""

from __future__ import annotations

import os

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
