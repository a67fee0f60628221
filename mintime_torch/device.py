"""Device and dtype policy shared by every entry point of the port."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The requested device, or an error when it is a card that is absent.

    There is no fallback: a caller that wants the CPU asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU"
        )
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (the serving dtype), fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


@contextlib.contextmanager
def exact_fp32():
    """fp32 products and convolutions without TF32 inside the block (the
    detector's thresholds and the embedder's 0.45 clustering cut are read
    off fp32 outputs); the process's settings come back after it."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
