"""Weights from the seed, made on the device in one draw: a state dict in
float32 under the reference repository's key names, which both the program
and the plain reference load. Truncated normal (std 0.02, cut at 2 sigma) for
linear layers, embeddings and the CLS token; LeCun normal for convolutions;
zero biases; unit norms; BatchNorm statistics at mean 0 and variance 1."""

from __future__ import annotations

import math

import torch


def make(spec: list, seed: int, device) -> dict:
    """``spec``: ``(key, shape, init)`` with init ``trunc``, ``lecun``,
    ``zeros`` or ``ones``."""
    drawn = [(k, s, i) for k, s, i in spec if i in ("trunc", "lecun")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape, init in spec:
        if init == "zeros":
            out[key] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[key] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            t = noise[at:at + n].view(shape)
            at += n
            if init == "trunc":
                out[key] = t.clamp(-2.0, 2.0) * 0.02
            else:
                out[key] = t * (1.0 / math.sqrt(math.prod(shape[1:])))
    return out
