"""Attention-map aggregation (copy of ``aggregate_attentions`` from
``mintime_tpu/utils/attention_viz.py:22-67``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _softmax(x):
    x = np.asarray(x, dtype=np.float64)
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def aggregate_attentions(
    attentions: Sequence[np.ndarray],
    heads: int,
    num_frames: int,
    frames_per_identity: Sequence[int],
    scale_factor: float = 50000,
):
    """Collapse [space, time] CLS attentions into per-frame and per-identity
    saliency: per-token max over rows, space+time sum, per-frame mean,
    scaled softmax, per-identity sums (with the reference's frame-range
    arithmetic).

    ``attentions``: two arrays shaped ``(B*heads, 1, 1+F*n)``.
    ``frames_per_identity``: cumulative frame counts per identity.
    Returns ``(aggregated [space, time, combined], identity_attentions)``.
    """
    aggregated = []
    for attention in attentions:
        a = np.asarray(attention)[:, 0, :]  # (B*H, N)
        aggregated.append(a.max(axis=0))
    combined = np.sum(aggregated, axis=0)
    aggregated.append(combined)

    out = []
    for vec in aggregated:
        groups = np.array_split(np.asarray(vec), num_frames)
        out.append(_softmax([float(np.mean(g)) * scale_factor for g in groups]))

    identity_attentions = []
    for index, identity_frames in enumerate(frames_per_identity):
        if index == 0:
            identity_attention = float(np.sum(out[-1][: identity_frames - 1]))
        else:
            prev = frames_per_identity[index - 1]
            identity_attention = float(np.sum(out[-1][prev - 1 : identity_frames - 1]))
        identity_attentions.append(identity_attention)
    return out, identity_attentions
