"""Attention-map aggregation, bar plots and the face-box overlay (copy of
``mintime_tpu/utils/attention_viz.py:18-127``). The plots and the overlay run
on the host and import matplotlib and cv2 only when called."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

PLOTS_NAMES = ["space", "time", "combined"]


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


def save_attention_plots(aggregated_attentions, identity_names, frames_per_identity, num_frames,
                         video_id, output_dir="outputs/tokens"):
    """Bar plots of the space, time and combined per-frame attention, a line
    where each identity's frames end; ``<video_id>_<name>.jpg`` each."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    colors = np.random.rand(len(frames_per_identity), 4)
    paths = []
    for index, tokens_means in enumerate(aggregated_attentions):
        plt.bar([i + 1 for i in range(num_frames)], tokens_means)
        for i in range(len(frames_per_identity)):
            plt.vlines(frames_per_identity[i], ymin=float(np.min(tokens_means)),
                       ymax=float(np.max(tokens_means)), colors=colors[i],
                       label=str(identity_names[i]))
        plt.legend()
        path = os.path.join(output_dir, f"{video_id}_{PLOTS_NAMES[index]}.jpg")
        plt.savefig(path)
        plt.clf()
        paths.append(path)
    return paths


def draw_border(img, pt1, pt2, color, thickness, r, d):
    """Rounded-rectangle face box: at each corner two lines and a quarter arc."""
    import cv2

    x1, y1 = pt1
    x2, y2 = pt2
    cv2.line(img, (x1 + r, y1), (x1 + r + d, y1), color, thickness)
    cv2.line(img, (x1, y1 + r), (x1, y1 + r + d), color, thickness)
    cv2.ellipse(img, (x1 + r, y1 + r), (r, r), 180, 0, 90, color, thickness)

    cv2.line(img, (x2 - r, y1), (x2 - r - d, y1), color, thickness)
    cv2.line(img, (x2, y1 + r), (x2, y1 + r + d), color, thickness)
    cv2.ellipse(img, (x2 - r, y1 + r), (r, r), 270, 0, 90, color, thickness)

    cv2.line(img, (x1 + r, y2), (x1 + r + d, y2), color, thickness)
    cv2.line(img, (x1, y2 - r), (x1, y2 - r - d), color, thickness)
    cv2.ellipse(img, (x1 + r, y2 - r), (r, r), 90, 0, 90, color, thickness)

    cv2.line(img, (x2 - r, y2), (x2 - r - d, y2), color, thickness)
    cv2.line(img, (x2, y2 - r), (x2, y2 - r - d), color, thickness)
    cv2.ellipse(img, (x2 - r, y2 - r), (r, r), 0, 0, 90, color, thickness)
    return img
