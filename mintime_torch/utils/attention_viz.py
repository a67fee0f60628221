"""Attention-map aggregation, bar plots and the face-box overlay (counterpart
of ``mintime_tpu/utils/attention_viz.py:18-127``; the aggregation takes a
whole batch of videos in one pass, with the same arithmetic). The plots and
the overlay run on the host and import matplotlib and cv2 only when called."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

PLOTS_NAMES = ["space", "time", "combined"]


def _frame_means(vecs: np.ndarray, num_frames: int) -> np.ndarray:
    """Means of ``vecs``' last axis over ``np.array_split``'s ``num_frames``
    groups (the first ``N % F`` one token longer), each a row reduction, so
    each keeps ``np.mean``'s float32 pairwise sum of its group alone."""
    n = vecs.shape[-1]
    q, r = divmod(n, num_frames)
    lead = vecs[..., :r * (q + 1)].reshape(*vecs.shape[:-1], r, q + 1)
    rest = vecs[..., r * (q + 1):].reshape(*vecs.shape[:-1], num_frames - r, q)
    return np.concatenate([lead.mean(-1), rest.mean(-1)], axis=-1)


def aggregate_attentions_batch(
    attentions: Sequence[np.ndarray],
    heads: int,
    num_frames: int,
    frames_per_identity: Sequence[Sequence[int]],
    scale_factor: float = 50000,
):
    """Collapse [space, time] CLS attentions of ``B`` videos into per-frame
    and per-identity saliency in one pass: per-token max over each video's
    ``heads`` rows, space+time sum, per-frame mean, scaled softmax, then
    per-identity sums (with the reference's frame-range arithmetic).

    ``attentions``: two arrays shaped ``(B*heads, 1, 1+F*n)``.
    ``frames_per_identity``: a video's cumulative frame counts per identity,
    one list a video. Returns ``(aggregated (B, 3, F) float64 softmaxes of
    [space, time, combined], identity_attentions: a list of floats a
    video)``.
    """
    space, time = (np.asarray(a)[:, 0, :] for a in attentions)  # (B*heads, N)
    peaks = [a.reshape(-1, heads, a.shape[-1]).max(axis=1) for a in (space, time)]
    vecs = np.stack([*peaks, peaks[0] + peaks[1]], axis=1)  # (B, 3, N)

    x = _frame_means(vecs, num_frames).astype(np.float64) * scale_factor
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    out = e / e.sum(axis=-1, keepdims=True)

    identity_attentions = []
    for combined, fpi in zip(out[:, -1], frames_per_identity):
        starts = [0] + [prev - 1 for prev in fpi[:-1]]
        identity_attentions.append([float(combined[s:f - 1].sum()) for s, f in zip(starts, fpi)])
    return out, identity_attentions


def aggregate_attentions(
    attentions: Sequence[np.ndarray],
    heads: int,
    num_frames: int,
    frames_per_identity: Sequence[int],
    scale_factor: float = 50000,
):
    """:func:`aggregate_attentions_batch` for one video, its maxes over every
    row given (``heads`` or more). Returns ``(aggregated [space, time,
    combined], identity_attentions)``."""
    rows = len(attentions[0])
    out, identity_attentions = aggregate_attentions_batch(attentions, rows, num_frames,
                                                          [frames_per_identity], scale_factor)
    return list(out[0]), identity_attentions[0]


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
