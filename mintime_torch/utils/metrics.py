"""Evaluation metrics with the reference's contracts (copy of
``mintime_tpu/utils/metrics.py:18-120``; numpy only).

* :func:`check_correct` — sigmoid-round accuracy + per-method error tally
  (reference utils.py:32-57).
* :func:`roc_auc` / :func:`f1_score` — numpy implementations of the sklearn
  calls in test.py:280-290 (identical results).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def check_correct(
    preds: Sequence[float],
    labels: Sequence[float],
    multiclass_labels: Sequence[float] | None = None,
    multiclass_errors: dict | None = None,
    videos_ids: Sequence[str] | None = None,
):
    """Video-level prediction bookkeeping (utils.py:32-57).

    ``preds`` are raw logits; they are sigmoided and rounded. Returns
    ``(correct, positive_class, negative_class[, multiclass_errors,
    videos_errors])``.
    """
    hard = np.round(sigmoid(preds)).astype(int)
    labels = np.asarray(labels).astype(int)
    correct = int((hard == labels).sum())
    positive = int((hard == 1).sum())
    negative = int((hard == 0).sum())
    videos_errors = []
    if multiclass_errors is not None or videos_ids is not None:
        for i in range(len(labels)):
            if labels[i] != hard[i]:
                if (
                    multiclass_errors is not None
                    and multiclass_labels is not None
                    and not math.isnan(float(multiclass_labels[i]))
                ):
                    multiclass_errors[float(multiclass_labels[i])][0] += 1
                if videos_ids is not None:
                    videos_errors.append(videos_ids[i])
    if multiclass_errors is not None:
        return correct, positive, negative, multiclass_errors, videos_errors
    return correct, positive, negative


def roc_auc(labels: Sequence[float], scores: Sequence[float]) -> float:
    """Area under the ROC curve (= sklearn.metrics.roc_auc_score).

    Rank-statistic (Mann-Whitney U) formulation with tie handling.
    """
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0  # average rank, 1-based
        i = j + 1
    pos_rank_sum = ranks[pos].sum()
    u = pos_rank_sum - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def f1_score(labels: Sequence[int], hard_preds: Sequence[int]) -> float:
    labels = np.asarray(labels).astype(int)
    hard = np.asarray(hard_preds).astype(int)
    tp = int(((hard == 1) & (labels == 1)).sum())
    fp = int(((hard == 1) & (labels == 0)).sum())
    fn = int(((hard == 0) & (labels == 1)).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def accuracy(labels: Sequence[int], hard_preds: Sequence[int]) -> float:
    labels = np.asarray(labels).astype(int)
    hard = np.asarray(hard_preds).astype(int)
    return float((labels == hard).mean()) if len(labels) else 0.0


def evaluation_report(
    logits: Sequence[float],
    labels: Sequence[float],
    multiclass_labels: Sequence[float] | None = None,
) -> dict:
    """test.py:271-290 rollup: loss-free metric summary + per-method errors."""
    probs = sigmoid(logits)
    hard = np.round(probs).astype(int)
    report = {
        "accuracy": accuracy(labels, hard),
        "f1": f1_score(labels, hard),
        "auc": roc_auc(labels, probs),
        "positive": int((hard == 1).sum()),
        "negative": int((hard == 0).sum()),
    }
    if multiclass_labels is not None:
        errors: dict = {}
        for lab, pred, mc in zip(np.asarray(labels).astype(int), hard, multiclass_labels):
            if lab != pred and not math.isnan(float(mc)):
                errors[float(mc)] = errors.get(float(mc), 0) + 1
        report["per_method_errors"] = errors
    return report
