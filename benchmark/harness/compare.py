"""The numbers that decide ``correct``, each against the reference."""

from __future__ import annotations

import numpy as np

#: a leaf whose reference gradient is under this share of the median
#: moving leaf's is nought to rounding (or frozen) and is not compared
NOUGHT = 1e-3


def frame_means_gap(got: np.ndarray, want: np.ndarray, scale: float, tokens: int) -> float:
    """The gap between two videos' frame means of attention, read back from
    the softmax over ``scale`` times them that the shares are summed from
    (``log`` of it is the means times ``scale`` less one constant a side):
    the widest gap once the constants are taken out, over the attention that
    each of ``tokens`` keys gets from a uniform row. Shares under 1e-300,
    frames as good as absent, count as 1e-300 on both sides."""
    d = (np.log(np.maximum(got, 1e-300)) - np.log(np.maximum(want, 1e-300))) / scale
    return float(np.max(np.abs(d - np.median(d)))) * tokens


def answers(got: list, want: list, scale: float, tokens: int) -> dict:
    """Served answers ``(probability, identity shares, frame softmax)``
    against the reference's: the widest probability gap, identity-share gap
    and frame-attention gap (:func:`frame_means_gap`)."""
    prob = max(abs(g[0] - w[0]) for g, w in zip(got, want))
    share = max(max((abs(a - b) for a, b in zip(g[1], w[1])), default=0.0)
                if len(g[1]) == len(w[1]) else float("inf") for g, w in zip(got, want))
    attn = max(frame_means_gap(np.asarray(g[2]), np.asarray(w[2]), scale, tokens)
               for g, w in zip(got, want))
    return {"prob_gap": prob, "share_gap": share, "attn_gap": attn}


def compared_leaves(ref_grad: dict) -> list[str]:
    moving = [v for v in ref_grad.values() if v > 0]
    med = float(np.median(moving)) if moving else 0.0
    return sorted(k for k, v in ref_grad.items() if v > 0 and v >= NOUGHT * med)


def worst_leaf(got: dict, want: dict, leaves: list[str]) -> tuple[float, str]:
    """The largest gap between the two sides' norms of a leaf, over the
    reference's norm of that leaf or of the median leaf, the larger."""
    med = float(np.median([want[k] for k in leaves]))
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med) for k in leaves}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def median_leaf(got: dict, want: dict, leaves: list[str]) -> float:
    """The median over the leaves of :func:`worst_leaf`'s gap."""
    med = float(np.median([want[k] for k in leaves]))
    return float(np.median([abs(got[k] - want[k]) / max(want[k], med) for k in leaves]))


def training(got: dict, want: dict) -> dict:
    """``got``/``want``: ``losses`` (three steps), ``grad`` (each leaf's norm
    of the first gradient) and ``change`` (each leaf's norm of the change
    after three steps). Every reading; a cell's limits file names those it
    holds to a limit."""
    leaves = compared_leaves(want["grad"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    grad, grad_leaf = worst_leaf(got["grad"], want["grad"], leaves)
    change, change_leaf = worst_leaf(got["change"], want["change"], leaves)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0], "grad_gap": grad, "change_gap": change,
            "grad_gap_median": median_leaf(got["grad"], want["grad"], leaves),
            "change_gap_median": median_leaf(got["change"], want["change"], leaves),
            "leaves": len(leaves), "grad_leaf": grad_leaf, "change_leaf": change_leaf}
