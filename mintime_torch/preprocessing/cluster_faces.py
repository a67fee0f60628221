"""Identity clustering graph step (copy of ``connected_components`` from
``mintime_tpu/preprocessing/cluster_faces.py:30-64``). The FaceNet embedder
is injected by the caller."""

from __future__ import annotations

import numpy as np


def connected_components(similarities: np.ndarray, threshold: float = 0.45) -> list[list[int]]:
    """Union-find over edges with sim > threshold. Only nodes with at least
    one over-threshold edge appear in the output (isolated crops stay
    unclustered)."""
    n = len(similarities)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    has_edge = [False] * n
    for i in range(n):
        row = similarities[i]
        for j in range(i + 1, n):
            if row[j] > threshold:
                union(i, j)
                has_edge[i] = has_edge[j] = True

    groups: dict[int, list[int]] = {}
    for i in range(n):
        if has_edge[i]:
            groups.setdefault(find(i), []).append(i)
    return [sorted(g) for g in groups.values()]
