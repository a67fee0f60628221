"""Dataset statistics and small analysis tools (copy of
``mintime_tpu/preprocessing/stats.py:22-75``).

* :func:`count_multi_identities`: videos by number of identities, with a
  bar plot (``preprocessing/count_multi_identities.py:17-71``).
* :func:`save_folder_structure`: every face-crop path into a CSV
  (``preprocessing/save_folder_structure.py:6-12``).
* :func:`merge_label_csv`: join DFDC-preview label files
  (``preprocessing/merge_csv.py:4-11``).
* :func:`multi_identity_videos`: the videos with more than one identity
  (``get_multi_identity_videos.py:11-29``).

pandas and matplotlib are imported inside the functions that use them.
"""

from __future__ import annotations

import csv
import glob
import os
from collections import Counter


def identity_counts(faces_path: str) -> dict[str, int]:
    """video dir → number of clustered identity folders."""
    out: dict[str, int] = {}
    for root, dirs, files in os.walk(faces_path):
        ids = [d for d in dirs if d.isdigit() or d.startswith("identity")]
        if ids:
            out[root] = len(ids)
    return out


def count_multi_identities(faces_path: str, plot_path: str | None = None) -> Counter:
    counts = Counter(identity_counts(faces_path).values())
    if plot_path:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        keys = sorted(counts)
        plt.bar([str(k) for k in keys], [counts[k] for k in keys])
        plt.xlabel("identities per video")
        plt.ylabel("videos")
        os.makedirs(os.path.dirname(plot_path) or ".", exist_ok=True)
        plt.savefig(plot_path)
        plt.clf()
    return counts


def multi_identity_videos(faces_path: str, min_identities: int = 2) -> list[str]:
    return sorted(
        v for v, n in identity_counts(faces_path).items() if n >= min_identities
    )


def save_folder_structure(faces_path: str, output_csv: str) -> int:
    paths = sorted(
        glob.glob(os.path.join(faces_path, "**", "*.png"), recursive=True)
    )
    os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
    with open(output_csv, "w", newline="") as f:
        writer = csv.writer(f)
        for p in paths:
            writer.writerow([p])
    return len(paths)


def merge_label_csv(csv_paths: list[str], output_csv: str) -> int:
    """Concatenate label CSVs with a single header (merge_csv.py:4-11)."""
    import pandas as pd

    frames = [pd.read_csv(p) for p in csv_paths]
    merged = pd.concat(frames, ignore_index=True)
    merged.to_csv(output_csv, index=False)
    return len(merged)
