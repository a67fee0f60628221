"""Split lists of ``video label 8_cls`` rows (counterpart of
``mintime_tpu/data/manifest.py:22-69``), parsed without pandas.

A row has two or three space-separated fields; a missing ``8_cls`` or one
of pandas' NA spellings (``nan``, ``NaN``, ``NA``, an empty field, ...)
reads as NaN, as ``pd.read_csv(sep=" ", names=COLUMNS)`` gives it. Labels
are floats. Videos whose faces folder is missing under ``data_path`` are
pruned; ``deepfake_methods`` keeps only the rows whose ``8_cls`` is listed
(NaN is never listed, so pass 0 to keep pristine videos); ``shuffle_seed``
permutes the rows with numpy before the ``max_videos`` cut. Video names
are kept as written (pandas would re-render a column of all-numeric names
as numbers).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

COLUMNS = ["video", "label", "8_cls"]
#: the strings pandas' ``read_csv`` reads as NaN by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


@dataclass
class Manifest:
    videos: list[str]
    labels: list[float]
    multiclass: list[float]

    def __len__(self):
        return len(self.videos)


def _number(field: str | None) -> float:
    return float("nan") if field is None or field in NA_VALUES else float(field)


def read_rows(csv_path: str) -> list[tuple[str, float, float]]:
    """``(video, label, 8_cls)`` of every non-blank row, NaN where a field is
    missing or spelled as NA."""
    rows = []
    with open(csv_path) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line.strip():
                continue  # pandas skips blank lines
            fields = line.split(" ")
            if len(fields) > len(COLUMNS):
                raise ValueError(f"{csv_path}: {len(fields)} fields in {line!r}, "
                                 f"at most {len(COLUMNS)} ({' '.join(COLUMNS)})")
            fields += [None] * (len(COLUMNS) - len(fields))
            rows.append((fields[0], _number(fields[1]), _number(fields[2])))
    return rows


def load_manifest(
    csv_path: str,
    data_path: str | None = None,
    deepfake_methods: list[int] | None = None,
    max_videos: int = -1,
    shuffle_seed: int | None = None,
) -> Manifest:
    """The split list's videos, labels and method ids, filtered and cut as
    the reference's test.py does."""
    videos, labels, multiclass = [], [], []
    for video, label, cls8 in read_rows(csv_path):
        if data_path is not None and not os.path.isdir(os.path.join(data_path, video)):
            continue
        if deepfake_methods and (math.isnan(cls8) or int(cls8) not in deepfake_methods):
            continue
        videos.append(video)
        labels.append(label)
        multiclass.append(cls8)
    if shuffle_seed is not None and max_videos > -1:
        perm = np.random.RandomState(shuffle_seed).permutation(len(videos))
        videos = [videos[i] for i in perm]
        labels = [labels[i] for i in perm]
        multiclass = [multiclass[i] for i in perm]
    if max_videos > -1:
        videos = videos[:max_videos]
        labels = labels[:max_videos]
        multiclass = multiclass[:max_videos]
    return Manifest(videos, labels, multiclass)
