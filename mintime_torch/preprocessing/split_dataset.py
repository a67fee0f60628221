"""Dataset splitting: a stratified validation carve-out and the split lists
(copy of ``mintime_tpu/preprocessing/split_dataset.py:23-156``).

The reference's ``preprocessing/split_dataset.py:20-177`` as a metadata
operation: ForgeryNet's validation set becomes the test set; a validation
split of 10% of training is sampled per manipulation-method class; the
``train.csv``, ``val.csv`` and ``test.csv`` lists hold ``video label 8_cls``
rows. Face folders are moved only with ``move_files=True`` (the
reference's on-disk layout). pandas is imported inside
:func:`read_video_list`; ``python -m mintime_torch.preprocessing.split_dataset``
runs :func:`main`.
"""

from __future__ import annotations

import math
import os
import random
import shutil
from dataclasses import dataclass


@dataclass
class SplitResult:
    # split → method class → list of video relpaths
    datasets: dict


def read_video_list(list_file: str) -> list[tuple[str, float]]:
    """Parse a ForgeryNet video-list file: variable-width space-separated
    rows whose LAST non-nan numeric column is the method class
    (split_dataset.py:44-61)."""
    import pandas as pd

    with open(list_file) as f:
        col_count = [len(l.split(" ")) for l in f.readlines()]
    names = list(range(max(col_count)))
    df = pd.read_csv(list_file, sep=" ", names=names)
    out = []
    for _, row in df.iterrows():
        video = str(row[1])
        cls = float("nan")
        for col in reversed(names):
            v = row[col]
            try:
                if not math.isnan(float(v)):
                    cls = float(v)
                    break
            except (TypeError, ValueError):
                continue
        out.append((video, cls))
    return out


def stratified_val_split(
    train_videos: dict[float, list[str]],
    val_fraction: float = 0.1,
    seed: int = 42,
) -> tuple[dict[float, list[str]], dict[float, list[str]]]:
    """Carve a validation set stratified by method class
    (split_dataset.py:76-87, 148-162)."""
    total = sum(len(v) for v in train_videos.values())
    val_size = total * val_fraction
    train_out: dict[float, list[str]] = {}
    val_out: dict[float, list[str]] = {}
    for cls, videos in train_videos.items():
        n_val = int(val_size * (len(videos) / total))
        chosen = set(random.Random(seed).sample(videos, n_val))
        val_out[cls] = sorted(chosen)
        train_out[cls] = [v for v in videos if v not in chosen]
    return train_out, val_out


def write_manifest(path: str, dataset: dict[float, list[str]]):
    """``video label 8_cls`` rows; label = 0 iff method class 0
    (split_dataset.py:164-177)."""
    with open(path, "w") as f:
        for cls, videos in dataset.items():
            binary = "0" if cls == 0 else "1"
            for video in videos:
                f.write(f"{video} {binary} {int(cls)}\n")


def split_dataset(
    train_list_file: str,
    val_list_file: str,
    faces_path: str,
    output_path: str | None = None,
    val_fraction: float = 0.1,
    seed: int = 42,
    move_files: bool = False,
) -> SplitResult:
    output_path = output_path or faces_path
    train_root = os.path.join(faces_path, "train")

    def available(rel: str) -> bool:
        return os.path.isdir(os.path.join(train_root, rel))

    by_class: dict[float, list[str]] = {}
    for video, cls in read_video_list(train_list_file):
        rel = video.split("train_video_release/")[-1]
        rel = os.path.splitext(rel)[0]
        if not available(rel):
            continue  # skip videos without detected faces
        by_class.setdefault(cls, []).append(os.path.join("train", rel))

    train_set, val_set = stratified_val_split(by_class, val_fraction, seed)
    val_set = {
        cls: [v.replace("train", "val", 1) for v in videos]
        for cls, videos in val_set.items()
    }

    test_set: dict[float, list[str]] = {}
    for video, cls in read_video_list(val_list_file):
        rel = os.path.splitext(video.split("val_video_release/")[-1])[0]
        test_set.setdefault(cls, []).append(os.path.join("test", rel))

    if move_files:
        for cls, videos in val_set.items():
            for v in videos:
                src = os.path.join(faces_path, v.replace("val", "train", 1))
                dst = os.path.join(faces_path, v)
                if os.path.isdir(src):
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.move(src, dst)

    datasets = {"train": train_set, "val": val_set, "test": test_set}
    for split, data in datasets.items():
        write_manifest(os.path.join(output_path, f"{split}.csv"), data)
    return SplitResult(datasets)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("mintime-torch split_dataset")
    p.add_argument("--train_list_file", required=True)
    p.add_argument("--validation_list_file", required=True)
    p.add_argument("--faces_path", required=True)
    p.add_argument("--output_path", default=None)
    p.add_argument("--move_files", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    opt = p.parse_args(argv)
    res = split_dataset(
        opt.train_list_file,
        opt.validation_list_file,
        opt.faces_path,
        opt.output_path,
        seed=opt.seed,
        move_files=opt.move_files,
    )
    for split, data in res.datasets.items():
        print(split, sum(len(v) for v in data.values()), "videos")


if __name__ == "__main__":
    main()
