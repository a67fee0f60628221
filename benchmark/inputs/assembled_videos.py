"""Videos of clustered face crops, made from the seed: each video has
``identities`` (a range) faces, each seen for ``face_seconds`` (a range)
seconds at one crop a second, with crops square and of ``face_side_px`` (a
range) pixels, jittered by ``side_jitter_px`` from crop to crop; pixels are
seeded noise. The set of sizes is the same for every seed (drawn from seed 0)
and the seed orders it and draws the pixels, so every seed asks the same work.

A video is ``{identity key: [(frame index, face index, BGR crop, half-res
box), ...]}``, what the port's clustering hands to ``assemble_inputs``."""

from __future__ import annotations

import numpy as np


def _sizes(traffic: dict) -> list:
    rng = np.random.default_rng(0)
    lo_i, hi_i = traffic["identities"]
    lo_s, hi_s = traffic["face_seconds"]
    lo_p, hi_p = traffic["face_side_px"]
    j = traffic["side_jitter_px"]
    out = []
    for _ in range(traffic["pool_videos"]):
        ids = []
        for _ in range(int(rng.integers(lo_i, hi_i + 1))):
            side = int(rng.integers(lo_p, hi_p + 1))
            n = int(rng.integers(lo_s, hi_s + 1))
            ids.append([int(np.clip(side + rng.integers(-j, j + 1), lo_p, hi_p)) for _ in range(n)])
        out.append(ids)
    return out


def make(traffic: dict, cfg: dict, seed: int, device=None) -> list[dict]:
    rng = np.random.default_rng(seed)
    fixed = _sizes(traffic)
    sizes = [fixed[i] for i in rng.permutation(traffic["pool_videos"])]
    total = sum(s * s * 3 for v in sizes for ident in v for s in ident)
    pixels = rng.integers(0, 256, total, dtype=np.uint8)
    fps, (vh, vw) = traffic["fps"], traffic["video_hw"]
    videos, at = [], 0
    for v in sizes:
        video = {}
        for k, ident in enumerate(v):
            items = []
            for sec, side in enumerate(ident):
                crop = pixels[at:at + side * side * 3].reshape(side, side, 3)
                at += side * side * 3
                x0 = float((k * 400 + 40 * sec) % (vw // 2 - side // 2))
                box = [x0, 60.0, x0 + side / 3, 60.0 + side / 3]  # half-res, a third of the crop
                items.append((sec * fps, k, crop, box))
            video[k] = items
        videos.append(video)
    return videos


def labels(traffic: dict, n: int) -> np.ndarray:
    """Every other video fake, ``fake_share`` of them in all."""
    every = round(1 / traffic["fake_share"])
    return np.array([1.0 if i % every == every - 1 else 0.0 for i in range(n)], np.float32)
