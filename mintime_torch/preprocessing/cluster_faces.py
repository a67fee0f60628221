"""Identity clustering: embeddings → similarity graph → connected components
(counterpart of ``mintime_tpu/preprocessing/cluster_faces.py``).

Per video, every crop (sorted by ``(frame, face_idx)``) is embedded by
FaceNet, similarities are dot products, and crops joined by edges with
similarity above the threshold (0.45, the reference's) form one identity
folder. The graph step is a host union-find: O(N^2) over a video's few dozen
crops. As in the reference, ``min_cluster_size`` defaults to 0 (its
``valid_cluster_size`` is computed but never applied).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mintime_torch.device import exact_fp32, resolve_device
from mintime_torch.preprocessing.facenet import (
    InceptionResnetV1,
    fixed_image_standardization,
    load_facenet_state_dict,
)


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


def resize_crop(crop: torch.Tensor, size: int) -> torch.Tensor:
    """One uint8 crop ``(h, w, 3)`` → ``(3, size, size)`` fp32 holding uint8
    levels: antialiased bilinear (PIL ``BILINEAR``'s triangle filter,
    within one level of it), rounded and clamped."""
    x = crop.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(size, size), mode="bilinear", antialias=True, align_corners=False)
    return y[0].round().clamp(0, 255)


class FaceEmbedder:
    """FaceNet embeddings of face crops (reference ``cluster_faces.py:84-92``):
    uint8 crops of any size are resized to ``image_size`` on the device,
    standardised and embedded by InceptionResnetV1 in fp32 without TF32 (the
    0.45 cut reads the similarities). ``state_dict`` is a facenet-pytorch
    InceptionResnetV1 ``state_dict``; ``device`` defaults to ``"cuda"``, which
    raises without a card."""

    #: crops a forward holds at once
    batch = 128

    def __init__(self, state_dict: Mapping[str, torch.Tensor], image_size: int = 128,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.image_size = image_size
        net = load_facenet_state_dict(InceptionResnetV1(), state_dict)
        self.net = net.to(self.device).eval().requires_grad_(False)

    @staticmethod
    def init_state_dict(seed: int = 0) -> dict:
        """Random-init weights (tests and structural runs), from ``seed``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return InceptionResnetV1().state_dict()

    @torch.inference_mode()
    def __call__(self, crops: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 crops ``(h, w, 3)`` → ``(n, 512)`` float32 unit embeddings."""
        if len(crops) == 0:
            return np.zeros((0, 512), np.float32)
        out = []
        with exact_fp32():
            for s in range(0, len(crops), self.batch):
                x = torch.stack([
                    resize_crop(torch.from_numpy(np.ascontiguousarray(c)).to(self.device),
                                self.image_size)
                    for c in crops[s:s + self.batch]])
                out.append(self.net(fixed_image_standardization(x)).cpu())
        return torch.cat(out).numpy()


_CROP_RE = re.compile(r"^(\d+)_(\d+)")


def cluster_video_dir(video_dir: str, embedder: FaceEmbedder, similarity_threshold: float = 0.45,
                      min_cluster_size: int = 0, move_files: bool = True) -> dict[str, int]:
    """Cluster the loose crops of one video folder into identity subfolders.

    Crops are sorted by (frame, face_idx) as in the reference. Returns
    {crop_path: identity_index}; crops in no cluster stay where they are.
    """
    import cv2

    crops = [
        os.path.join(video_dir, f)
        for f in os.listdir(video_dir)
        if os.path.isfile(os.path.join(video_dir, f)) and _CROP_RE.match(f)
    ]
    crops.sort(key=lambda p: tuple(int(g) for g in _CROP_RE.match(os.path.basename(p)).groups()))
    if not crops:
        return {}
    images = [cv2.imread(p) for p in crops]
    valid = [i for i, im in enumerate(images) if im is not None]
    embeddings = embedder([images[i] for i in valid])
    sims = embeddings @ embeddings.T
    components = connected_components(sims, similarity_threshold)
    components = [c for c in components if len(c) >= min_cluster_size]

    assignment: dict[str, int] = {}
    for identity_index, comp in enumerate(components):
        for local in comp:
            src = crops[valid[local]]
            assignment[src] = identity_index
            if move_files:
                dst_dir = os.path.join(video_dir, str(identity_index))
                os.makedirs(dst_dir, exist_ok=True)
                shutil.move(src, os.path.join(dst_dir, os.path.basename(src)))
    return assignment


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("mintime-torch cluster_faces")
    p.add_argument("--faces_path", required=True, help="root of extracted crops")
    p.add_argument("--similarity_threshold", type=float, default=0.45)
    p.add_argument("--valid_cluster_size_ratio", type=float, default=0.0)
    p.add_argument("--facenet_weights", default=None, help="facenet-pytorch state_dict")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)

    if opt.facenet_weights:
        state_dict = torch.load(opt.facenet_weights, map_location="cpu")
    else:
        print("WARNING: no --facenet_weights; using random embedder (structural run)")
        state_dict = FaceEmbedder.init_state_dict()
    embedder = FaceEmbedder(state_dict, device=opt.device)

    n_done = 0
    for root, dirs, files in os.walk(opt.faces_path):
        crop_files = [f for f in files if _CROP_RE.match(f)]
        if not crop_files:
            continue
        if any(d.isdigit() for d in dirs):
            continue  # already clustered (idempotent, as the reference)
        cluster_video_dir(root, embedder, opt.similarity_threshold)
        n_done += 1
    print(f"clustered {n_done} videos")


if __name__ == "__main__":
    main()
