"""Inputs of the card tests of the port's paths (``test_torch_paths_cuda.py``):
synthetic videos in memory and at DFDC's frame size, weight files in the
published formats drawn from seeds, the 48-video split of crop packs, and
the repo's yaml configurations built in code, because the card's machine
has no yaml (CPU tests hold each equal to its yaml). The module imports no
JAX, cv2, yaml, PIL, pandas or matplotlib; the package never imports it.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from mintime_torch.config import MintimeConfig, ModelConfig, TestConfig, TrainingConfig


def flagship_config(channels: int = 1280) -> MintimeConfig:
    """The published Size-Invariant TimeSformer (``configs/
    size_invariant_timesformer.yaml``'s model): 224 px, dim 512, depth 9, 8 x
    64 heads, F = 16, n = 49, two identities. Channels 1280 for
    EfficientNet-B0 (MINTIME-EF), 2048 for Xception (MINTIME-XC)."""
    return MintimeConfig(model=ModelConfig(
        image_size=224, num_frames=16, num_patches=49, channels=channels, dim=512, depth=9,
        heads=8, dim_head=64, max_identities=2))


def flagship_train_config() -> MintimeConfig:
    """The flagship at full width with SGD (lr 0.01, weight decay 1e-4,
    cosine) at batch 8."""
    return MintimeConfig(model=flagship_config().model, training=TrainingConfig(
        lr=0.01, weight_decay=1e-4, optimizer="SGD", scheduler="cosinelr", bs=8))


def train_main_config() -> MintimeConfig:
    """``configs/size_invariant_timesformer.yaml``: its 2048 channels are
    Xception's (MINTIME-XC)."""
    return MintimeConfig(model=flagship_config(2048).model, training=TrainingConfig(
        lr=0.01, weight_decay=1e-4, bs=8, val_bs=8, optimizer="SGD", scheduler="cosinelr",
        gamma=0.1, step_size=5, augmentation="max"), test=TestConfig(bs=1))


def slowfast_config() -> MintimeConfig:
    """``configs/slowfast.yaml``."""
    return MintimeConfig(
        model=ModelConfig(image_size=256, num_classes=1, num_frames=16, max_identities=1,
                          enable_size_emb=False, enable_pos_emb=False,
                          enable_identity_attention=False),
        training=TrainingConfig(lr=0.001, weight_decay=1e-4, bs=32, val_bs=32, optimizer="SGD",
                                scheduler="cosinelr", gamma=0.1, step_size=5,
                                augmentation="max"),
        test=TestConfig(bs=32))


def pretrain_config() -> MintimeConfig:
    """``configs/extractor_pretraining.yaml``."""
    return MintimeConfig(model=ModelConfig(image_size=224, num_classes=1), training=TrainingConfig(
        lr=0.01, weight_decay=1e-7, bs=16, optimizer="SGD", scheduler="steplr", gamma=0.1,
        step_size=15, rebalancing_fake=0.3, rebalancing_real=1.0, frames_per_video=30,
        augmentation="min"))


def conv_model_config(tap: int = 20) -> ModelConfig:
    """The Convolutional TimeSformer preset: the model section of
    ``configs/convolutional_timesformer.yaml``, its EfficientNet tapped at
    block ``tap`` (the yaml's 20 by default; at 10 the tokens are 192 channel
    maps of 7 x 7)."""
    return ModelConfig(image_size=224, num_classes=1, num_frames=8, num_patches=1280, dim=256,
                       depth=4, heads=6, dim_head=64, channels=1280, attn_dropout=0.0,
                       ff_dropout=0.0, shift_tokens=False, efficient_net_block=tap)


def conv_batch(n: int = 8) -> dict:
    """The conv model's inputs: standard-normal frames from seed 0, an
    all-true mask, size bucket 1; half labelled fake."""
    rng = np.random.default_rng(0)
    return {"frames": rng.standard_normal((n, 8, 224, 224, 3)).astype(np.float32),
            "mask": np.ones((n, 8), bool), "size_embedding": np.ones((n, 8), np.int32),
            "labels": np.array([0.0, 1.0] * (n // 2), np.float32)}


def synthetic_videos(n_videos: int, seed: int) -> list:
    """In-memory videos with up to two faces and boxes sized so every square
    crop is exactly 224 px (the val transform then only uploads it). Face A
    sits in the top-left corner, face B in the bottom-right; each is tinted
    so :func:`stand_in_embedder` tells them apart. Video v lasts 4 + 2v
    seconds, so the short ones leave padded (masked) frames."""
    rng = np.random.default_rng(seed)
    W, H, fps = 640, 360, 10
    box_a = [0.0, 0.0, 84.0, 84.0]  # half-res; full-res 168 px + a third each side
    box_b = [W / 2 - 84, H / 2 - 84, W / 2, H / 2]
    videos = []
    for v in range(n_videos):
        seconds = 4 + 2 * v
        faces = [box_a] if v == 0 else [box_a, box_b]
        full = {}
        for i in range(0, seconds * fps, fps):
            frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            frame[:224, :224] = np.clip(frame[:224, :224] // 2 + (100, 40, 40), 0, 255)
            frame[H - 224:, W - 224:] = np.clip(frame[H - 224:, W - 224:] // 2 + (40, 40, 100), 0, 255)
            full[i] = frame
        boxes = {str(j): list(faces) for j in range(seconds * fps)}
        videos.append((full, boxes, fps, (W, H)))
    return videos


def stand_in_embedder(crops):
    """Unit vector of each crop's mean colour minus mid grey."""
    e = np.stack([c.reshape(-1, 3).mean(0) - 128.0 for c in crops])
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def flagship_train_batch() -> tuple:
    """:func:`flagship_train_config`, a batch of 8 synthetic videos assembled
    for it (half labelled fake, frames on the host) and its ``pos_weight``."""
    from mintime_torch import predict, train

    cfg = flagship_train_config()
    staged = []
    for full, boxes, fps, dims in synthetic_videos(8, seed=2):
        crops = predict.crops_from_frames(full, boxes, fps)
        identities, _ = predict.cluster_crops(crops, stand_in_embedder)
        staged.append(predict.assemble_inputs(identities, dims, cfg))
    batch = predict.stack_inputs(staged)
    batch["labels"] = np.array([0.0, 1.0] * 4, np.float32)
    return cfg, batch, train.pos_weight_from_labels(batch["labels"])


# Detection at DFDC's frame size
DETECT_VIDEOS = 8
DETECT_FRAMES = 150  # 5 s at 30 fps
DETECT_FPS = 30
DETECT_SIZE = (1080, 1920)  # DFDC's frame size, BGR
DETECT_SEED = 1
#: with the x75 score layers at seed 1, these leave about 150 stage-1
#: candidates and 0-10 faces (3.5 on average) a frame of the synthetic
#: videos, and no P-Net level near the 512-cell cap
DETECT_THRESHOLDS = (0.03, 0.75, 0.94)


def detect_weights(seed: int = DETECT_SEED) -> dict:
    """Random-init P/R/O-Nets from ``seed``, their score layers x75 (as
    ``tests/test_mtcnn_oracle.py``), so no threshold decision sits within
    backend noise of a cut."""
    from mintime_torch.preprocessing.mtcnn import MTCNNDetector

    sds = MTCNNDetector.init_state_dicts(seed)
    for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
        for k in ("weight", "bias"):
            sds[net][f"{layer}.{k}"] = sds[net][f"{layer}.{k}"] * 75.0
    return sds


def detect_video(v: int, seed: int = DETECT_SEED) -> list:
    """One synthetic BGR video of ``DETECT_FRAMES`` frames at ``DETECT_SIZE``:
    8-px blocks of seeded noise drifting 4 px a frame to the right."""
    H, W = DETECT_SIZE
    rng = np.random.default_rng([seed, v])
    base = np.kron(rng.integers(0, 256, (H // 8, W // 8, 3), dtype=np.uint8),
                   np.ones((8, 8, 1), np.uint8))
    return [np.roll(base, 4 * t, axis=1) for t in range(DETECT_FRAMES)]


# The classifiers' weight files: (path, extractor model, backbone, channels)
PREDICT_MODELS = (("predict_ef", 0, "efficientnet-b0", 1280), ("predict_xc", 1, "xception", 2048))


def write_model_files(d: str, model_id: int, backbone: str, channels: int) -> tuple:
    """Reference-format weight files of the classifier drawn from seed
    ``model_id``: the TimeSformer head's ``Model_checkpoint`` (its position
    and size tables padded to the reference's ``num_frames * channels + 1``
    rows) and the extractor's ``Extractor_checkpoint``; returns their paths."""
    from mintime_torch.models.classifier import MintimeVideoClassifier

    mcfg = flagship_config(channels).model
    sd = MintimeVideoClassifier(mcfg, backbone=backbone, device="cpu", seed=model_id).state_dict()
    rows = mcfg.num_frames * channels + 1
    head = {}
    for k, v in sd.items():
        if k.startswith("head."):
            if k in ("head.pos_emb.weight", "head.size_emb.weight"):
                v = torch.cat([v, v.new_zeros(rows - v.shape[0], v.shape[1])])
            head[k[len("head."):]] = v
    ext = {k[len("extractor."):]: v for k, v in sd.items() if k.startswith("extractor.")}
    paths = (os.path.join(d, f"Model_checkpoint_{backbone}"),
             os.path.join(d, f"Extractor_checkpoint_{backbone}"))
    torch.save(head, paths[0])
    torch.save(ext, paths[1])
    return paths


def write_weight_files(d: str) -> dict:
    """The classifiers' weight files for each model of ``PREDICT_MODELS``, the
    three MTCNN nets of :func:`detect_weights` and a FaceNet from
    ``DETECT_SEED``."""
    from mintime_torch.preprocessing.cluster_faces import FaceEmbedder

    files = {"mtcnn": os.path.join(d, "mtcnn"), "facenet": os.path.join(d, "facenet.pt")}
    os.makedirs(files["mtcnn"])
    for name, sd in detect_weights().items():
        torch.save(sd, os.path.join(files["mtcnn"], f"{name}.pt"))
    torch.save(FaceEmbedder.init_state_dict(DETECT_SEED), files["facenet"])
    for path, model_id, backbone, channels in PREDICT_MODELS:
        files[path] = write_model_files(d, model_id, backbone, channels)
    return files


def slowfast_state_dict(model, seed: int, proj_std: float = 0.002) -> dict:
    """A state_dict for ``model`` (SlowFast, pytorchvideo's keys) drawn from
    ``seed`` on the CPU: convolutions He-normal, BatchNorm scales from [0.5,
    1.5] but each residual branch's last from [0.05, 0.15] (pytorchvideo
    initialises it at 0), shifts and running means N(0, 0.1), running
    variances from [0.5, 1.5], the head N(0, ``proj_std``) with no bias."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("proj.weight"):
            t = torch.randn(v.shape, generator=gen) * proj_std
        elif k.endswith("proj.bias"):
            t = torch.zeros(v.shape)
        elif v.dim() == 5:
            t = torch.randn(v.shape, generator=gen) * math.sqrt(2.0 / v[0].numel())
        elif k.endswith("norm_c.weight"):
            t = torch.rand(v.shape, generator=gen) * 0.1 + 0.05
        elif k.endswith((".running_var", ".weight")):
            t = torch.rand(v.shape, generator=gen) + 0.5
        else:
            t = torch.randn(v.shape, generator=gen) * 0.1
        sd[k] = t
    return sd


# The 48-video split of crop packs
SPLIT_VIDEOS = 48
#: identities a video: 16 with one, 24 with two, 8 with three (cut to two)
SPLIT_IDENTITIES = (1,) * 16 + (2,) * 24 + (3,) * 8
SPLIT_SECONDS = 10  # one crop a second an identity
SPLIT_FPS = 30
SPLIT_SEED = 2
SPLIT_SIDES = (64, 320)  # face sides in DFDC's 1920 x 1080 frames
SPLIT_DIMS = {"width": 1920, "height": 1080, "fps": SPLIT_FPS}
#: levels of a video's band of block values; the band's floor is drawn a video
SPLIT_BAND = 64
#: every third video of the split is the validation list
VAL_EVERY = 3


def block_crop(rng, side: int, lo: int = 0, band: int = 256):
    """A square crop of 8-pixel block noise with values in ``[lo, lo +
    band)``, BGR uint8."""
    n = -(-side // 8)
    blocks = rng.integers(lo, lo + band, (n, n, 3)).astype(np.uint8)
    return np.kron(blocks, np.ones((8, 8, 1), np.uint8))[:side, :side]


def write_split(root: str) -> tuple:
    """``SPLIT_VIDEOS`` videos as ``crops.pack`` shards under ``root/faces``,
    written by ``crop_store.write_pack`` from seeded crops (block noise in
    a band of ``SPLIT_BAND`` levels a video, so that videos differ in more
    than their noise), and a ``test.csv`` of ``video label 8_cls`` rows (odd
    videos fake with method 1-4, even pristine with no method). Every sixth
    video also holds three loose crops (identity None) that merge into
    identity 0; every eighth keeps its frame size in a ``video_dims.json``
    sidecar, the rest in the pack header. Returns the faces root, the split
    file and the number of crops."""
    from mintime_torch.data.crop_store import PACK_NAME, write_pack

    rng = np.random.default_rng(SPLIT_SEED)
    identities = rng.permutation(SPLIT_IDENTITIES)
    faces = os.path.join(root, "faces")
    rows, n_crops = [], 0
    for v in range(SPLIT_VIDEOS):
        name = f"{'fake' if v % 2 else 'real'}/video_{v:02d}"
        vdir = os.path.join(faces, name)
        os.makedirs(vdir)
        entries = []
        band = (int(rng.integers(0, 256 - SPLIT_BAND + 1)), SPLIT_BAND)
        for ident in range(int(identities[v])):
            side = int(rng.integers(SPLIT_SIDES[0], SPLIT_SIDES[1] + 1))
            for sec in range(SPLIT_SECONDS):
                s = int(np.clip(side + rng.integers(-8, 9), *SPLIT_SIDES))
                entries.append((str(ident), sec * SPLIT_FPS, ident, block_crop(rng, s, *band)))
        if v % 6 == 5:
            entries += [(None, f, 3, block_crop(rng, 96, *band))
                        for f in (15, 105, SPLIT_SECONDS * SPLIT_FPS)]
        sidecar = v % 8 == 3
        write_pack(os.path.join(vdir, PACK_NAME), entries, dims=None if sidecar else SPLIT_DIMS)
        if sidecar:
            with open(os.path.join(vdir, "video_dims.json"), "w") as f:
                json.dump(SPLIT_DIMS, f)
        n_crops += len(entries)
        rows.append(f"{name} 1 {1 + (v // 2) % 4}" if v % 2 else f"{name} 0")
    split = os.path.join(root, "test.csv")
    with open(split, "w") as f:
        f.write("\n".join(rows) + "\n")
    return faces, split, n_crops


def write_val_list(d: str, split: str) -> tuple:
    """The split's rows and a validation list of every ``VAL_EVERY``-th of
    them written beside it."""
    with open(split) as f:
        rows = f.read().split("\n")[:-1]
    val = os.path.join(d, "val.csv")
    with open(val, "w") as f:
        f.write("\n".join(rows[::VAL_EVERY]) + "\n")
    return rows, val
