"""The face detector and embedder on the card against ``device="cpu"`` on the
same weights and frames: boxes within 2e-2 with the same box count (the
MTCNN parity tolerance), embeddings within 1e-4 and the same cluster
memberships; also with every video's stage-1 tail copied from the card
while the next video's stage 1 is enqueued. Needs an NVIDIA GPU and skips without one; on a machine with a
card run ``python -m pytest tests/test_torch_detect_cuda.py -m cuda``. The file
imports no JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from mintime_torch.preprocessing import mtcnn
from mintime_torch.preprocessing.cluster_faces import FaceEmbedder, connected_components
from mintime_torch.preprocessing.mtcnn import MTCNNDetector


def _weights():
    sds = MTCNNDetector.init_state_dicts(1)
    for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
        for k in ("weight", "bias"):
            sds[net][f"{layer}.{k}"] = sds[net][f"{layer}.{k}"] * 75.0
    return sds


def _frames(n=3, h=360, w=640, seed=0):
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8),
                   np.ones((8, 8, 1), np.uint8))
    return [np.roll(base, 4 * t, axis=1) for t in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("options", [{}, {"input_scale": 2, "channel_order": "bgr"}])
@pytest.mark.parametrize("device_crops", [False, True])
def test_detector_on_card_matches_cpu(options, device_crops):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sds = _weights()
    kw = dict(thresholds=(0.03, 0.75, 0.94), device_crops=device_crops, **options)
    s = options.get("input_scale", 1)  # detection at 360 x 640 either way
    frames = _frames(h=360 * s, w=640 * s)
    card = MTCNNDetector(sds, device="cuda", **kw).detect_batch(frames)
    cpu = MTCNNDetector(sds, device="cpu", **kw).detect_batch(frames)
    assert sum(len(b) for b in cpu) > 0
    for c, h in zip(card, cpu):
        assert c.shape == h.shape
        if len(h):
            np.testing.assert_allclose(c, h, atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("head_k", [0, 1])
def test_stage1_tail_copied_under_the_lookahead_matches_cpu(monkeypatch, head_k):
    """A head of 0 or 1 cells sends videos through the stage-1 tail's copy
    from the card (``mtcnn._copy_after``: a side stream that waits on the
    video's own stage 1), which ``detect_videos`` makes after it has
    enqueued the next video's stage 1. Each video's boxes against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    copies = []
    copy_after = mtcnn._copy_after

    def counted(t, after):
        copies.append(after is not None)
        return copy_after(t, after)

    monkeypatch.setattr(mtcnn, "_copy_after", counted)
    sds = _weights()
    kw = dict(thresholds=(0.03, 0.75, 0.94), device_crops=True, input_scale=2,
              channel_order="bgr")
    videos = [_frames(n=6, h=720, w=1280, seed=v) for v in range(4)]
    card = MTCNNDetector(sds, device="cuda", pnet_head_k=head_k, **kw).detect_videos(videos)
    assert copies and all(copies)
    if head_k == 0:
        assert len(copies) == len(videos)
    cpu_det = MTCNNDetector(sds, device="cpu", **kw)
    for got, frames in zip(card, videos):
        want = cpu_det.detect_batch(frames)
        assert sum(len(b) for b in want) > 0
        for c, h in zip(got, want):
            assert c.shape == h.shape
            if len(h):
                np.testing.assert_allclose(c, h, atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_embedder_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sd = FaceEmbedder.init_state_dict(1)
    rng = np.random.default_rng(2)
    crops = [rng.integers(0, 256, (s, s, 3), dtype=np.uint8) for s in (60, 97, 128, 224, 300)]
    card = FaceEmbedder(sd, device="cuda")(crops)
    cpu = FaceEmbedder(sd, device="cpu")(crops)
    np.testing.assert_allclose(card, cpu, atol=1e-4, rtol=0)
    assert connected_components(card @ card.T) == connected_components(cpu @ cpu.T)
