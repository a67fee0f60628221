"""Port's predict path vs the JAX package's on synthetic videos, same weights,
fp32 on the CPU (the JAX model with its Pallas kernels in interpret mode, the
port with its kernel wrappers, which take the plain versions on the CPU).

Tolerances: probabilities 1e-4 and raw attention maps 3e-6 (the JAX
package's logits and maps tolerances). ``identity_attentions`` 1e-3:
``aggregate_attentions`` scales per-frame map means by 50000 before a
softmax, so a map difference of 1e-7 moves a softmax logit by 5e-3.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from mintime_tpu import predict as jax_predict  # noqa: E402
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig  # noqa: E402
from mintime_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier  # noqa: E402
from mintime_torch import predict as port_predict  # noqa: E402
from mintime_torch.config import MintimeConfig, ModelConfig  # noqa: E402
from mintime_torch.convert import load_jax_variables  # noqa: E402
from mintime_torch.models.classifier import MintimeVideoClassifier  # noqa: E402
from test_torch_efficientnet import random_variables  # noqa: E402

SMALL = dict(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=64, depth=2,
             heads=2, dim_head=32, max_identities=2)


class FakeDetector:
    """Two face boxes per frame (half-res coords), so two identities."""

    def detect(self, frame):
        h, w = frame.shape[:2]
        return np.array([[w * 0.05, h * 0.1, w * 0.45, h * 0.6, 0.99],
                         [w * 0.55, h * 0.3, w * 0.9, h * 0.8, 0.98]])


class FakeEmbedder:
    """Left and right faces are two identities: crops arrive in (frame,
    face) order, two faces a frame."""

    def __call__(self, crops):
        out = np.zeros((len(crops), 8))
        out[np.arange(len(crops)), np.arange(len(crops)) % 2] = 1.0
        return out


def _video(path, seed, n_frames=40):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        frame = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        cv2.circle(frame, (16, 18), 9, (200, 150, 120), -1)
        cv2.circle(frame, (46, 26), 8, (120, 150, 200), -1)
        writer.write(frame)
    writer.release()
    assert os.path.getsize(path) > 0
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    paths = [_video(str(d / "a.mp4"), 0), _video(str(d / "b.mp4"), 7, 30),
             _video(str(d / "c.mp4"), 11)]
    jcfg = JaxModelConfig(**SMALL)
    jmodel = JaxClassifier(jcfg, backbone="efficientnet-b0", head="timesformer",
                           require_attention=True, use_pallas=True)
    F = jcfg.num_frames
    variables = random_variables(
        jmodel, np.zeros((1, F, 32, 32, 3), np.float32), np.ones((1, F), bool),
        np.ones((1, F, F), bool), np.ones((1, F), np.int32), np.arange(1 + F)[None].astype(np.int32),
    )
    tcfg = ModelConfig(**SMALL)
    tmodel = MintimeVideoClassifier(tcfg, require_attention=True, use_kernels=True, device="cpu")
    load_jax_variables(tmodel, variables)
    return paths, (jmodel, variables, JaxMintimeConfig(model=jcfg)), (tmodel, MintimeConfig(model=tcfg))


def test_predict_videos_matches_jax(setup):
    paths, (jmodel, variables, jcfg), (tmodel, tcfg) = setup
    want = jax_predict.predict_videos(paths, jmodel, variables, jcfg, FakeDetector(),
                                      FakeEmbedder(), batch_size=2)
    got = port_predict.predict_videos(paths, tmodel, None, tcfg, FakeDetector(),
                                      FakeEmbedder(), batch_size=2)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.probability, w.probability, atol=1e-4)
        assert g.frames_per_identity == w.frames_per_identity
        assert list(g.identities) == list(w.identities)
        np.testing.assert_allclose(g.identity_attentions, w.identity_attentions, atol=1e-3)
        for a, b in zip(g.aggregated_attentions, w.aggregated_attentions):
            np.testing.assert_allclose(np.sum(a), 1.0, rtol=1e-6)
    assert len(got[0].identities) == 2


def test_predict_video_with_state_matches_jax(setup):
    """``state`` replaces the model's weights through functional_call."""
    paths, (jmodel, variables, jcfg), (tmodel, tcfg) = setup
    want = jax_predict.predict_video(paths[1], jmodel, variables, jcfg, FakeDetector(),
                                     FakeEmbedder())
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    got = port_predict.predict_video(paths[1], tmodel, state, tcfg, FakeDetector(),
                                     FakeEmbedder())
    np.testing.assert_allclose(got.probability, want.probability, atol=1e-4)
    assert got.frames_per_identity == want.frames_per_identity


def test_raw_maps_match_jax(setup):
    """Same assembled batch through both forwards: logits 1e-4, maps 3e-6."""
    paths, (jmodel, variables, jcfg), (tmodel, tcfg) = setup
    jb, jplan, _ = jax_predict._stage_video(paths[0], FakeDetector(), FakeEmbedder(), jcfg,
                                            0.45, 1, None)
    tb, tplan, _ = port_predict._stage_video(paths[0], FakeDetector(), FakeEmbedder(), tcfg,
                                             0.45, 1, None, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    want_logits, want_maps = jax.jit(jmodel.apply)(
        variables, *(jb[k] for k in ("frames", "mask", "identities_mask", "size_embedding",
                                      "positions")))
    got_logits, got_maps = port_predict.forward_batch(tmodel, None, tb)
    np.testing.assert_allclose(got_logits, np.asarray(want_logits).reshape(-1), atol=1e-4)
    for g, w in zip(got_maps, want_maps):
        np.testing.assert_allclose(g, np.asarray(w), atol=3e-6)


def test_precomputed_boxes_skip_the_detector(setup):
    paths, _, (tmodel, tcfg) = setup
    half, _, _ = port_predict.decode_for_predict(paths[0])
    boxes = port_predict.detect_on_frames(half, FakeDetector())

    class NoDetector:
        def detect(self, frame):
            raise AssertionError("detector called despite precomputed boxes")

    with_boxes = port_predict.predict_video(paths[0], tmodel, None, tcfg, NoDetector(),
                                            FakeEmbedder(), boxes=boxes)
    detected = port_predict.predict_video(paths[0], tmodel, None, tcfg, FakeDetector(),
                                          FakeEmbedder())
    np.testing.assert_allclose(with_boxes.probability, detected.probability, atol=1e-6)
