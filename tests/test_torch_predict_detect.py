"""``predict_video`` with the port's own MTCNN detector against the JAX
``predict_video`` with the JAX detector, on a cv2-written synthetic video and
the same weights (the cascade's from ``tests/test_torch_mtcnn.py``'s seed,
score layers x75; the classifier's random), fp32 on the CPU. Both sides share
one deterministic embedder (unit mean colour), so the test stays cheap.

Tolerances: the same identities (keys, frames and face indices) and boxes
within 2e-2; the probability within 1e-4, the JAX package's fp32 logit
tolerance.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch import predict as port_predict  # noqa: E402
from mintime_torch.config import MintimeConfig, ModelConfig  # noqa: E402
from mintime_torch.convert import load_jax_variables  # noqa: E402
from mintime_torch.models.classifier import MintimeVideoClassifier  # noqa: E402
from mintime_torch.preprocessing import mtcnn as port_mtcnn  # noqa: E402
from mintime_tpu import predict as jax_predict  # noqa: E402
from mintime_tpu.config import MintimeConfig as JaxMintimeConfig  # noqa: E402
from mintime_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier  # noqa: E402
from mintime_tpu.preprocessing import mtcnn as jax_mtcnn  # noqa: E402
from test_torch_efficientnet import random_variables  # noqa: E402
from test_torch_predict import SMALL  # noqa: E402


def mean_colour_embedder(crops):
    """Unit vector of each crop's mean colour minus mid grey."""
    e = np.stack([c.reshape(-1, 3).mean(0) - 128.0 for c in crops])
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _video(path, n_frames=20):
    """Blocky frames in two tints drifting across a 320 x 240 video."""
    rng = np.random.default_rng(3)
    blocks = np.kron(rng.integers(0, 255, (30, 40, 3)), np.ones((8, 8, 1))).astype(np.uint8)
    blocks[:, :160] = (blocks[:, :160] // 2 + np.array([20, 20, 110], np.uint8))
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 240))
    for t in range(n_frames):
        writer.write(np.roll(blocks, 2 * t, axis=1))
    writer.release()
    assert os.path.getsize(path) > 0
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = _video(str(tmp_path_factory.mktemp("video") / "v.mp4"))
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

    torch.manual_seed(11)
    nets = {"pnet": port_mtcnn.PNet(), "rnet": port_mtcnn.RNet(), "onet": port_mtcnn.ONet()}
    with torch.no_grad():
        for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
            getattr(nets[net], layer).weight.mul_(75.0)
            getattr(nets[net], layer).bias.mul_(75.0)
    sds = {k: v.state_dict() for k, v in nets.items()}
    mtcnn_vars = jax_mtcnn.mtcnn_params_from_torch(sds["pnet"], sds["rnet"], sds["onet"])
    return (path, (jmodel, variables, JaxMintimeConfig(model=jcfg)),
            (tmodel, MintimeConfig(model=tcfg)), sds, mtcnn_vars)


@pytest.mark.parametrize("options", [
    {},
    {"input_scale": 2, "channel_order": "bgr", "device_crops": True},
], ids=["host_resize", "device_shrink_bgr_device_crops"])
def test_predict_video_with_the_ports_detector_matches_jax(setup, options):
    path, (jmodel, variables, jcfg), (tmodel, tcfg), sds, mtcnn_vars = setup
    kw = dict(thresholds=(0.4, 0.4, 0.4), **options)
    want = jax_predict.predict_video(path, jmodel, variables, jcfg,
                                     jax_mtcnn.MTCNNDetector(mtcnn_vars, **kw),
                                     mean_colour_embedder)
    got = port_predict.predict_video(path, tmodel, None, tcfg,
                                     port_mtcnn.MTCNNDetector(sds, device="cpu", **kw),
                                     mean_colour_embedder)
    assert list(got.identities) == list(want.identities)
    assert len(got.identities) >= 1
    for key in want.identities:
        g, w = got.identities[key], want.identities[key]
        assert [(i, j) for i, j, _, _ in g] == [(i, j) for i, j, _, _ in w]
        np.testing.assert_allclose([b for *_, b in g], [b for *_, b in w], atol=2e-2, rtol=0)
        for (_, _, gc, _), (_, _, wc, _) in zip(g, w):
            np.testing.assert_array_equal(gc, wc)
    assert got.frames_per_identity == want.frames_per_identity
    np.testing.assert_allclose(got.probability, want.probability, atol=1e-4)
