"""The port's weight converter gives the keys and values of the JAX package's
exporters to the reference format (``mintime_tpu.utils.torch_convert``), and
those keys are exactly the port modules' ``state_dict`` keys.

The exporters pad the embedding tables with zero rows up to the reference's
``num_frames * channels + 1``; the port keeps the indexed rows, so for those
two tables the test compares the leading rows and checks the rest are zero.
"""

import jax
import numpy as np
import pytest

from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier
from mintime_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from mintime_tpu.models.timesformer import SizeInvariantTimeSformer as JaxTimeSformer
from mintime_tpu.utils import torch_convert
from mintime_torch import convert
from mintime_torch.config import ModelConfig
from mintime_torch.models.classifier import MintimeVideoClassifier
from mintime_torch.models.efficientnet import EfficientNet
from mintime_torch.models.timesformer import SizeInvariantTimeSformer
from test_torch_efficientnet import random_variables

SMALL = dict(num_frames=8, num_patches=4, channels=12, dim=64, depth=2, heads=2,
             dim_head=32, max_identities=2)
_PADDED = ("pos_emb.weight", "size_emb.weight")


def _assert_same(port_sd, ref_sd):
    assert set(port_sd) == set(ref_sd)
    for k, v in port_sd.items():
        ref = np.asarray(ref_sd[k], np.float32)
        got = v.numpy()
        if k.endswith(_PADDED):
            assert not ref[got.shape[0]:].any()
            ref = ref[: got.shape[0]]
        np.testing.assert_array_equal(got, ref, err_msg=k)


def _timesformer_params(cfg):
    F, n, h = cfg.num_frames, cfg.num_patches, int(np.sqrt(cfg.num_patches))
    args = (np.zeros((1, F, h, h, cfg.channels), np.float32), np.ones((1, F), bool),
            np.ones((1, F, F), bool), np.ones((1, F), np.int32),
            np.arange(1 + F * n)[None].astype(np.int32))
    return jax.jit(JaxTimeSformer(cfg).init)(jax.random.key(1), *args)["params"]


def test_timesformer_matches_exporter():
    jcfg, tcfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    params = _timesformer_params(jcfg)
    port_sd = convert.timesformer_state_dict(params, tcfg)
    _assert_same(port_sd, torch_convert.timesformer_params_to_torch(params, jcfg))
    assert set(port_sd) == set(SizeInvariantTimeSformer(tcfg).state_dict())


def test_efficientnet_matches_exporter():
    variables = random_variables(JaxEfficientNet(), np.zeros((1, 32, 32, 3), np.float32), seed=2)
    port_sd = convert.efficientnet_state_dict(variables)
    _assert_same(port_sd, torch_convert.efficientnet_params_to_torch(variables))
    assert set(port_sd) == set(EfficientNet().state_dict())


@pytest.mark.parametrize("backbone,head", [("efficientnet-b0", "timesformer"),
                                           ("none", "baseline")])
def test_classifier_keys_match_model(backbone, head):
    kw = {**SMALL, "num_patches": 1, "channels": 1280, "image_size": 32}
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    F = jcfg.num_frames
    frames = (np.zeros((1, F, 32, 32, 3), np.float32) if backbone != "none"
              else np.zeros((1, F, 1, 1, 1280), np.float32))
    variables = random_variables(
        JaxClassifier(jcfg, backbone=backbone, head=head), frames, np.ones((1, F), bool), np.ones((1, F, F), bool),
        np.ones((1, F), np.int32), np.arange(1 + F)[None].astype(np.int32),
        seed=3,
    )
    sd = convert.classifier_state_dict(variables, tcfg, backbone, head)
    model = MintimeVideoClassifier(tcfg, backbone=backbone, head=head, device="cpu")
    assert set(sd) == set(model.state_dict())
    if head == "timesformer":
        _assert_same({k[len("head."):]: v for k, v in sd.items() if k.startswith("head.")},
                     torch_convert.timesformer_params_to_torch(variables["params"]["head"], jcfg))
    else:
        _assert_same({k[len("head."):]: v for k, v in sd.items()},
                     torch_convert.baseline_params_to_torch(variables["params"]["head"]))
