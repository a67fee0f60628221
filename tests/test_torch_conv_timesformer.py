"""Port's Convolutional TimeSformer vs the JAX package's on the same weights,
fp32 on the CPU: the tapped EfficientNet, the model's logits with kernels on
both sides (the JAX package's Pallas kernels in interpret mode, the port's
autograd Functions with their plain versions) and with the plain paths on
both sides, and strict loading of the converted variables.

The model is cut to ``tests/test_model_variants.py``'s conv case: tap block
20, 32 px frames (a 1 x 1 grid of 1280 channels), dim 64, depth 1, 2 heads
of 32, F = 8. Its time axis then packs 1280 * 8 * 192 * 4 B = 7.9 MB of fp32
qkv, above the 6 MiB whole-slice budget, so the token-row path runs. The
head's weights are drawn at unit fan-in scale, so the logits depend on the
frames (the JAX init's 0.02 leaves them nearly constant). Tolerance 1e-4
(absolute and relative), the JAX package's fp32 logit tolerance: sixteen
blocks of convolutions summed in another order by XLA and PyTorch.
"""

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.models.conv_timesformer import ConvolutionalTimeSformer as JaxConvTimeSformer
from mintime_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from mintime_torch.config import ModelConfig
from mintime_torch.convert import (conv_timesformer_state_dict, efficientnet_state_dict,
                                   load_jax_variables)
from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer
from mintime_torch.models.efficientnet import EfficientNet
from mintime_torch.ops import token_rows
from test_torch_efficientnet import random_variables

CONV_KW = dict(image_size=32, num_frames=8, num_patches=1280, channels=1280, dim=64, depth=1,
               heads=2, dim_head=32, efficient_net_block=20)
B = 2


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, 8, 32, 32, 3)).astype(np.float32),
            "mask": np.ones((B, 8), bool),
            "size_embedding": rng.integers(1, 8, (B, 8)).astype(np.int32),
            "labels": np.array([0.0, 1.0], np.float32)}


def conv_kw(tap=20):
    return {**CONV_KW, "efficient_net_block": tap}


@functools.lru_cache(maxsize=None)
def jax_variables(tap=20):
    """Variables of the JAX model tapped at block ``tap``: the extractor as
    the EfficientNet tests draw it, the head's kernels N(0, 1/fan_in), its
    embeddings and CLS token N(0, 0.5^2)."""
    b = batch()
    model = JaxConvTimeSformer(JaxModelConfig(**conv_kw(tap)))
    v = random_variables(model, b["frames"], b["mask"], b["size_embedding"])
    rng = np.random.default_rng(1)

    def head(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        if names[0] != "params" or names[1] == "extractor":
            return leaf
        last, shape = names[-1], leaf.shape
        if last in ("kernel", "qkv_kernel", "proj_kernel"):
            return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        if last in ("embedding", "cls_token"):
            return (rng.standard_normal(shape) * 0.5).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(head, v)


def port_model(use_kernels=True, tap=20):
    model = ConvolutionalTimeSformer(ModelConfig(**conv_kw(tap)), use_kernels=use_kernels,
                                     device="cpu")
    return load_jax_variables(model, jax_variables(tap))


@pytest.mark.parametrize("tap", [1, 20])
def test_tapped_efficientnet_matches_flax(tap):
    """Tap 1 runs blocks 0-2 and no head conv (24 channels on an 8 x 8 grid at
    32 px); tap 20 runs all 16 blocks and the head conv."""
    model = JaxEfficientNet("efficientnet-b0", tap_block=tap)
    variables = random_variables(model, np.zeros((1, 32, 32, 3), np.float32))
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, x))
    port = EfficientNet("efficientnet-b0", tap_block=tap).eval()
    port.load_state_dict(efficientnet_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    grid = port.grid(32)
    assert got.shape == want.shape == (2, grid, grid, port.feature_dim)
    assert (grid, port.feature_dim) == ((8, 24) if tap == 1 else (1, 1280))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_match_jax(use_kernels):
    b = batch()
    jmodel = JaxConvTimeSformer(JaxModelConfig(**CONV_KW), use_pallas=use_kernels)
    want = np.asarray(jax.jit(jmodel.apply)(jax_variables(), b["frames"], b["mask"],
                                            b["size_embedding"]))
    model = port_model(use_kernels)
    token_rows.reset_launches()
    with torch.no_grad():
        got = model(torch.from_numpy(b["frames"]), torch.from_numpy(b["mask"]),
                    torch.from_numpy(b["size_embedding"])).numpy()
    assert got.shape == want.shape == (B, 1) and np.isfinite(got).all()
    assert abs(float(want[0, 0] - want[1, 0])) > 1e-2, "logits that ignore the frames test nothing"
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert token_rows.launches == 0  # the CPU launches no kernel


def test_logits_match_jax_at_tap_block_10():
    """Tap block 10 (192 channel tokens on a 1 x 1 grid at 32 px): both axes
    take the whole-slice regime on both sides, the time axis at G = 192
    groups of L = 8 and the space axis at G = 8 groups of L = 192, the shape
    that needs the kernels' long-axis path on the card. Kernels on both sides
    (the JAX package's in interpret mode, the port's plain versions), fp32,
    1e-4."""
    from mintime_torch.ops import divided_attention

    b = batch()
    jmodel = JaxConvTimeSformer(JaxModelConfig(**conv_kw(10)), use_pallas=True)
    want = np.asarray(jax.jit(jmodel.apply)(jax_variables(10), b["frames"], b["mask"],
                                            b["size_embedding"]))
    model = port_model(True, tap=10)
    assert model.extractor.feature_dim == 192
    calls = []
    fn = divided_attention.DividedAttentionFunction.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(divided_attention.DividedAttentionFunction, "apply",
                   lambda q, *a: calls.append(tuple(q.shape[1:3])) or fn(q, *a))
        with torch.no_grad():
            got = model(torch.from_numpy(b["frames"]), torch.from_numpy(b["mask"]),
                        torch.from_numpy(b["size_embedding"])).numpy()
    assert calls == [(192, 8), (8, 192)]  # depth 1: time, then space, both whole-slice
    assert got.shape == want.shape == (B, 1) and np.isfinite(got).all()
    assert abs(float(want[0, 0] - want[1, 0])) > 1e-2, "logits that ignore the frames test nothing"
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_state_dict_loads_strictly_with_the_flagship_head_keys():
    model = port_model()
    sd = conv_timesformer_state_dict(jax_variables(), model.config)
    assert set(sd) == set(model.state_dict())
    head = {k[len("head."):] for k in sd if k.startswith("head.")}
    assert {"cls_token", "to_patch_embedding.weight", "pos_emb.weight", "size_emb.weight",
            "layers.0.0.fn.to_qkv.weight", "layers.0.2.fn.net.3.bias", "to_out.1.weight"} <= head
    assert sd["head.pos_emb.weight"].shape == (1 + 8 * 1280, 64)
    assert sd["head.to_patch_embedding.weight"].shape == (64, 1)
    del sd["head.cls_token"]
    with pytest.raises(RuntimeError, match="cls_token"):
        model.load_state_dict(sd, strict=True)


def test_card_inputs_conv_preset_is_the_yaml():
    """The card tests build the conv model from their own copy of the preset
    (the card's machine has no yaml); the copy is the yaml's."""
    import card_inputs
    from mintime_torch.config import load_config

    yaml = Path(__file__).resolve().parent.parent / "configs" / "convolutional_timesformer.yaml"
    assert card_inputs.conv_model_config() == load_config(str(yaml)).model
