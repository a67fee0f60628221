"""Port's Xception (the MINTIME-XC backbone) vs the Flax model on the same
weights, fp32 on the CPU, and the classifier built on it.

Tolerances: the feature map within 1e-4 of its largest magnitude (36
convolutions summed in another order by XLA and by PyTorch's CPU kernels,
on features of order 10); the classifier's logits 1e-4 and its attention
maps 3e-6, the JAX package's fp32 tolerances.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier
from mintime_tpu.models.xception import Xception as JaxXception
from mintime_tpu.utils.torch_convert import xception_params_to_torch
from mintime_torch.config import ModelConfig
from mintime_torch.convert import load_jax_variables, xception_state_dict
from mintime_torch.models.classifier import MintimeVideoClassifier
from mintime_torch.experiments.dw_conv3x3_cuda_vs_cudnn import GEOMS
from mintime_torch.models.xception import SeparableConv, Xception
from mintime_torch.ops import dw_conv
from test_torch_efficientnet import random_variables

#: 64 px through Xception gives a 2 x 2 map: num_patches 4
SMALL_XC = dict(image_size=64, num_frames=8, num_patches=4, channels=2048, dim=64, depth=2,
                heads=2, dim_head=32, max_identities=2)


@functools.lru_cache(maxsize=None)
def _flax_xception(size):
    model = JaxXception()
    variables = random_variables(model, np.zeros((1, size, size, 3), np.float32))
    return variables, jax.jit(model.apply)


@pytest.mark.parametrize("size,grid", [(64, 2), (224, 7)])
def test_feature_map_matches_flax(size, grid):
    variables, apply = _flax_xception(size)
    x = np.random.default_rng(1).uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(apply(variables, x))
    port = Xception().eval()
    port.load_state_dict(xception_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, grid, grid, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_state_dict_keys_are_the_reference_exporters():
    variables, _ = _flax_xception(64)
    want = xception_params_to_torch(variables)
    got = xception_state_dict(variables)
    assert set(got) == set(want) == set(Xception().state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    F = SMALL_XC["num_frames"]
    frames = rng.integers(0, 256, (2, F, 64, 64, 3), dtype=np.uint8)
    mask = np.ones((2, F), bool)
    mask[1, 6:] = False
    id_mask = np.ones((2, F, F), bool)
    id_mask[0, :4, 4:] = id_mask[0, 4:, :4] = False
    size_emb = rng.integers(1, 21, (2, F)).astype(np.int32)
    positions = np.tile(np.arange(1 + F * SMALL_XC["num_patches"], dtype=np.int32), (2, 1))
    return frames, mask, id_mask, size_emb, positions


def test_classifier_logits_and_maps_match_flax():
    inputs = _inputs()
    jmodel = JaxClassifier(JaxModelConfig(**SMALL_XC), backbone="xception", head="timesformer",
                           require_attention=True, use_pallas=True)
    variables = random_variables(jmodel, *inputs)
    want_logits, want_maps = jax.jit(jmodel.apply)(variables, *inputs)
    model = MintimeVideoClassifier(ModelConfig(**SMALL_XC), backbone="xception",
                                   require_attention=True, use_kernels=True, device="cpu")
    load_jax_variables(model, variables)
    with torch.no_grad():
        got_logits, got_maps = model(*(torch.from_numpy(a) for a in inputs))
    assert got_logits.shape == (2, 1)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    assert len(got_maps) == len(want_maps) == 2
    for g, w in zip(got_maps, want_maps):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-6, rtol=0)


def test_batchnorm_stays_fp32_under_a_bf16_compute_dtype():
    model = MintimeVideoClassifier(ModelConfig(**SMALL_XC), backbone="xception",
                                   device="cpu", dtype=torch.bfloat16,
                                   param_dtype=torch.float32)
    cast = set(model._cast_names["extractor"])
    bns = [n for n, m in model.extractor.named_modules() if getattr(m, "keep_param_dtype", False)]
    assert len(bns) == 2 + 4 + 32 + 2  # stem, skips, the blocks' separable convs, exit
    assert not any(n.startswith(f"{b}.") for n in cast for b in bns)
    assert "conv1.weight" in cast and "block1.skip.weight" in cast


def test_relus_become_the_separable_convs_prologues():
    """The walkers of ``XceptionBlock.forward`` and ``Xception.forward`` hand
    32 of the 34 depthwise layers their ReLU as a prologue (31 in the
    blocks, 1 before ``conv4``) and run no ``nn.ReLU`` module; the layers'
    shapes are the probe's ``GEOMS``; none of them runs on the kernel on
    the CPU (its launch counter stays)."""
    model = Xception().to("meta").eval()
    seen, relu_modules = [], []
    for name, m in model.named_modules():
        if isinstance(m, SeparableConv):
            m.register_forward_pre_hook(
                lambda m, args, kwargs, name=name: seen.append(
                    (name, tuple(args[0].shape[1:]), kwargs.get("relu", False))),
                with_kwargs=True)
        elif isinstance(m, torch.nn.ReLU):
            m.register_forward_hook(lambda *a: relu_modules.append(a))
    launches = dw_conv.conv3x3_launches
    model(torch.empty(2, 224, 224, 3, device="meta"))
    assert len(seen) == 34 and relu_modules == []
    fused = [name for name, _, relu in seen if relu]
    assert len(fused) == 32 and sum(n.startswith("block") for n in fused) == 31
    assert "conv4" in fused and {n for n, _, relu in seen if not relu} == {"block1.rep.0", "conv3"}
    shapes = {}
    for _, (C, H, W), relu in seen:
        shapes[H, W, C, relu] = shapes.get((H, W, C, relu), 0) + 1
    assert shapes == {(H, W, C, relu): n for H, W, C, n, relu in GEOMS}
    assert dw_conv.conv3x3_launches == launches
