"""Port's ``MintimeVideoClassifier`` vs the Flax classifier on the same
weights, fp32 on the CPU: uint8 and float frames, ``backbone="none"`` and
the baseline head. Logits 1e-4 (the JAX package's fp32 logits tolerance)."""

import functools

import jax
import numpy as np
import pytest
import torch

from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.models.classifier import MintimeVideoClassifier as JaxClassifier
from mintime_torch.config import ModelConfig
from mintime_torch.convert import load_jax_variables
from mintime_torch.models.classifier import MintimeVideoClassifier
from test_torch_efficientnet import random_variables

SMALL = dict(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=64, depth=1,
             heads=2, dim_head=32, max_identities=2, mlp_dim=16)


def _inputs(backbone, uint8, seed=0):
    rng = np.random.default_rng(seed)
    F = SMALL["num_frames"]
    if backbone == "none":
        frames = rng.standard_normal((2, F, 1, 1, 1280)).astype(np.float32)
    elif uint8:
        frames = rng.integers(0, 256, (2, F, 32, 32, 3), dtype=np.uint8)
    else:
        frames = rng.uniform(0, 255, (2, F, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, F), bool)
    mask[1, 6:] = False
    id_mask = np.ones((2, F, F), bool)
    id_mask[0, :4, 4:] = id_mask[0, 4:, :4] = False
    size_emb = rng.integers(1, 21, (2, F)).astype(np.int32)
    positions = np.tile(np.arange(1 + F, dtype=np.int32), (2, 1))
    return frames, mask, id_mask, size_emb, positions


@functools.lru_cache(maxsize=None)
def _flax(backbone, head):
    """Flax model, its variables and its jitted apply, built once per pair."""
    jmodel = JaxClassifier(JaxModelConfig(**SMALL), backbone=backbone, head=head)
    variables = random_variables(jmodel, *_inputs(backbone, False))
    return variables, jax.jit(jmodel.apply)


@pytest.mark.parametrize("backbone,head,uint8", [
    ("efficientnet-b0", "timesformer", True),
    ("efficientnet-b0", "timesformer", False),
    ("none", "timesformer", False),
    ("efficientnet-b0", "baseline", True),
])
def test_logits_match_flax(backbone, head, uint8):
    inputs = _inputs(backbone, uint8)
    variables, apply = _flax(backbone, head)
    want = np.asarray(apply(variables, *inputs))
    model = MintimeVideoClassifier(ModelConfig(**SMALL), backbone=backbone, head=head,
                                   use_kernels=True, device="cpu")
    load_jax_variables(model, variables)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs)).numpy()
    assert got.shape == want.shape == (2, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_freeze_backbone_detaches_features():
    inputs = [torch.from_numpy(a) for a in _inputs("efficientnet-b0", False)]
    model = MintimeVideoClassifier(ModelConfig(**SMALL), freeze_backbone=True, device="cpu")
    model(*inputs).sum().backward()
    assert all(p.grad is None for p in model.extractor.parameters())
    assert model.head.to_patch_embedding.weight.grad is not None


def test_same_seed_same_weights():
    a = MintimeVideoClassifier(ModelConfig(**SMALL), device="cpu", seed=3).state_dict()
    b = MintimeVideoClassifier(ModelConfig(**SMALL), device="cpu", seed=3).state_dict()
    c = MintimeVideoClassifier(ModelConfig(**SMALL), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.cls_token"], c["head.cls_token"])
