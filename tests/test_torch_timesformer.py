"""Port's Size-Invariant TimeSformer vs the Flax model on the same weights
(converted by ``mintime_torch.convert``), fp32 on the CPU.

Tolerances are the JAX package's own: logits 1e-4, last-layer attention
maps 3e-6. The JAX side runs with ``use_pallas`` True (Pallas in interpret
mode) and False; the port with ``use_kernels`` True (kernel wrappers, which
take their plain versions on the CPU) and False.
"""

import jax
import numpy as np
import pytest
import torch

from mintime_tpu.config import ModelConfig as JaxModelConfig
from mintime_tpu.data import IdentityFaces, build_sequence_plan
from mintime_tpu.models.timesformer import SizeInvariantTimeSformer as JaxTimeSformer
from mintime_torch.config import ModelConfig
from mintime_torch.convert import timesformer_state_dict
from mintime_torch.models.timesformer import SizeInvariantTimeSformer, pre_token_shift

SMALL = dict(num_frames=8, num_patches=4, channels=12, dim=64, depth=2, heads=2,
             dim_head=32, max_identities=2)


def make_inputs(cfg, batch=2, seed=0):
    """Masks with padded frames and two identities per video."""
    rng = np.random.default_rng(seed)
    F, n = cfg.num_frames, cfg.num_patches
    h = w = int(np.sqrt(n))
    x = rng.standard_normal((batch, F, h, w, cfg.channels)).astype(np.float32)
    plans = []
    for b in range(batch):
        ids = [IdentityFaces("id0", frames=list(range(0, 60, 30)), mean_side=100),
               IdentityFaces("id1", frames=list(range(0, 90, 30)), mean_side=50)]
        plans.append(build_sequence_plan(ids, F, n, max_identities=2, parity=b))
    mask = np.stack([p.mask for p in plans])
    id_mask = np.stack([p.identities_mask for p in plans])
    positions = np.stack([p.positions for p in plans]).astype(np.int32)
    size_emb = rng.integers(1, 21, size=(batch, F)).astype(np.int32)
    size_emb[~mask] = 0
    assert not mask.all() and not id_mask.all()
    return x, mask, id_mask, size_emb, positions


def _pair(require_attention, use_kernels, **overrides):
    kw = {**SMALL, **overrides}
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    inputs = make_inputs(jcfg)
    jmodel = JaxTimeSformer(jcfg, require_attention=require_attention, use_pallas=use_kernels)
    variables = jax.jit(JaxTimeSformer(jcfg).init)(jax.random.key(0), *inputs)
    tmodel = SizeInvariantTimeSformer(tcfg, require_attention, use_kernels).eval()
    tmodel.load_state_dict(timesformer_state_dict(variables["params"], tcfg), strict=True)
    want = jax.jit(jmodel.apply)(variables, *inputs)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in inputs))
    return want, got


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_and_maps_match_jax(use_kernels):
    (want, want_maps), (got, got_maps) = _pair(True, use_kernels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for g, w in zip(got_maps, want_maps):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-6)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_match_jax_without_maps(use_kernels):
    """Every layer on the kernel path when no map is asked for."""
    want, got = _pair(False, use_kernels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_shift_tokens_and_flags_match_jax():
    want, got = _pair(False, True, shift_tokens=True, enable_identity_attention=False,
                      enable_pos_emb=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_pre_token_shift_matches_jax():
    from mintime_tpu.models.timesformer import pre_token_shift as jax_shift

    x = np.random.default_rng(4).standard_normal((2, 5, 3, 10)).astype(np.float32)
    np.testing.assert_array_equal(pre_token_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_shift(x)))
