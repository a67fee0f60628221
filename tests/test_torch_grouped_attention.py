"""Port's ``fused_grouped_attention`` (plain version on the CPU) against the
JAX package's v1 kernel ``fused_grouped_attention`` (Pallas, interpret mode
on the CPU, as ``tests/test_pallas_attention.py`` runs it) and against the
plain ``grouped_attention_with_cls``, in fp32 on the cases of
``tests/test_pallas_attention.py:13-41``. Tolerance 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu.ops import pallas_attention as jax_pallas
from mintime_tpu.ops.attention import grouped_attention_with_cls
from mintime_torch.ops import grouped_attention as port


def _inputs(B, H, G, L, D, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.1  # noqa: E731
    return t(B, H, G, L, D), t(B, H, G, L, D), t(B, H, G, L, D), t(B, H, 1, D), t(B, H, 1, D)


def _mask(B, L, seed):
    """``tests/test_pallas_attention.py:22-26``: random keys masked, the CLS
    column and each row's own key kept."""
    mask = np.random.default_rng(seed).random((B, L, 1 + L)) > 0.3
    mask[..., 0] = True
    for li in range(L):
        mask[:, li, 1 + li] = True
    return mask


@pytest.mark.parametrize("H,G,L", [(4, 49, 16), (4, 16, 49)])
def test_masked_matches_jax(H, G, L):
    B, D = 2, 64
    q, k, v, kc, vc = _inputs(B, H, G, L, D, seed=0)
    mask = _mask(B, L, seed=1)
    want = np.asarray(jax_pallas.fused_grouped_attention(
        q, k, v, kc, vc, jax_pallas.mask_to_bias(jnp.asarray(mask)), heads=H))
    ref = np.asarray(grouped_attention_with_cls(q, k, v, kc, vc, jnp.asarray(mask)[:, None]))
    bias = port.mask_to_bias(torch.from_numpy(mask))
    got = port.fused_grouped_attention(*map(torch.from_numpy, (q, k, v, kc, vc)), bias,
                                       heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_no_mask_matches_jax():
    B, H, G, L, D = 1, 2, 8, 16, 32
    q, k, v, kc, vc = _inputs(B, H, G, L, D, seed=2)
    want = np.asarray(jax_pallas.fused_grouped_attention(q, k, v, kc, vc, None, heads=H))
    ref = np.asarray(grouped_attention_with_cls(q, k, v, kc, vc, None))
    got = port.fused_grouped_attention(*map(torch.from_numpy, (q, k, v, kc, vc)), None,
                                       heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_bias_is_shared_over_heads_and_groups():
    """Batch row b's bias reaches every head and group of b and nothing else:
    masking row 1's keys changes only batch 1."""
    B, H, G, L, D = 2, 3, 4, 5, 8
    args = list(map(torch.from_numpy, _inputs(B, H, G, L, D, seed=3)))
    keep = torch.ones(B, L, 1 + L, dtype=torch.bool)
    base = port.fused_grouped_attention(*args, port.mask_to_bias(keep), heads=H)
    keep[1, :, 2:] = False
    masked = port.fused_grouped_attention(*args, port.mask_to_bias(keep), heads=H)
    torch.testing.assert_close(masked[0], base[0], rtol=0, atol=0)
    assert (masked[1] - base[1]).abs().amax(dim=(-1, -2)).min() > 0


def test_kernel_path_refuses_cpu_tensors_and_wrong_heads():
    q, k, v, kc, vc = map(torch.from_numpy, _inputs(1, 2, 3, 4, 8, seed=4))
    with pytest.raises(ValueError, match="card"):
        port.fused_grouped_attention_cuda(q, k, v, kc, vc, None, heads=2)
    with pytest.raises(ValueError, match="heads|\\(B, 3"):
        port.fused_grouped_attention(q, k, v, kc, vc, None, heads=3)
