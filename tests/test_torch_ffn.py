"""Port's GEGLU FFN vs the JAX package's ``geglu_ffn`` (its Pallas kernel in
interpret mode on the CPU), fp32, 1e-4 as the JAX package's own FFN tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu.ops.pallas_ffn import geglu_ffn as jax_geglu_ffn
from mintime_torch.ops import geglu_ffn as port


def _weights(rng, dim, hidden):
    w0 = rng.standard_normal((dim, 2 * hidden)).astype(np.float32) * 0.05
    b0 = rng.standard_normal(2 * hidden).astype(np.float32) * 0.05
    w1 = rng.standard_normal((hidden, dim)).astype(np.float32) * 0.05
    b1 = rng.standard_normal(dim).astype(np.float32) * 0.05
    return w0, b0, w1, b1


def _port(x, w0, b0, w1, b1):
    """JAX layout (in, out) → the port's Linear layout (out, in)."""
    t = torch.from_numpy
    return port.geglu_ffn(t(x), t(w0.T.copy()), t(b0), t(w1.T.copy()), t(b1)).numpy()


@pytest.mark.parametrize("m", [256, 300, 32])
def test_matches_jax(m):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, 128)).astype(np.float32) * 0.1
    w = _weights(rng, 128, 256)
    want = np.asarray(jax_geglu_ffn(jnp.asarray(x), *w))
    np.testing.assert_allclose(_port(x, *w), want, atol=1e-4, rtol=1e-4)


def test_leading_shape_preserved():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 7, 64)).astype(np.float32) * 0.1
    w = _weights(rng, 64, 128)
    got = _port(x, *w)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(jax_geglu_ffn(jnp.asarray(x), *w)),
                               atol=1e-4, rtol=1e-4)


def test_wrapper_counts_only_kernel_launches():
    """The plain CPU path leaves the launch counter alone."""
    port.reset_launches()
    rng = np.random.default_rng(2)
    _port(rng.standard_normal((4, 64)).astype(np.float32), *_weights(rng, 64, 128))
    assert port.launches == 0
