"""Port's depthwise-conv forward (+bias+SiLU) and weight gradient (plain
versions on the CPU) against the JAX probes
``experiments/dw_conv_pallas_vs_xla.py`` (``pallas_dwconv``, ``xla_dwconv``)
and ``experiments/dw_conv_bwd_pallas_vs_xla.py`` (``pl_flat_wgrad``,
``pl_chan_wgrad``, ``pl_roll_wgrad``, ``xla_wgrad``), in fp32 at K = 3 and 5
with odd and even C. The probes' Pallas kernels run in interpret mode on the
CPU through a stand-in for the loaded probe module's ``pl`` (the probes pass
no ``interpret=``). Tolerance 1e-5 of max |ref|.

``pl_roll_wgrad`` returns the tap-flipped gradient: it rolls ``dy`` by
``p - kh`` (``dw_conv_bwd_pallas_vs_xla.py:239-245``), which under
``jnp.roll``'s convention pairs x with tap ``2p - kh``. The last test holds it
against the port's result with both tap axes reversed, and shows that the
unflipped result is far off."""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mintime_torch.ops import dw_conv as port

ROOT = Path(__file__).resolve().parent.parent


def _load(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"{name}_probe", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interpreted = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    interpreted.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(mod, "pl", interpreted)
    return mod


@pytest.fixture
def fwd_probe(monkeypatch):
    return _load("dw_conv_pallas_vs_xla", monkeypatch)


@pytest.fixture
def bwd_probe(monkeypatch):
    return _load("dw_conv_bwd_pallas_vs_xla", monkeypatch)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


CASES = [(3, 16), (3, 17), (5, 24), (5, 7)]  # (K, C): even and odd C


@pytest.mark.parametrize("K,C", CASES)
def test_forward_matches_pallas_and_xla(fwd_probe, K, C):
    rng = np.random.default_rng(K * 100 + C)
    x = rng.standard_normal((2, 9, 7, C)).astype(np.float32)
    w = (rng.standard_normal((K, K, C)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    got = port.dw_conv_bias_silu(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                 K=K).numpy()
    _close(got, fwd_probe.pallas_dwconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), K=K))
    _close(got, fwd_probe.xla_dwconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), K=K))


def _wgrad_inputs(K, C):
    rng = np.random.default_rng(K * 1000 + C)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    dy = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("K,C", CASES)
def test_wgrad_matches_flat_chan_and_xla(bwd_probe, K, C):
    x, dy = _wgrad_inputs(K, C)
    got = port.dw_conv_wgrad(torch.from_numpy(x), torch.from_numpy(dy), K=K).numpy()
    assert got.shape == (K, K, 1, C) and got.dtype == np.float32
    xj, dyj = jnp.asarray(x), jnp.asarray(dy)
    _close(got, bwd_probe.xla_wgrad(xj, dyj, jnp.zeros((K, K, 1, C), jnp.float32), 1))
    _close(got, bwd_probe.pl_flat_wgrad(xj, dyj, K=K))
    _close(got, bwd_probe.pl_chan_wgrad(xj, dyj, K=K))


@pytest.mark.parametrize("K,C", [(3, 16), (5, 24)])
def test_roll_wgrad_returns_the_tap_flipped_gradient(bwd_probe, K, C):
    """The fault of ``_roll_kernel``: its result is the true gradient with
    both tap axes reversed, off by about the gradient's own size otherwise."""
    x, dy = _wgrad_inputs(K, C)
    got = port.dw_conv_wgrad(torch.from_numpy(x), torch.from_numpy(dy), K=K).numpy()
    rolled = np.asarray(bwd_probe.pl_roll_wgrad(jnp.asarray(x), jnp.asarray(dy), K=K))
    _close(rolled, got[::-1, ::-1])
    assert np.abs(rolled - got).max() > 0.5 * np.abs(got).max()


def test_kernel_paths_refuse_cpu_even_k_and_stride():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="card"):
        port.dw_conv_bias_silu_cuda(x, torch.zeros(3, 3, 8), torch.zeros(8), K=3)
    with pytest.raises(ValueError, match="odd K"):
        port.dw_conv_wgrad_cuda(x, x, K=4)
    with pytest.raises(ValueError, match="stride 1"):
        port.dw_conv_wgrad_cuda(x, x[:, ::2, ::2].contiguous(), K=3)
