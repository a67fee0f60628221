"""Port's GEGLU FFN backward (the autograd Function, which takes the plain
backward on the CPU) vs ``jax.grad`` through the JAX package's ``geglu_ffn``
(its Pallas forward and backward kernels in interpret mode on the CPU), fp32,
at the shapes and the 2e-3 gradient tolerance of
``tests/test_pallas_ffn.py:47-67``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu.ops.pallas_ffn import geglu_ffn as jax_geglu_ffn
from mintime_torch.ops import geglu_ffn as port

NAMES = ("x", "w0", "b0", "w1", "b1")


def _case(m, dim=128, hidden=256, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, dim)).astype(np.float32) * 0.1
    w0 = rng.standard_normal((dim, 2 * hidden)).astype(np.float32) * 0.05
    b0 = rng.standard_normal(2 * hidden).astype(np.float32) * 0.05
    w1 = rng.standard_normal((hidden, dim)).astype(np.float32) * 0.05
    b1 = rng.standard_normal(dim).astype(np.float32) * 0.05
    cot = rng.standard_normal((m, dim)).astype(np.float32)
    return (x, w0, b0, w1, b1), cot


def _port_grads(args, cot):
    """Gradients of <geglu_ffn(...), cot> in the JAX layout (in, out)."""
    x, w0, b0, w1, b1 = (torch.from_numpy(a).requires_grad_() for a in
                         (args[0], args[1].T.copy(), args[2], args[3].T.copy(), args[4]))
    out = port.geglu_ffn(x, w0, b0, w1, b1)
    assert out.grad_fn is not None and "GegluFFNFunction" in out.grad_fn.name()
    (out * torch.from_numpy(cot)).sum().backward()
    return (x.grad.numpy(), w0.grad.numpy().T, b0.grad.numpy(), w1.grad.numpy().T,
            b1.grad.numpy())


@pytest.mark.parametrize("m", [300, 32])
def test_grads_match_jax(m):
    args, cot = _case(m)
    want = jax.grad(lambda *a: jnp.vdot(jax_geglu_ffn(*a), cot), argnums=(0, 1, 2, 3, 4))(*args)
    for got, ref, name in zip(_port_grads(args, cot), want, NAMES):
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-3, rtol=2e-3,
                                   err_msg=f"grad of {name}")


def test_plain_backward_matches_autograd_of_plain_forward():
    """The explicit backward against autograd through the plain forward, in
    fp32 (the two differ only in summation order)."""
    args, cot = _case(37, dim=64, hidden=128, seed=3)
    t = [torch.from_numpy(a).requires_grad_() for a in
         (args[0], args[1].T.copy(), args[2], args[3].T.copy(), args[4])]
    (port.geglu_ffn_plain(*t) * torch.from_numpy(cot)).sum().backward()
    got = port.geglu_ffn_bwd_plain(*(a.detach() for a in t[:4]), torch.from_numpy(cot))
    for g, a, name in zip(got, t, NAMES):
        torch.testing.assert_close(g, a.grad, atol=1e-5, rtol=1e-5, msg=f"grad of {name}")


def test_gradients_come_back_in_input_dtypes():
    """bf16 weights get bf16 gradients (the JAX ``_core_bwd`` casts to the
    weights' dtypes); the backward counter counts only kernel launches."""
    port.reset_launches()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, generator=g).requires_grad_()
    w0 = torch.randn(256, 64, generator=g).bfloat16().requires_grad_()
    b0 = torch.zeros(256).requires_grad_()
    w1 = torch.randn(64, 128, generator=g).bfloat16().requires_grad_()
    b1 = torch.zeros(64, dtype=torch.bfloat16).requires_grad_()
    port.geglu_ffn(x, w0.float(), b0, w1.float(), b1.float()).sum().backward()
    assert (w0.grad.dtype, b0.grad.dtype, w1.grad.dtype, b1.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16)
    assert port.launches == 0 and port.bwd_launches == 0
