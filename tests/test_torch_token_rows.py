"""Port's token rows and plain CLS row vs the JAX package's
``_token_rows_core`` (its Pallas kernels in interpret mode on the CPU) and
``_cls_row_xla``, fp32, forward and backward, and the port's
``divided_attention`` regime split against JAX's on both sides of the
whole-slice budget. Shapes and tolerances of
``tests/test_pallas_attention.py:240-300``: forward 1e-5, gradients 2e-4.
The JAX package packs qkv head-major, the port ``[q|k|v]``-major."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu.ops import pallas_attention as jax_pallas
from mintime_torch.ops import divided_attention as port_divided
from mintime_torch.ops import token_rows as port
from test_torch_attention import head_major_to_qkv_major


def qkv_major_to_head_major(a: np.ndarray, heads: int, dim_head: int) -> np.ndarray:
    lead = a.shape[:-1]
    return a.reshape(*lead, 3, heads, dim_head).swapaxes(-3, -2).reshape(*lead, -1)


def _inputs(B=2, G=12, L=8, H=2, dh=16, seed=0, masked=True):
    """qkv (B, G, L, 3*H*dh) and CLS qkv head-major, a seq_bias with masked
    keys (column 0, the CLS key, kept) and a row_bias masking some groups."""
    rng = np.random.default_rng(seed)
    c3 = 3 * H * dh
    qkv = rng.standard_normal((B, G, L, c3)).astype(np.float32)
    qkvc = rng.standard_normal((B, 1, c3)).astype(np.float32)
    if not masked:
        return qkv, qkvc, None, None
    fm = rng.random((B, L, 1 + L)) > 0.2
    fm[..., 0] = True
    seq_bias = np.where(fm, 0.0, jax_pallas.NEG).astype(np.float32)
    row_bias = np.where(rng.random((B, G, 1)) > 0.2, 0.0, jax_pallas.NEG).astype(np.float32)
    return qkv, qkvc, seq_bias, row_bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


#: (G, L) of the long-axis cases: the frame counts the kernels take above
#: 32 (the backward's former limit), up to their limit of 64, on few groups
LONG_AXES = [(3, 33), (3, 49), (2, 64)]


@pytest.mark.parametrize("masked", [False, True])
def test_plain_forward_matches_jax(masked):
    _check_forward(masked)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("G,L", LONG_AXES)
def test_plain_forward_matches_jax_at_long_axes(G, L, masked):
    _check_forward(masked, G=G, L=L)


def _check_forward(masked, G=12, L=8):
    H, dh = 2, 16
    qkv, qkvc, sb, rb = _inputs(G=G, L=L, masked=masked)
    want_tok = jax_pallas._token_rows_core(_j(qkv), _j(qkvc), _j(sb), H, dh)
    want_cls = jax_pallas._cls_row_xla(_j(qkv), _j(qkvc), _j(rb), H, dh)
    q, qc = _t(head_major_to_qkv_major(qkv, H, dh)), _t(head_major_to_qkv_major(qkvc, H, dh))
    got_tok = port.token_rows_attention_plain(q, qc, _t(sb), heads=H, dim_head=dh)
    got_cls = port.cls_row_plain(q, qc, _t(rb), heads=H, dim_head=dh)
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_vjps_match_jax(masked):
    """The token rows' Function (plain backward on the CPU) and the CLS row's
    autograd against ``jax.grad``; d_qkvc of the token rows has a zero q
    third, and seq_bias gets a zero gradient."""
    _check_vjps(masked)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("G,L", LONG_AXES)
def test_vjps_match_jax_at_long_axes(G, L, masked):
    """As :func:`test_vjps_match_jax` at the long axes the backward kernel
    takes since its limit went from 32 to 64."""
    _check_vjps(masked, G=G, L=L)


def _check_vjps(masked, G=12, L=8):
    H, dh = 2, 16
    qkv, qkvc, sb, rb = _inputs(G=G, L=L, seed=3, masked=masked)
    rng = np.random.default_rng(4)
    w_tok = rng.standard_normal(qkv.shape[:-1] + (H * dh,)).astype(np.float32)
    w_cls = rng.standard_normal((2, 1, H * dh)).astype(np.float32)

    def jax_tok(a, c):
        return jnp.sum(jax_pallas._token_rows_core(a, c, _j(sb), H, dh) * w_tok)

    def jax_cls(a, c):
        return jnp.sum(jax_pallas._cls_row_xla(a, c, _j(rb), H, dh) * w_cls)

    q = _t(head_major_to_qkv_major(qkv, H, dh)).requires_grad_()
    qc = _t(head_major_to_qkv_major(qkvc, H, dh)).requires_grad_()
    sbt = None if sb is None else _t(sb).requires_grad_()
    for jfn, pfn in ((jax_tok, lambda: (port.token_rows_attention(
                          q, qc, sbt, heads=H, dim_head=dh) * _t(w_tok)).sum()),
                     (jax_cls, lambda: (port.cls_row_plain(
                          q, qc, _t(rb), heads=H, dim_head=dh) * _t(w_cls)).sum())):
        want = jax.grad(jfn, argnums=(0, 1))(_j(qkv), _j(qkvc))
        q.grad = qc.grad = None
        pfn().backward()
        for g, w in zip((q.grad, qc.grad), want):
            np.testing.assert_allclose(qkv_major_to_head_major(g.numpy(), H, dh), np.asarray(w),
                                       atol=2e-4, rtol=2e-4)
        if jfn is jax_tok:
            assert not qc.grad[..., :H * dh].any(), "the token rows give the CLS query no gradient"
            assert qc.grad[..., H * dh:].abs().sum() > 0
            assert sbt is None or not sbt.grad.any()


def test_plain_backward_matches_autograd_of_plain_forward():
    """The explicit backward against autograd through the plain forward, on
    the strided time-axis view; d_qkv keeps the view's stride order."""
    H, dh = 2, 16
    qkv, qkvc, sb, _ = _inputs(seed=5)
    base = _t(qkv).transpose(1, 2).contiguous().requires_grad_()  # (B, L, G, ·) natural layout
    view = base.transpose(1, 2)
    qc = _t(qkvc).requires_grad_()
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        view.shape[:-1] + (H * dh,)).astype(np.float32))
    out = port.token_rows_attention_plain(view, qc, _t(sb), heads=H, dim_head=dh)
    want_q, want_qc = torch.autograd.grad((out * w).sum(), (view, qc))
    got_q, got_qc = port.token_rows_attention_bwd_plain(view.detach(), qc.detach(), _t(sb), w,
                                                        heads=H, dim_head=dh)
    assert got_q.stride() == view.stride()
    torch.testing.assert_close(got_q, want_q, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_qc[..., H * dh:], want_qc[..., H * dh:], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,tiled", [
    ((1, 1280, 8, 2, 64), True),   # conv time axis: 7.9 MB of fp32 qkv, over the 6 MiB budget
    ((2, 49, 16, 2, 64), False),   # flagship time axis at two heads: 1.2 MB
])
def test_divided_attention_regime_split_matches_jax(shape, tiled):
    """The port's ``divided_attention`` against JAX's on either side of the
    budget, forward and gradients, with both biases; the path taken shows
    in the output's grad_fn."""
    B, G, L, H, dh = shape
    assert (G * L * 3 * H * dh * 4 > port_divided.WHOLE_SLICE_BYTES) == tiled
    qkv, qkvc, sb, rb = _inputs(B, G, L, H, dh, seed=7)
    qkv *= 0.3
    rng = np.random.default_rng(8)
    w_tok = rng.standard_normal((B, G, L, H * dh)).astype(np.float32)
    w_cls = rng.standard_normal((B, 1, H * dh)).astype(np.float32)

    def jax_loss(a, c):
        o, oc = jax_pallas.divided_attention(a, c, _j(sb), _j(rb), heads=H, dim_head=dh)
        return jnp.sum(o * w_tok) + jnp.sum(oc * w_cls), (o, oc)

    (_, (want_tok, want_cls)), want_g = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        _j(qkv), _j(qkvc))
    q = _t(head_major_to_qkv_major(qkv, H, dh)).requires_grad_()
    qc = _t(head_major_to_qkv_major(qkvc, H, dh)).requires_grad_()
    port.reset_launches()
    o, oc = port_divided.divided_attention(q, qc, _t(sb), _t(rb), heads=H, dim_head=dh)
    name = "TokenRowsAttentionFunction" if tiled else "DividedAttentionFunction"
    assert name in o.grad_fn.name()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_tok), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(oc.detach().numpy(), np.asarray(want_cls), atol=1e-5, rtol=1e-5)
    ((o * _t(w_tok)).sum() + (oc * _t(w_cls)).sum()).backward()
    for g, w in zip((q.grad, qc.grad), want_g):
        np.testing.assert_allclose(qkv_major_to_head_major(g.numpy(), H, dh), np.asarray(w),
                                   atol=2e-4, rtol=2e-4)
    assert port.launches == 0 and port.bwd_launches == 0  # the CPU launches no kernel


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """A slice over the budget goes to the token-row Function, whose CUDA
    tensors go to the kernel wrapper (which raises without a card); only a
    CPU tensor reaches the plain version."""
    called = []
    monkeypatch.setattr(port, "token_rows_attention_cuda", lambda *a, **k: called.append("cuda"))
    monkeypatch.setattr(port, "token_rows_attention_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(port_divided, "cls_row_plain", lambda *a, **k: None)

    class FakeCuda:  # the conv time axis in bf16: 23.6 MB
        is_cuda = True
        shape = (8, 1280, 8, 1152)

        def element_size(self):
            return 2

    port_divided.divided_attention(FakeCuda(), None, None, None, heads=6, dim_head=64)
    port_divided.divided_attention(torch.zeros(1, 1280, 8, 1152), None, None, None,
                                   heads=6, dim_head=64)
    assert called == ["cuda", "plain"]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points check their arguments instead of computing on
    the CPU."""
    qkv, qkvc = torch.zeros(1, 4, 8, 3 * 64), torch.zeros(1, 1, 3 * 64)
    with pytest.raises(ValueError, match="card"):
        port.token_rows_attention_cuda(qkv, qkvc, None, heads=1, dim_head=64)
    with pytest.raises(ValueError, match="card"):
        port.token_rows_attention_bwd_cuda(qkv, qkvc, None, torch.zeros(1, 4, 8, 64), heads=1,
                                           dim_head=64)
    with pytest.raises(ValueError, match="L <= 64"):
        port.token_rows_attention_cuda(torch.zeros(1, 4, 65, 192), qkvc, None, heads=1,
                                       dim_head=64)
    with pytest.raises(ValueError, match="L <= 64"):
        port.token_rows_attention_bwd_cuda(torch.zeros(1, 4, 65, 192), qkvc, None,
                                           torch.zeros(1, 4, 65, 64), heads=1, dim_head=64)
