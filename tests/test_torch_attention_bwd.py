"""Port's divided-attention backward (the autograd Function, which takes the
plain backward on the CPU) vs ``jax.grad`` through the JAX package's
``divided_attention`` (its Pallas forward and backward kernels in interpret
mode on the CPU), fp32, both axes, at the shapes and the 2e-3 tolerance of
``tests/test_pallas_attention.py:93-130``. The JAX package packs qkv
head-major, the port ``[q|k|v]``-major (``convert.py:58-60``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu.ops import pallas_attention as jax_pallas
from mintime_torch.ops import divided_attention as port
from test_torch_attention import head_major_to_qkv_major

B, F, N, H, DH = 2, 6, 4, 2, 32
INNER = H * DH


def qkv_major_to_head_major(a: np.ndarray) -> np.ndarray:
    lead = a.shape[:-1]
    return a.reshape(*lead, 3, H, DH).swapaxes(-3, -2).reshape(*lead, -1)


def _case(axis, seed=5):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, F, N, 3 * INNER)).astype(np.float32) * 0.2
    qkvc = rng.standard_normal((B, 1, 3 * INNER)).astype(np.float32) * 0.2
    mask = np.ones((B, F), bool)
    mask[1, 4:] = False
    fm = np.concatenate([np.ones((B, F, 1), bool),
                         np.broadcast_to(mask[:, None, :], (B, F, F))], -1)
    G, L = (N, F) if axis == "time" else (F, N)
    w_tok = rng.standard_normal((B, G, L, INNER)).astype(np.float32)
    w_cls = rng.standard_normal((B, 1, INNER)).astype(np.float32)
    return qkv, qkvc, mask, fm, w_tok, w_cls


def _jax_grads(axis, qkv, qkvc, mask, fm, w_tok, w_cls):
    rb = jnp.where(jnp.asarray(mask), 0.0, jax_pallas.NEG)
    if axis == "time":
        q0, sb, rbias = jnp.asarray(qkv).swapaxes(1, 2), jax_pallas.mask_to_bias(jnp.asarray(fm)), rb[:, None, :]
    else:
        q0, sb, rbias = jnp.asarray(qkv), None, rb[:, :, None]

    def loss(q, qc):
        o, oc = jax_pallas.divided_attention(q, qc, sb, rbias, heads=H, dim_head=DH)
        return jnp.sum(o * w_tok) + jnp.sum(oc * w_cls)

    gq, gqc = jax.grad(loss, argnums=(0, 1))(q0, jnp.asarray(qkvc))
    if axis == "time":
        gq = gq.swapaxes(1, 2)
    return np.asarray(gq), np.asarray(gqc)


def _port_grads(axis, qkv, qkvc, mask, fm, w_tok, w_cls):
    qkv_t = torch.from_numpy(head_major_to_qkv_major(qkv, H, DH)).requires_grad_()
    qkvc_t = torch.from_numpy(head_major_to_qkv_major(qkvc, H, DH)).requires_grad_()
    rb = port.mask_to_bias(torch.from_numpy(mask))
    if axis == "time":  # the strided view the model passes
        q0, sb, rbias = qkv_t.transpose(1, 2), port.mask_to_bias(torch.from_numpy(fm)), rb[:, None, :]
    else:
        q0, sb, rbias = qkv_t, None, rb[:, :, None]
    o, oc = port.divided_attention(q0, qkvc_t, sb, rbias, heads=H, dim_head=DH)
    assert "DividedAttentionFunction" in o.grad_fn.name()
    ((o * torch.from_numpy(w_tok)).sum() + (oc * torch.from_numpy(w_cls)).sum()).backward()
    return qkv_major_to_head_major(qkv_t.grad.numpy()), qkv_major_to_head_major(qkvc_t.grad.numpy())


@pytest.mark.parametrize("axis", ["time", "space"])
def test_grads_match_jax(axis):
    case = _case(axis)
    want = _jax_grads(axis, *case)
    got = _port_grads(axis, *case)
    for g, w, name in zip(got, want, ("d_qkv", "d_qkvc")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=2e-3, err_msg=f"{axis} {name}")


@pytest.mark.parametrize("axis", ["time", "space"])
def test_plain_backward_matches_autograd_of_plain_forward(axis):
    """The explicit backward against autograd through the plain forward in
    fp32, d_qkv in the stride order of the (transposed) input view."""
    qkv, qkvc, mask, fm, w_tok, w_cls = _case(axis, seed=6)
    qkv_t = torch.from_numpy(qkv).requires_grad_()
    qkvc_t = torch.from_numpy(qkvc).requires_grad_()
    rb = port.mask_to_bias(torch.from_numpy(mask))
    if axis == "time":
        q0, sb, rbias = qkv_t.transpose(1, 2), port.mask_to_bias(torch.from_numpy(fm)), rb[:, None, :]
    else:
        q0, sb, rbias = qkv_t, None, rb[:, :, None]
    kw = dict(heads=H, dim_head=DH)
    o, oc = port.divided_attention_plain(q0, qkvc_t, sb, rbias, **kw)
    wt, wc = torch.from_numpy(w_tok), torch.from_numpy(w_cls)
    want = torch.autograd.grad((o * wt).sum() + (oc * wc).sum(), (q0, qkvc_t))
    got = port.divided_attention_bwd_plain(q0.detach(), qkvc_t.detach(), sb, rbias, wt, wc, **kw)
    assert got[0].stride() == q0.stride()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_bias_gradients_are_zero_and_cpu_launches_nothing():
    port.reset_launches()
    qkv, qkvc, mask, fm, w_tok, w_cls = _case("time", seed=7)
    sb = port.mask_to_bias(torch.from_numpy(fm)).requires_grad_()
    rb = port.mask_to_bias(torch.from_numpy(mask))[:, None, :].requires_grad_()
    o, oc = port.divided_attention(torch.from_numpy(qkv).transpose(1, 2), torch.from_numpy(qkvc),
                                   sb, rb, heads=H, dim_head=DH)
    (o.sum() + oc.sum()).backward()
    assert not sb.grad.any() and not rb.grad.any()
    assert port.launches == 0 and port.bwd_launches == 0


@pytest.mark.parametrize("bias", ["row", "seq"])
@pytest.mark.parametrize("L", [65, 80, 112, 129, 192])
def test_grads_match_jax_at_long_axes(L, bias):
    """The backward in the whole-slice regime at 64 < L <= 256 (the conv
    model's space axis at tap blocks 4-13, and 65 and 129, one past the
    64-row tiles of the card's long-axis launches): ``jax.grad`` through the Pallas
    kernels in interpret mode against the port's autograd Function, fp32,
    1e-4, unit-scale cotangents."""
    from test_torch_attention import _long_axis_biases, _long_axis_case

    qkv, qkvc, keep_g, seq, h, dh = _long_axis_case(L, bias, seed=20 + L)
    B, G = qkv.shape[:2]
    rng = np.random.default_rng(L)
    w_tok = rng.standard_normal((B, G, L, h * dh)).astype(np.float32)
    w_cls = rng.standard_normal((B, 1, h * dh)).astype(np.float32)
    sb, rb = _long_axis_biases(keep_g, seq, jax_pallas.mask_to_bias, jnp.asarray)

    def loss(q, qc):
        o, oc = jax_pallas.divided_attention(q, qc, sb, rb, heads=h, dim_head=dh)
        return jnp.sum(o * w_tok) + jnp.sum(oc * w_cls)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(qkvc))

    qkv_t = torch.from_numpy(head_major_to_qkv_major(qkv, h, dh)).requires_grad_()
    qkvc_t = torch.from_numpy(head_major_to_qkv_major(qkvc, h, dh)).requires_grad_()
    sb_t, rb_t = _long_axis_biases(keep_g, seq, port.mask_to_bias, torch.from_numpy)
    o, oc = port.divided_attention(qkv_t, qkvc_t, sb_t, rb_t, heads=h, dim_head=dh)
    assert "DividedAttentionFunction" in o.grad_fn.name()
    ((o * torch.from_numpy(w_tok)).sum() + (oc * torch.from_numpy(w_cls)).sum()).backward()
    for g, w, name in zip((qkv_t.grad, qkvc_t.grad), want, ("d_qkv", "d_qkvc")):
        got = g.numpy()
        lead = got.shape[:-1]
        got = got.reshape(*lead, 3, h, dh).swapaxes(-3, -2).reshape(*lead, -1)  # → head-major
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=f"L={L} {name}")


def test_misaligned_views_are_copied_in_stride_order():
    """The backward's long-axis launches read rows by 16-byte copies, so the
    wrapper passes a view through when its start and strides are 16-byte
    aligned and otherwise copies it, keeping its stride order."""
    flat = torch.arange(2 * 3 * 5 * 24 + 8, dtype=torch.float32).bfloat16()
    aligned = flat[:720].view(2, 3, 5, 24)
    assert port._aligned16(aligned) is aligned
    time_view = torch.zeros(2, 5, 3, 24, dtype=torch.bfloat16).transpose(1, 2)
    assert port._aligned16(time_view) is time_view
    shifted = flat[1:721].view(2, 3, 5, 24)  # starts 2 bytes past a 16-byte boundary
    odd = torch.zeros(2, 5, 3, 25, dtype=torch.bfloat16)[..., :24].transpose(1, 2)  # 50-byte rows
    cls = flat[1:49].view(2, 1, 24)
    for view in (shifted, odd, cls):
        out = port._aligned16(view)
        assert out is not view and torch.equal(out, view)
        assert out.data_ptr() % 16 == 0 and all(s * 2 % 16 == 0 for s in out.stride()[:-1])
        assert (out.dim() < 4 or (out.stride(1) < out.stride(2)) == (view.stride(1) < view.stride(2)))
