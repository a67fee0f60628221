"""Port's plain attention paths vs the JAX package, on the CPU in fp32.

The JAX ``divided_attention`` runs its Pallas kernel in interpret mode here,
as ``tests/test_pallas_attention.py`` runs it. Inputs come from numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_tpu.ops import attention as jax_attention
from mintime_tpu.ops import pallas_attention as jax_pallas
from mintime_torch.ops import attention as port_attention
from mintime_torch.ops import divided_attention as port_divided


def head_major_to_qkv_major(a: np.ndarray, heads: int, dim_head: int) -> np.ndarray:
    """JAX packing (H, [q|k|v], dh) → the port's ([q|k|v], H, dh)."""
    lead = a.shape[:-1]
    return a.reshape(*lead, heads, 3, dim_head).swapaxes(-3, -2).reshape(*lead, -1)


def _geometry(axis, seed=2):
    """Mask geometry of ``tests/test_pallas_attention.py:163-181``."""
    B, f, n, H, dh = 2, 8, 4, 2, 32
    inner = H * dh
    rng = np.random.default_rng(seed)
    qkv4 = rng.standard_normal((B, f, n, 3 * inner)).astype(np.float32) * 0.1
    qkvc = rng.standard_normal((B, 1, 3 * inner)).astype(np.float32) * 0.1
    mask = np.ones((B, f), bool)
    mask[1, 5:] = False
    idm = np.ones((B, f, f), bool)
    idm[0, :4, 4:] = idm[0, 4:, :4] = False  # two identities
    fm = np.concatenate([np.ones((B, f, 1), bool), mask[:, None, :] & idm], -1)
    return qkv4, qkvc, mask, fm, H, dh


@pytest.mark.parametrize("axis", ["time", "space"])
def test_divided_attention_matches_jax(axis):
    qkv4, qkvc, mask, fm, H, dh = _geometry(axis)
    rbias = jnp.where(jnp.asarray(mask), 0.0, jax_pallas.NEG)
    if axis == "time":
        j_args = (jnp.asarray(qkv4).swapaxes(1, 2), jax_pallas.mask_to_bias(jnp.asarray(fm)),
                  rbias[:, None, :])
    else:
        j_args = (jnp.asarray(qkv4), None, rbias[:, :, None])
    want_tok, want_cls = jax_pallas.divided_attention(
        j_args[0], jnp.asarray(qkvc), j_args[1], j_args[2], heads=H, dim_head=dh
    )

    qkv_t = torch.from_numpy(head_major_to_qkv_major(qkv4, H, dh))
    qkvc_t = torch.from_numpy(head_major_to_qkv_major(qkvc, H, dh))
    rb = port_divided.mask_to_bias(torch.from_numpy(mask))
    if axis == "time":  # a strided view, as the model passes it
        args = (qkv_t.transpose(1, 2), port_divided.mask_to_bias(torch.from_numpy(fm)),
                rb[:, None, :])
    else:
        args = (qkv_t, None, rb[:, :, None])
    got_tok, got_cls = port_divided.divided_attention(
        args[0], qkvc_t, args[1], args[2], heads=H, dim_head=dh
    )
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=1e-5, rtol=1e-5)


def test_divided_attention_without_biases():
    qkv4, qkvc, _, _, H, dh = _geometry("space", seed=4)
    want_tok, want_cls = jax_pallas.divided_attention(
        jnp.asarray(qkv4), jnp.asarray(qkvc), None, None, heads=H, dim_head=dh
    )
    got_tok, got_cls = port_divided.divided_attention(
        torch.from_numpy(head_major_to_qkv_major(qkv4, H, dh)),
        torch.from_numpy(head_major_to_qkv_major(qkvc, H, dh)), None, None,
        heads=H, dim_head=dh,
    )
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=1e-5, rtol=1e-5)


def test_mask_to_bias_matches_jax():
    mask = np.random.default_rng(0).random((2, 5, 6)) > 0.5
    np.testing.assert_array_equal(
        port_divided.mask_to_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jax_pallas.mask_to_bias(jnp.asarray(mask))),
    )


@pytest.mark.parametrize("with_mask", [True, False])
def test_grouped_attention_with_cls_matches_jax(with_mask):
    B, H, G, L, D = 2, 2, 6, 8, 16
    rng = np.random.default_rng(1)
    t = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3
    q, k, v = t(B, H, G, L, D), t(B, H, G, L, D), t(B, H, G, L, D)
    kc, vc = t(B, H, 1, D), t(B, H, 1, D)
    mask = None
    if with_mask:
        mask = rng.random((B, 1, L, 1 + L)) > 0.3
        mask[..., 0] = True
    want = jax_attention.grouped_attention_with_cls(
        q, k, v, kc, vc, None if mask is None else jnp.asarray(mask)
    )
    tt = torch.from_numpy
    got = port_attention.grouped_attention_with_cls(
        tt(q), tt(k), tt(v), tt(kc), tt(vc), None if mask is None else tt(mask)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_build_frame_mask_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.random((3, 8)) > 0.3
    idm = rng.random((3, 8, 8)) > 0.5
    for ids in (idm, None):
        want = jax_attention.build_frame_mask(
            jnp.asarray(mask), None if ids is None else jnp.asarray(ids)
        )
        got = port_attention.build_frame_mask(
            torch.from_numpy(mask), None if ids is None else torch.from_numpy(ids)
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper (which raises without a card);
    only a CPU tensor reaches the plain version."""
    called = []
    monkeypatch.setattr(port_divided, "divided_attention_cuda",
                        lambda *a, **k: called.append("cuda"))
    monkeypatch.setattr(port_divided, "divided_attention_plain",
                        lambda *a, **k: called.append("plain"))

    class FakeCuda:  # a slice small enough for the whole-slice kernel
        is_cuda = True
        shape = (1, 1, 1, 192)

        def element_size(self):
            return 2

    port_divided.divided_attention(FakeCuda(), None, None, None, heads=1, dim_head=64)
    port_divided.divided_attention(torch.zeros(1, 1, 1, 192), None, None, None,
                                   heads=1, dim_head=64)
    assert called == ["cuda", "plain"]



def _long_axis_case(L, bias, seed, B=2, G=8, H=2, dh=32):
    """qkv (B, G, L, ·) in the JAX packing at an attended axis longer than 64
    (the conv model's space axis at tap blocks 4-13 has L = 80, 112, 192),
    with a CLS-row bias that masks groups and, for ``bias="seq"``, a random
    per-row mask of the token rows (column 0, the CLS key, kept)."""
    inner = H * dh
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, G, L, 3 * inner)).astype(np.float32) * 0.2
    qkvc = rng.standard_normal((B, 1, 3 * inner)).astype(np.float32) * 0.2
    keep_g = np.ones((B, G), bool)
    keep_g[1, 5:] = False
    seq = None
    if bias == "seq":
        seq = rng.random((B, L, 1 + L)) > 0.2
        seq[..., 0] = True
    return qkv, qkvc, keep_g, seq, H, dh


def _long_axis_biases(keep_g, seq, to_bias, asarray):
    return (None if seq is None else to_bias(asarray(seq)),
            to_bias(asarray(keep_g))[:, :, None])


@pytest.mark.parametrize("bias", ["row", "seq"])
@pytest.mark.parametrize("L", [80, 112, 192])
def test_divided_attention_matches_jax_at_long_axes(L, bias):
    """The whole-slice regime at 64 < L <= 256 (JAX's ``_divided_kernel`` in
    interpret mode against the port's plain version), fp32, 1e-4."""
    qkv, qkvc, keep_g, seq, H, dh = _long_axis_case(L, bias, seed=10 + L)
    sb, rb = _long_axis_biases(keep_g, seq, jax_pallas.mask_to_bias, jnp.asarray)
    want_tok, want_cls = jax_pallas.divided_attention(
        jnp.asarray(qkv), jnp.asarray(qkvc), sb, rb, heads=H, dim_head=dh)
    sb_t, rb_t = _long_axis_biases(keep_g, seq, port_divided.mask_to_bias, torch.from_numpy)
    got_tok, got_cls = port_divided.divided_attention(
        torch.from_numpy(head_major_to_qkv_major(qkv, H, dh)),
        torch.from_numpy(head_major_to_qkv_major(qkvc, H, dh)), sb_t, rb_t,
        heads=H, dim_head=dh)
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=1e-4, rtol=1e-4)
