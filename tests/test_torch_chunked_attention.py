"""Port's chunked-dense divided attention (plain version on the CPU) against
the JAX probe's ``variant_g`` (``experiments/attn_kernel_variants.py``, its
Pallas ``_chunked_kernel`` in interpret mode on the CPU) and against the
port's ``divided_attention_plain``, in fp32 with small B and H, on both
flagship geometries at the probe's P: 8 on (G, L) = (49, 16), 2 on (16, 49),
and on ragged ones (G no multiple of P, odd L, a tile of 128 rows). The JAX
probe packs qkv head-major, the port ``[q|k|v]``-major; it pads L to a
multiple of 8, the port to a tile of a multiple of 16 rows. Tolerance 1e-5.
The kernel's launch plan and its block-diagonal bias, built from its tables,
are checked against the plain version's packing."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mintime_torch.ops import chunked_attention as port
from mintime_torch.ops import divided_attention as port_divided
from test_torch_attention import head_major_to_qkv_major

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "attn_kernel_variants_probe", ROOT / "experiments" / "attn_kernel_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(B, G, L, H, dh, seed):
    """qkv and CLS qkv head-major (the probe's packing) and the probe's masks
    (``make_inputs``: about a tenth of the token-row and CLS-row keys)."""
    rng = np.random.default_rng(seed)
    c3 = 3 * H * dh
    qkv = rng.standard_normal((B, G, L, c3)).astype(np.float32)
    qkvc = rng.standard_normal((B, 1, c3)).astype(np.float32)
    sbias = np.where(rng.random((B, L, 1 + L)) > 0.1, 0.0, port.NEG).astype(np.float32)
    rbias = np.where(rng.random((B, 1, L)) > 0.1, 0.0, port.NEG).astype(np.float32)
    return qkv, qkvc, sbias, rbias


@pytest.mark.parametrize("G,L,P", [(49, 16, 8), (16, 49, 2), (13, 7, 3), (5, 16, 8)])
def test_plain_matches_variant_g_and_divided(probe, G, L, P):
    B, H, dh = 2, 2, 16
    qkv, qkvc, sbias, rbias = _inputs(B, G, L, H, dh, seed=G)
    want_tok, want_cls = probe.variant_g(jnp.asarray(qkv), jnp.asarray(qkvc), jnp.asarray(sbias),
                                         jnp.asarray(rbias), H, dh, P=P)
    q = torch.from_numpy(head_major_to_qkv_major(qkv, H, dh))
    qc = torch.from_numpy(head_major_to_qkv_major(qkvc, H, dh))
    sb, rb = torch.from_numpy(sbias), torch.from_numpy(rbias)
    got_tok, got_cls = port.chunked_attention(q, qc, sb, rb, heads=H, dim_head=dh, P=P)
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=1e-5, rtol=1e-5)
    ref_tok, ref_cls = port_divided.divided_attention_plain(q, qc, sb, rb, heads=H, dim_head=dh)
    torch.testing.assert_close(got_tok, ref_tok, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_cls, ref_cls, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("G,L,P,want", [(49, 16, 8, (56, 16)), (16, 49, 2, (16, 56)),
                                        (49, 16, 4, (52, 16)), (16, 49, 1, (16, 64)),
                                        (16, 49, 4, (16, 52))])
def test_padded_sizes_fill_whole_tensor_core_tiles(G, L, P, want):
    Gp, Lp = port.padded_sizes(G, L, P)
    assert (Gp, Lp) == want and Gp % P == 0 and (P * Lp) % 16 == 0


@pytest.mark.parametrize("P", [1, 3, 4])
def test_result_does_not_depend_on_the_packing(P):
    """Padding and packing only add masked keys and dropped rows: any P gives
    the divided attention (here with a (B, G, 1) row bias)."""
    B, G, L, H, dh = 2, 7, 5, 2, 8
    qkv, qkvc, sbias, _ = _inputs(B, G, L, H, dh, seed=P)
    rb = torch.zeros(B, G, 1)
    rb[1, 3:] = port.NEG
    args = (torch.from_numpy(qkv), torch.from_numpy(qkvc), torch.from_numpy(sbias), rb)
    got = port.chunked_attention(*args, heads=H, dim_head=dh, P=P)
    want = port_divided.divided_attention_plain(*args, heads=H, dim_head=dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("G,L,P,want", [(49, 16, 4, dict(Lp=16, cls_chunks=7)),
                                        (16, 49, 2, dict(Lp=56, cls_chunks=7)),
                                        (13, 7, 3, dict(Lp=16, cls_chunks=1)),
                                        (112, 128, 1, dict(Lp=128, cls_chunks=112))])
def test_plan_covers_every_cls_key(G, L, P, want):
    """A tile is whole warps of 16 rows; the CLS row's chunks (the divided
    forward's, 128 keys a block) cover its G*L keys with none empty, and the
    scratch holds each key's logit and each chunk's dh + 2 partials. G*L =
    14336 is past the parent kernel's one-block CLS row (12288 keys)."""
    got = port.plan(G, L, P)
    assert {k: got[k] for k in want} == want
    assert (P * got["Lp"]) % 16 == 0 and P * got["Lp"] <= 128
    per = -(-G * L // got["cls_chunks"])
    assert per <= 128 and (got["cls_chunks"] - 1) * per < G * L
    assert got["cls_scratch"] == G * L + got["cls_chunks"] * (64 + 2)


def _tile_bias(sbias, L, Lp, P):
    """The kernel's bias over a tile's [CLS | P*Lp] keys (``TileBias`` in
    ``csrc/chunked_attention.cu``), row by row: the tiled sbias of the row's
    position at each key (sbias's column 0 at the CLS key, column 1 + c % Lp
    at column c of the tile, NEG past L), plus NEG where the key's group in
    the tile (the CLS key has none) is not the row's. Rows past L in a group
    read position L - 1, as the kernel does; they are dropped."""
    B = sbias.shape[0]
    PL = P * Lp
    neg = torch.tensor(port.NEG, dtype=torch.float32)
    out = torch.empty(B, PL, 1 + PL, dtype=torch.float32)
    for r in range(PL):
        brow = sbias[:, min(r % Lp, L - 1)]
        for t in range(1 + PL):
            if t == 0:
                out[:, r, t] = brow[:, 0]
                continue
            kg, cl = (t - 1) // Lp, (t - 1) % Lp
            tb = brow[:, 1 + cl] if cl < L else neg.expand(B)
            out[:, r, t] = tb if kg == r // Lp else tb + neg
    return out


@pytest.mark.parametrize("G,L,P", [(13, 7, 3), (16, 49, 2)])
def test_tile_bias_from_key_table_matches_plain_packing(G, L, P):
    """The kernel's tables (the tiled sbias a position, each key's group)
    give, at every real row, the bias that ``chunked_attention_plain`` adds:
    sbias's CLS column, the tiled sbias plus NEG between groups, NEG at
    padded columns (-inf where two NEGs meet), bit for bit."""
    _, _, sbias, _ = _inputs(2, G, L, 1, 8, seed=L)
    sb = torch.from_numpy(sbias)
    _, Lp = port.padded_sizes(G, L, P)
    got = _tile_bias(sb, L, Lp, P)
    # the plain version's packing (chunked_attention_plain)
    pad = torch.nn.functional.pad
    sbp = pad(pad(sb, (0, 0, 0, Lp - L)), (0, Lp - L), value=port.NEG)
    grp = torch.arange(P * Lp) // Lp
    block = torch.where(grp[:, None] == grp[None, :], 0.0, port.NEG).to(torch.float32)
    want = torch.cat([sbp[:, :, :1].repeat(1, P, 1), sbp[:, :, 1:].repeat(1, P, P) + block], -1)
    real = (torch.arange(P * Lp) % Lp) < L
    assert torch.equal(got[:, real], want[:, real])
    assert torch.isinf(want).any() and torch.isinf(got[:, real]).any()


def test_kernel_path_refuses_cpu_tensors_and_large_tiles():
    qkv, qkvc, sbias, rbias = map(torch.from_numpy, _inputs(1, 16, 49, 1, 64, seed=0))
    with pytest.raises(ValueError, match="card"):
        port.chunked_attention_cuda(qkv, qkvc, sbias, rbias, heads=1, dim_head=64, P=2)
    with pytest.raises(ValueError, match="P \\* Lp"):
        port.chunked_attention_cuda(qkv, qkvc, sbias, rbias, heads=1, dim_head=64, P=4)


def test_probe_dense_variant_matches_divided_attention():
    """The attention probe's variant D (one dense masked attention over the
    CLS row and all G*L tokens, in plain PyTorch) computes the divided
    attention: against ``divided_attention_plain`` on the probe's masks at
    B = 2, in fp32 on the CPU."""
    from mintime_torch.experiments import attn_kernel_variants as attn_probe

    for G, L in attn_probe.GEOMS.values():
        qkv, qkvc, sb, rb = attn_probe.make_inputs(G, L, device="cpu", batch=2)
        got = attn_probe.split_dense(attn_probe.dense_plain(
            *attn_probe.dense_inputs(qkv, qkvc, sb, rb)), G, L)
        want = port_divided.divided_attention_plain(qkv, qkvc, sb, rb, heads=attn_probe.H,
                                                    dim_head=attn_probe.DH)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_probes_refuse_the_cpu():
    """The probes time CUDA kernels: without a card, or asked for the CPU,
    they raise instead of timing something else."""
    from mintime_torch.experiments import (attn_kernel_variants, dw_conv3x3_cuda_vs_cudnn,
                                           dw_conv_bwd_cuda_vs_cudnn, dw_conv_cuda_vs_cudnn,
                                           token_rows_phases)

    for mod in (attn_kernel_variants, dw_conv_cuda_vs_cudnn, dw_conv_bwd_cuda_vs_cudnn,
                token_rows_phases, dw_conv3x3_cuda_vs_cudnn):
        with pytest.raises(RuntimeError, match="card"):
            mod.run(device="cpu")
