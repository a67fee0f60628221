"""Divided-attention variants at the flagship's shapes on the card (the
port's counterpart of ``experiments/attn_kernel_variants.py``).

Every variant computes the divided attention of one layer axis (token rows
and the CLS row) from one set of tensors in the port's packed layout, at the
probe's size (B = 32 videos, 8 heads of 64, both axes):

  A  ``divided_attention_cuda``: the whole-slice kernels
  B  ``token_rows_attention_cuda`` + ``cls_row_plain``
  G  ``chunked_attention_cuda``: P groups packed into one tensor-core tile
     (P = 4 on the time axis, 64-row tiles; P = 2 on the space axis, 112)
  D  dense block-masked attention over the 1 + G*L positions of each
     (b, h): in plain PyTorch, and as one ``scaled_dot_product_attention``
     call (a yardstick; the port never calls it)
  E  ``divided_attention_plain``

Each variant is timed by CUDA events over 20 calls after 3 warm-up calls
(the JAX probe chained its calls in one ``lax.scan`` to hide a TPU host
link's dispatch latency; events need no chain). The masks are the JAX
probe's (``make_inputs``: about a tenth of the token-row and CLS-row keys,
from numpy seed 0). Errors of B, G and D against A are printed beside.

Run on a machine with a card:
``python -m mintime_torch.experiments.attn_kernel_variants``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mintime_torch.experiments import card, require_card, time_ms
from mintime_torch.ops import chunked_attention as ca
from mintime_torch.ops import divided_attention as da
from mintime_torch.ops import token_rows as tr

B, H, DH = 32, 8, 64
INNER = H * DH
C3 = 3 * INNER
GEOMS = {"time": (49, 16), "space": (16, 49)}  # (G, L)
P_BY_AXIS = {"time": 4, "space": 2}


def make_inputs(G, L, seed=0, device="cuda", batch=B):
    """qkv (B, G, L, 3*H*dh) and CLS qkv in bf16, and the probe's fp32 masks:
    sbias (B, L, 1+L) and rbias (B, 1, L), each key masked with
    probability 0.1 (the JAX probe's ``make_inputs`` draws, in its order)."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((batch, G, L, C3)).astype(np.float32))
    qkvc = torch.from_numpy(rng.standard_normal((batch, 1, C3)).astype(np.float32))
    sbias = np.where(rng.random((batch, L, 1 + L)) > 0.1, 0.0, da.NEG).astype(np.float32)
    rbias = np.where(rng.random((batch, 1, L)) > 0.1, 0.0, da.NEG).astype(np.float32)
    dt = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return (qkv.to(device, dt), qkvc.to(device, dt), torch.from_numpy(sbias).to(device),
            torch.from_numpy(rbias).to(device))


def dense_inputs(qkv, qkvc, sbias, rbias, heads=H, dim_head=DH):
    """The divided attention as one dense attention over the CLS row and all
    G*L tokens: q, k, v (B, H, 1+G*L, dh), CLS first, and a boolean mask
    (B, 1, N, N) that keeps each token to the CLS key and its own group (and
    ``sbias``, which may be None) and the CLS row to every key its ``rbias``
    allows."""
    Bq, G, L, _ = qkv.shape
    N, dev = 1 + G * L, qkv.device
    t = qkv.unflatten(-1, (3, heads, dim_head))
    tc = qkvc[:, 0].unflatten(-1, (3, heads, dim_head))
    q, k, v = (torch.cat([tc[:, i, :, None], t[..., i, :, :].reshape(Bq, G * L, heads, dim_head)
                          .transpose(1, 2)], dim=2).contiguous() for i in range(3))
    pos = torch.arange(G * L, device=dev)
    tok = (pos[:, None] // L == pos[None, :] // L).expand(Bq, G * L, G * L)
    if sbias is not None:
        keep = sbias > da.NEG / 2  # (B, L, 1+L), column 0 the CLS key
        tok = tok & keep[:, pos % L][:, :, 1 + pos % L]
    mask = torch.zeros(Bq, N, N, dtype=torch.bool, device=dev)
    mask[:, 0, 0] = True
    mask[:, 0, 1:] = (rbias.expand(Bq, G, L) > da.NEG / 2).reshape(Bq, G * L)
    mask[:, 1:, 0] = True if sbias is None else sbias[:, pos % L, 0] > da.NEG / 2
    mask[:, 1:, 1:] = tok
    return q, k, v, mask[:, None]


def split_dense(o, G, L):
    """(B, H, 1+G*L, dh) → (tokens (B, G, L, H*dh), CLS (B, 1, H*dh))."""
    Bo, heads, _, dh = o.shape
    return (o[:, :, 1:].transpose(1, 2).reshape(Bo, G, L, heads * dh),
            o[:, :, 0].reshape(Bo, 1, heads * dh))


def dense_plain(q, k, v, mask):
    """Plain dense masked attention (q scaled here in its dtype, fp32
    softmax, probabilities rounded to v's dtype before PV)."""
    f32 = torch.float32
    logits = torch.einsum("bhqd,bhkd->bhqk", (q * q.shape[-1] ** -0.5).to(f32), k.to(f32))
    logits = logits.masked_fill(~mask, da.NEG)
    attn = torch.softmax(logits, dim=-1).to(v.dtype).to(f32)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v.to(f32)).to(v.dtype)


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def run(device="cuda") -> list[dict]:
    """One row a geometry: each variant's ms per call and B's, G's and D's
    max abs errors against A, token rows and CLS row."""
    dev = require_card(device)
    kw = dict(heads=H, dim_head=DH)
    rows = []
    for axis, (G, L) in GEOMS.items():
        P = P_BY_AXIS[axis]
        qkv, qkvc, sbias, rbias = make_inputs(G, L, device=dev)
        variants = {
            "A": lambda: da.divided_attention_cuda(qkv, qkvc, sbias, rbias, **kw),
            "B": lambda: (tr.token_rows_attention_cuda(qkv, qkvc, sbias, **kw),
                          tr.cls_row_plain(qkv, qkvc, rbias, **kw)),
            "G": lambda: ca.chunked_attention_cuda(qkv, qkvc, sbias, rbias, P=P, **kw),
            "E": lambda: da.divided_attention_plain(qkv, qkvc, sbias, rbias, **kw),
        }
        dq, dk, dv, dmask = dense_inputs(qkv, qkvc, sbias, rbias)
        variants["D_plain"] = lambda: split_dense(dense_plain(dq, dk, dv, dmask), G, L)
        variants["D_sdpa"] = lambda: split_dense(
            F.scaled_dot_product_attention(dq, dk, dv, attn_mask=dmask), G, L)
        row = {"axis": axis, "B": B, "G": G, "L": L, "H": H, "dh": DH, "P": P,
               "Lp": ca.padded_sizes(G, L, P)[1]}
        ref = variants["A"]()
        for name, fn in variants.items():
            row[f"{name}_ms"] = time_ms(fn)
            if name != "A":
                got = fn()
                row[f"{name}_vs_A_tok"], row[f"{name}_vs_A_cls"] = _err(got[0], ref[0]), _err(got[1], ref[1])
        rows.append(row)
        del qkv, qkvc, dq, dk, dv, dmask, ref, variants
        torch.cuda.empty_cache()
    return rows


LABELS = {"A": "A whole-slice kernels", "B": "B token-row kernel + plain CLS",
          "G": "G chunked-dense kernel", "D_plain": "D dense masked, plain",
          "D_sdpa": "D dense masked, one SDPA call", "E": "E plain grouped"}


def main() -> None:
    print(f"card: {card()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    for row in run():
        print(f"\n=== {row['axis']} axis: G={row['G']} L={row['L']} B={row['B']} H={row['H']}"
              f" dh={row['dh']}; G packs P={row['P']} groups of Lp={row['Lp']} ===")
        for key, label in LABELS.items():
            line = f"  {label:34s} {row[f'{key}_ms']:8.3f} ms/call"
            if key != "A":
                line += f"   vs A max |err| tok {row[f'{key}_vs_A_tok']:.2e} cls {row[f'{key}_vs_A_cls']:.2e}"
            print(line)


if __name__ == "__main__":
    main()
