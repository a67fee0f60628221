"""The heads of MINTIME (Coccomini et al., arXiv:2211.10996) as plain float32
PyTorch over a state dict: the Size-Invariant TimeSformer of MINTIME-EF and the
Convolutional TimeSformer's head.

Both keep two streams, the patch tokens ``(B, F, n, dim)`` and the CLS token
``(B, 1, dim)``, through ``depth`` layers of a time attention, a space
attention (divided attention: each token attends its own group plus the CLS
key; the CLS token attends every token and itself) and a GEGLU feed-forward
(``Linear -> val * gelu(gate) -> Linear``), each pre-normed by one LayerNorm
shared by both streams. ``to_qkv`` packs ``[q | k | v]`` with the heads inside
each third. Keys are the reference repository's.

The flagship masks padded frames out of every CLS row and, on the time axis,
each query frame sees only the frames of its own identity; its last layer
returns the CLS rows' maps. The conv head has no masks: its tokens are the
``F * C`` channel maps of width ``h * w``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.numerics import Numerics

NUM_SIZE_BUCKETS = 20
LN_EPS = 1e-5


def _layer_spec(p: str, dim: int, heads: int, dim_head: int) -> list:
    inner = heads * dim_head
    spec = []
    for a in (0, 1):
        spec += [(f"{p}.{a}.norm.weight", (dim,), "ones"), (f"{p}.{a}.norm.bias", (dim,), "zeros"),
                 (f"{p}.{a}.fn.to_qkv.weight", (3 * inner, dim), "trunc"),
                 (f"{p}.{a}.fn.to_out.0.weight", (dim, inner), "trunc"),
                 (f"{p}.{a}.fn.to_out.0.bias", (dim,), "zeros")]
    return spec + [(f"{p}.2.norm.weight", (dim,), "ones"), (f"{p}.2.norm.bias", (dim,), "zeros"),
                   (f"{p}.2.fn.net.0.weight", (8 * dim, dim), "trunc"),
                   (f"{p}.2.fn.net.0.bias", (8 * dim,), "zeros"),
                   (f"{p}.2.fn.net.3.weight", (dim, 4 * dim), "trunc"),
                   (f"{p}.2.fn.net.3.bias", (dim,), "zeros")]


def param_spec(prefix: str, m: dict, patch_dim: int, tokens: int) -> list:
    """(key, shape, init) of a head: ``patch_dim`` inputs a token and
    ``tokens`` positions besides the CLS one."""
    dim = m["dim"]
    spec = [(f"{prefix}.to_patch_embedding.weight", (dim, patch_dim), "trunc"),
            (f"{prefix}.to_patch_embedding.bias", (dim,), "zeros"),
            (f"{prefix}.cls_token", (1, dim), "trunc"),
            (f"{prefix}.pos_emb.weight", (1 + tokens, dim), "trunc"),
            (f"{prefix}.size_emb.weight", (1 + NUM_SIZE_BUCKETS, dim), "trunc")]
    for i in range(m["depth"]):
        spec += _layer_spec(f"{prefix}.layers.{i}", dim, m["heads"], m["dim_head"])
    return spec + [(f"{prefix}.to_out.0.weight", (dim,), "ones"),
                   (f"{prefix}.to_out.0.bias", (dim,), "zeros"),
                   (f"{prefix}.to_out.1.weight", (m["num_classes"], dim), "trunc"),
                   (f"{prefix}.to_out.1.bias", (m["num_classes"],), "zeros")]


def _ln(sd, p, x, num: Numerics):
    return num.q(F.layer_norm(x, x.shape[-1:], sd[f"{p}.weight"], sd[f"{p}.bias"], LN_EPS))


def _softmax(logits, keep=None):
    if keep is not None:
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.softmax(logits, dim=-1)


def attention(sd, p, x_tok, x_cls, axis: str, heads: int, dim_head: int, num: Numerics,
              frame_mask=None, cls_mask=None, want_map: bool = False):
    """One divided attention. ``x_tok (B, F, n, D)``, ``x_cls (B, 1, D)``;
    time: groups are the n positions, sequences the F frames, under
    ``frame_mask (B, F, 1 + F)`` (column 0 the CLS key); space: groups are the
    F frames. ``cls_mask (B, F)`` keeps frames in the CLS row. Returns the
    two streams' outputs and, with ``want_map``, the CLS row's probabilities
    ``(B, H, 1 + F * n)`` (CLS first, tokens frame-major)."""
    B, Fr, n, _ = x_tok.shape
    H, dh = heads, dim_head
    w = sd[f"{p}.fn.to_qkv.weight"]
    t = num.linear(x_tok, w).unflatten(-1, (3, H, dh))  # (B, F, n, 3, H, dh)
    c = num.linear(x_cls[:, 0], w).unflatten(-1, (3, H, dh))  # (B, 3, H, dh)
    scale = dh ** -0.5
    q, k, v = (t[..., i, :, :] for i in range(3))  # (B, F, n, H, dh)
    qc, kc, vc = c[:, 0] * scale, c[:, 1], c[:, 2]  # (B, H, dh)
    if axis == "time":
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))  # (B, G=n, L=F, H, dh)
    q = q * scale
    # token rows: CLS key first, then the group's keys
    lt = num.einsum("bglhd,bgmhd->bhglm", q, k)
    lc = num.einsum("bglhd,bhd->bhgl", q, kc)[..., None]
    keep = None
    if axis == "time" and frame_mask is not None:
        keep = frame_mask[:, None, None]  # (B, 1, 1, L, 1 + L)
    pr = _softmax(torch.cat([lc, lt], dim=-1), keep)
    o = (num.einsum("bhglm,bgmhd->bglhd", pr[..., 1:], v)
         + num.einsum("bhgl,bhd->bglhd", pr[..., 0], vc))
    if axis == "time":
        o = o.transpose(1, 2)
    o = o.reshape(B, Fr, n, H * dh)
    # the CLS row over itself and every kept token, tokens frame-major
    kt = (k.transpose(1, 2) if axis == "time" else k).reshape(B, Fr * n, H, dh)
    vt = (v.transpose(1, 2) if axis == "time" else v).reshape(B, Fr * n, H, dh)
    lr = torch.cat([num.einsum("bhd,bhd->bh", qc, kc)[..., None],
                    num.einsum("bhd,bthd->bht", qc, kt)], dim=-1)  # (B, H, 1 + F*n)
    rkeep = None
    if cls_mask is not None:
        tok = cls_mask[:, :, None].expand(B, Fr, n).reshape(B, 1, Fr * n)
        rkeep = torch.cat([torch.ones_like(tok[..., :1]), tok], dim=-1)
    pc = _softmax(lr, rkeep)
    oc = (num.einsum("bht,bthd->bhd", pc[..., 1:], vt)
          + num.einsum("bh,bhd->bhd", pc[..., 0], vc)).reshape(B, 1, H * dh)
    wo, bo = sd[f"{p}.fn.to_out.0.weight"], sd[f"{p}.fn.to_out.0.bias"]
    return num.linear(o, wo, bo), num.linear(oc, wo, bo), (pc if want_map else None)


def geglu(sd, p, x, num: Numerics):
    val, gate = num.linear(x, sd[f"{p}.fn.net.0.weight"], sd[f"{p}.fn.net.0.bias"]).chunk(2, -1)
    return num.linear(val * F.gelu(gate), sd[f"{p}.fn.net.3.weight"], sd[f"{p}.fn.net.3.bias"])


def layer(sd, p, x_tok, x_cls, m: dict, num: Numerics, frame_mask=None, cls_mask=None,
          want_map: bool = False):
    maps = []
    for a, axis in ((0, "time"), (1, "space")):
        pa = f"{p}.{a}"
        y_tok, y_cls, mp = attention(sd, pa, _ln(sd, f"{pa}.norm", x_tok, num),
                                     _ln(sd, f"{pa}.norm", x_cls, num), axis, m["heads"],
                                     m["dim_head"], num, frame_mask, cls_mask, want_map)
        x_tok, x_cls = num.q(x_tok + y_tok), num.q(x_cls + y_cls)
        maps.append(mp)
    pf = f"{p}.2"
    x_tok = num.q(x_tok + geglu(sd, pf, _ln(sd, f"{pf}.norm", x_tok, num), num))
    x_cls = num.q(x_cls + geglu(sd, pf, _ln(sd, f"{pf}.norm", x_cls, num), num))
    return x_tok, x_cls, maps


def _layers(sd, prefix, x_tok, x_cls, m, num, frame_mask, cls_mask, want_map, checkpoint):
    maps = None
    for i in range(m["depth"]):
        last = want_map and i == m["depth"] - 1
        p = f"{prefix}.layers.{i}"
        if checkpoint and x_tok.requires_grad:
            x_tok, x_cls = torch.utils.checkpoint.checkpoint(
                lambda a, b, pp=p: layer(sd, pp, a, b, m, num, frame_mask, cls_mask)[:2],
                x_tok, x_cls, use_reentrant=False)
        else:
            x_tok, x_cls, mp = layer(sd, p, x_tok, x_cls, m, num, frame_mask, cls_mask, last)
            if last:
                maps = mp
    return x_tok, x_cls, maps


def _logits(sd, prefix, x_cls, num):
    out = _ln(sd, f"{prefix}.to_out.0", x_cls[:, 0], num)
    return num.linear(out, sd[f"{prefix}.to_out.1.weight"], sd[f"{prefix}.to_out.1.bias"])


def frame_mask(mask, identities_mask):
    """``(B, F, 1 + F)``: the CLS key, then key frame k for query frame q
    where k is kept and shares q's identity."""
    B, Fr = mask.shape
    fm = mask[:, None, :].expand(B, Fr, Fr) & identities_mask
    return torch.cat([torch.ones_like(fm[..., :1]), fm], dim=-1)


def size_invariant(sd, prefix, feats, mask, identities_mask, size_embedding, positions,
                   m: dict, num: Numerics, want_maps: bool = False, checkpoint: bool = False):
    """The flagship head: ``feats (B, F, h, w, C)`` -> logits ``(B, 1)`` and,
    with ``want_maps``, the last layer's CLS rows ``[space, time]``, each
    ``(B, H, 1 + F * n)``."""
    B, Fr, h, w, C = feats.shape
    n = h * w
    x_tok = num.linear(feats.reshape(B, Fr, n, C), sd[f"{prefix}.to_patch_embedding.weight"],
                       sd[f"{prefix}.to_patch_embedding.bias"])
    pos, size = sd[f"{prefix}.pos_emb.weight"], sd[f"{prefix}.size_emb.weight"]
    x_cls = sd[f"{prefix}.cls_token"][None].expand(B, 1, m["dim"]) + pos[positions[:, :1].long()]
    x_tok = x_tok + pos[positions[:, 1:].long()].reshape(B, Fr, n, m["dim"])
    x_tok = x_tok + size[size_embedding.long()][:, :, None, :]
    x_cls = x_cls + size[0]
    fm = frame_mask(mask, identities_mask)
    x_tok, x_cls, maps = _layers(sd, prefix, x_tok, x_cls, m, num, fm, mask, want_maps,
                                 checkpoint)
    logits = _logits(sd, prefix, x_cls, num)
    return (logits, [maps[1], maps[0]]) if want_maps else logits


def conv_head(sd, prefix, feats, size_embedding, m: dict, num: Numerics,
              checkpoint: bool = False):
    """The Convolutional TimeSformer's head: ``feats (B, F, h, w, C)`` -> logits
    ``(B, 1)``; one token a channel map, every token of frame f in f's size
    bucket."""
    B, Fr, h, w, C = feats.shape
    x_tok = num.linear(feats.reshape(B, Fr, h * w, C).transpose(2, 3),
                       sd[f"{prefix}.to_patch_embedding.weight"],
                       sd[f"{prefix}.to_patch_embedding.bias"])  # (B, F, C, dim)
    pos, size = sd[f"{prefix}.pos_emb.weight"], sd[f"{prefix}.size_emb.weight"]
    x_cls = sd[f"{prefix}.cls_token"][None].expand(B, 1, m["dim"]) + pos[0]
    x_tok = x_tok + pos[1:].reshape(Fr, C, m["dim"])
    x_tok = x_tok + size[size_embedding.long()][:, :, None, :]
    x_cls = x_cls + size[0]
    x_tok, x_cls, _ = _layers(sd, prefix, x_tok, x_cls, m, num, None, None, False, checkpoint)
    return _logits(sd, prefix, x_cls, num)
