"""Size-Invariant TimeSformer (counterpart of
``mintime_tpu/models/timesformer.py:64-411``): ``GEGLU``,
``DividedAttention``, ``pre_token_shift`` and ``SizeInvariantTimeSformer``.

Two residual streams as in the JAX package: patch tokens ``(B, F, n, dim)``
and the CLS token ``(B, 1, dim)``. Module and key names are the reference's
(``layers.{i}.{0,1,2}.norm`` / ``.fn.to_qkv`` / ``.fn.to_out.0`` /
``.fn.net.{0,3}``, ``to_out.{0,1}``), and ``to_qkv`` is packed
``[q|k|v]``-major, so a reference state_dict loads with ``load_state_dict``.
Embedding tables hold the rows that are indexed: ``1 + F * num_patches``
positions and ``1 + NUM_SIZE_BUCKETS`` sizes.

With ``use_kernels`` the FFNs go through :func:`mintime_torch.ops.geglu_ffn.
geglu_ffn` when their dropout is 0 or the module is in eval mode (the JAX
rule, ``timesformer.py:87``), and every attention that returns no map and
attends over at most 256 positions goes through
:func:`mintime_torch.ops.divided_attention.divided_attention`, which picks the
whole-slice or the token-row kernels by the slice's size; both are
differentiable, with backward kernels on the card. On the card the kernels
are built for widths 512 and 256 and dim_head 64 (up to 256 rows a group on
the whole-slice path, 32 on the token rows), and their wrappers raise on any
other geometry. The last layer under
``require_attention`` takes the plain path and returns its CLS-row maps in
the ``(B·heads, 1, 1+F·n)`` layout. Dropout sits where the JAX package puts
it: after each attention's output projection (``attn_dropout``) and on the
GEGLU product (``ff_dropout``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mintime_torch.config import ModelConfig
from mintime_torch.data.assembler import NUM_SIZE_BUCKETS
from mintime_torch.ops.attention import NEG_MAX, build_frame_mask, grouped_attention_with_cls
from mintime_torch.ops.divided_attention import _KERNEL_MAX_L, divided_attention, mask_to_bias
from mintime_torch.ops.geglu_ffn import geglu_ffn

#: longest attended axis that takes the divided-attention kernels (``timesformer.py:153``)
KERNEL_MAX_AXIS = _KERNEL_MAX_L


class GEGLU(nn.Module):
    """Linear → val · gelu_erf(gates) → Linear (reference ``net.0`` / ``net.3``)."""

    def __init__(self, dim: int, mult: int = 4, use_kernels: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        hidden = dim * mult
        self.use_kernels = use_kernels
        self.net = nn.ModuleDict({"0": nn.Linear(dim, 2 * hidden), "2": nn.Dropout(dropout),
                                  "3": nn.Linear(hidden, dim)})

    def forward(self, x):
        l0, drop, l1 = self.net["0"], self.net["2"], self.net["3"]
        if self.use_kernels and (drop.p == 0.0 or not self.training):
            return geglu_ffn(x, l0.weight, l0.bias, l1.weight, l1.bias)
        val, gates = l0(x).chunk(2, dim=-1)
        return l1(drop(val * F.gelu(gates)))


class DividedAttention(nn.Module):
    """One attention over the time or the space axis of the two-stream layout.

    ``axis='time'``: groups are the n patches, the sequence is the F frames,
    masked by ``frame_mask``; ``axis='space'``: groups are the F frames, the
    sequence is the n patches. The CLS row attends to every token under
    ``cls_mask``; every token also attends to the CLS key/value.
    """

    def __init__(self, dim: int, heads: int, dim_head: int, use_kernels: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.use_kernels = use_kernels
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.ModuleDict({"0": nn.Linear(inner, dim), "1": nn.Dropout(dropout)})

    def forward(self, x_tok, x_cls, *, axis: str, frame_mask=None, cls_mask=None,
                need_attn: bool = True):
        B, f, n, _ = x_tok.shape
        H, dh = self.heads, self.dim_head

        def proj(o):
            return self.to_out["1"](self.to_out["0"](o))

        qkv_tok = self.to_qkv(x_tok)  # (B, f, n, 3*inner)
        qkv_cls = self.to_qkv(x_cls)  # (B, 1, 3*inner)
        axis_len = f if axis == "time" else n
        if self.use_kernels and not need_attn and axis_len <= KERNEL_MAX_AXIS:
            rbias = mask_to_bias(cls_mask) if cls_mask is not None else None
            if axis == "time":  # groups = n patches: a strided view, no copy
                qkv_g = qkv_tok.transpose(1, 2)
                seq_bias = mask_to_bias(frame_mask) if frame_mask is not None else None
                row_bias = rbias[:, None, :] if rbias is not None else None
            else:
                qkv_g, seq_bias = qkv_tok, None
                row_bias = rbias[:, :, None] if rbias is not None else None
            o_g, o_cls = divided_attention(qkv_g, qkv_cls, seq_bias, row_bias,
                                           heads=H, dim_head=dh)
            o_tok = o_g.transpose(1, 2) if axis == "time" else o_g
            return proj(o_tok), proj(o_cls), None

        # plain path (also the attention-map path): grouped (B, H, G, L, d)
        scale = dh ** -0.5
        t = qkv_tok.unflatten(-1, (3, H, dh))  # (B, f, n, 3, H, dh)
        order = (0, 3, 2, 1, 4) if axis == "time" else (0, 3, 1, 2, 4)
        q_g = t[..., 0, :, :].permute(order) * scale
        k_g = t[..., 1, :, :].permute(order)
        v_g = t[..., 2, :, :].permute(order)
        tc = qkv_cls[:, 0].unflatten(-1, (3, H, dh))  # (B, 3, H, dh)
        q_cls, k_cls, v_cls = tc[:, 0] * scale, tc[:, 1], tc[:, 2]

        # CLS row over every token and itself, in the grouped layout
        lt = torch.einsum("bhe,bhgle->bhgl", q_cls, k_g).float()
        lc = torch.einsum("bhe,bhe->bh", q_cls, k_cls).float()
        if cls_mask is not None:
            tok_mask = cls_mask[:, :, None].expand(B, f, n)
            if axis == "time":
                tok_mask = tok_mask.transpose(1, 2)
            lt = torch.where(tok_mask[:, None], lt, torch.full_like(lt, NEG_MAX))
        m = torch.maximum(lt.amax(dim=(2, 3)), lc)
        pt = torch.exp(lt - m[:, :, None, None])
        pc = torch.exp(lc - m)
        z = pt.sum(dim=(2, 3)) + pc
        pt = pt / z[:, :, None, None]
        pc = pc / z
        cls_out = (torch.einsum("bhgl,bhgle->bhe", pt.to(v_g.dtype), v_g)
                   + pc[:, :, None].to(v_cls.dtype) * v_cls)  # (B, H, d)

        cls_attn = None
        if need_attn:  # reference layout (B, H, 1, 1+F*n): CLS first, tokens f-major
            p_tok = pt.transpose(2, 3) if axis == "time" else pt
            cls_attn = torch.cat([pc[:, :, None], p_tok.reshape(B, H, f * n)], dim=-1)
            cls_attn = cls_attn[:, :, None, :].float()

        mask = frame_mask[:, None] if axis == "time" and frame_mask is not None else None
        out_g = grouped_attention_with_cls(q_g, k_g, v_g, k_cls[:, :, None], v_cls[:, :, None],
                                           mask)
        back = (0, 3, 2, 1, 4) if axis == "time" else (0, 2, 3, 1, 4)
        out_tok = out_g.permute(back).reshape(B, f, n, H * dh)
        out_cls = cls_out.reshape(B, 1, H * dh)
        return proj(out_tok), proj(out_cls), cls_attn


def pre_token_shift(x_tok):
    """Shift the first three ``dim // 3`` channel chunks of the patch tokens
    along the frame axis by (-1, 0, +1), zero-filling the vacated frame."""
    dc = x_tok.shape[-1] // 3

    def sh(t, amt):
        if amt == 0:
            return t
        t = F.pad(t, (0, 0, 0, 0, max(amt, 0), max(-amt, 0)))
        return t[:, :-amt] if amt > 0 else t[:, -amt:]

    return torch.cat([
        sh(x_tok[..., :dc], -1), x_tok[..., dc:2 * dc], sh(x_tok[..., 2 * dc:3 * dc], 1),
        x_tok[..., 3 * dc:],
    ], dim=-1)


class PreNorm(nn.Module):
    """LayerNorm shared by both streams, then ``fn`` (reference ``norm`` / ``fn``)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn


class SizeInvariantTimeSformer(nn.Module):
    """Video-level classifier over per-face CNN feature maps.

    Forward: ``x (B, F, h, w, C)``, ``mask (B, F)`` bool, ``identities_mask
    (B, F, F)`` bool, ``size_embedding (B, F)`` int, ``positions (B, 1+F*n)``
    int → logits ``(B, num_classes)`` fp32; with ``require_attention`` also
    the last layer's CLS-row maps ``[space, time]``, each ``(B*heads, 1,
    1+F*n)`` fp32.
    """

    def __init__(self, config: ModelConfig, require_attention: bool = False,
                 use_kernels: bool = False):
        super().__init__()
        cfg = self.config = config
        self.require_attention = require_attention
        F_, n, dim = cfg.num_frames, cfg.num_patches, cfg.dim
        self.to_patch_embedding = nn.Linear(cfg.channels, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, dim))
        self.pos_emb = nn.Embedding(1 + F_ * n, dim)
        if cfg.enable_size_emb:
            self.size_emb = nn.Embedding(1 + NUM_SIZE_BUCKETS, dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, DividedAttention(dim, cfg.heads, cfg.dim_head, use_kernels,
                                              cfg.attn_dropout)),
                PreNorm(dim, DividedAttention(dim, cfg.heads, cfg.dim_head, use_kernels,
                                              cfg.attn_dropout)),
                PreNorm(dim, GEGLU(dim, use_kernels=use_kernels, dropout=cfg.ff_dropout)),
            ])
            for _ in range(cfg.depth)
        )
        self.to_out = nn.Sequential(nn.LayerNorm(dim, eps=1e-5), nn.Linear(dim, cfg.num_classes))
        self.to_out[1].keep_param_dtype = True  # fp32, as the JAX package's out_proj

    def forward(self, x, mask=None, identities_mask=None, size_embedding=None, positions=None):
        cfg = self.config
        B, F_, h, w, C = x.shape
        n = h * w
        if n != cfg.num_patches:
            raise ValueError(f"feature grid {h}x{w} != num-patches {cfg.num_patches}")
        dev = x.device
        x_tok = self.to_patch_embedding(x.reshape(B, F_, n, C))
        x_cls = self.cls_token[None].expand(B, 1, cfg.dim)

        if cfg.enable_pos_emb and positions is not None:
            positions = positions.long()
            x_cls = x_cls + self.pos_emb(positions[:, :1])
            x_tok = x_tok + self.pos_emb(positions[:, 1:].reshape(B, F_, n))
        else:
            table = self.pos_emb.weight[: 1 + F_ * n]
            x_cls = x_cls + table[:1][None]
            x_tok = x_tok + table[1:].reshape(F_, n, cfg.dim)[None]
        if cfg.enable_size_emb:
            x_tok = x_tok + self.size_emb(size_embedding.long())[:, :, None, :]
            x_cls = x_cls + self.size_emb.weight[0]

        if mask is None:
            mask = torch.ones((B, F_), dtype=torch.bool, device=dev)
        if identities_mask is None or not cfg.enable_identity_attention:
            identities_mask = torch.ones((B, F_, F_), dtype=torch.bool, device=dev)
        frame_mask = build_frame_mask(mask, identities_mask)
        shift = pre_token_shift if cfg.shift_tokens else (lambda t: t)

        attns = {}
        for i, (time_attn, space_attn, ff) in enumerate(self.layers):
            need_attn = self.require_attention and i == cfg.depth - 1
            for axis, pre in (("time", time_attn), ("space", space_attn)):
                y_tok, y_cls, attns[axis] = pre.fn(
                    shift(pre.norm(x_tok)), pre.norm(x_cls), axis=axis,
                    frame_mask=frame_mask if axis == "time" else None, cls_mask=mask,
                    need_attn=need_attn,
                )
                x_tok = x_tok + y_tok
                x_cls = x_cls + y_cls
            x_tok = x_tok + ff.fn(shift(ff.norm(x_tok)))
            x_cls = x_cls + ff.fn(ff.norm(x_cls))

        cls_out = self.to_out[0](x_cls[:, 0])
        head = self.to_out[1]  # fp32, as the JAX package's out_proj
        logits = F.linear(cls_out.float(), head.weight.float(), head.bias.float())
        if self.require_attention:
            def ref_layout(a):  # (B, H, 1, N) -> (B*H, 1, N)
                return a.reshape(a.shape[0] * a.shape[1], 1, a.shape[-1])

            return logits, [ref_layout(attns["space"]), ref_layout(attns["time"])]
        return logits
