"""Convolutional TimeSformer (counterpart of
``mintime_tpu/models/conv_timesformer.py:34-113``, the MINTIME-EF "conv"
variant, ``--model 3`` of the JAX package's training and evaluation).

A frozen EfficientNet-B0 tapped at ``efficient-net-block`` turns each frame
into a ``(h, w, C)`` feature map; every one of the ``F * C`` channel maps is a
token of width ``h * w`` (``'b f c h w -> b (f c) (h w)'``). Divided
attention then alternates over the frame axis (time: G = C groups of L = F)
and the channel axis (space: G = F groups of L = C), with no masks and no
token shift, followed by a GEGLU FFN; the CLS token feeds the output
projection. The JAX package's two divergences from the reference file hold
here too: ``to_patch_embedding`` is ``Linear(h * w, dim)``, and every token of
frame ``f`` takes that frame's size bucket.

Parameters sit under ``extractor.`` and ``head.`` as in the flagship
classifier, and the head's keys are the flagship TimeSformer's
(``to_patch_embedding``, ``cls_token``, ``pos_emb``, ``size_emb``,
``layers.{i}.{0,1,2}``, ``to_out.{0,1}``). Seeded init, placement and the
per-forward cast of fp32 master parameters to the compute dtype are the
classifier's (:class:`~mintime_torch.models.classifier.CastModel`).

With ``use_kernels`` the head's FFNs run the GEGLU kernels (width 256 at the
preset) and the time axis runs :func:`~mintime_torch.ops.divided_attention.
divided_attention`, whose packed qkv (1280 groups of 8) exceeds the
whole-slice budget and so takes the token-row kernels; the space axis (L =
1280) stays on the plain path, as in the JAX package (``timesformer.py:153``).
Tapped at blocks 4-13 (80, 112 or 192 channels) both axes fit the whole-slice
kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mintime_torch.config import ModelConfig
from mintime_torch.data.assembler import NUM_SIZE_BUCKETS
from mintime_torch.device import resolve_device
from mintime_torch.models.classifier import CastModel
from mintime_torch.models.efficientnet import EfficientNet
from mintime_torch.models.timesformer import GEGLU, DividedAttention, PreNorm


class ConvTimeSformerHead(nn.Module):
    """Feature maps ``(B, F, h, w, C)`` and size buckets ``(B, F)`` → logits
    ``(B, num_classes)`` fp32."""

    def __init__(self, config: ModelConfig, patch_dim: int, channels: int,
                 use_kernels: bool = False):
        super().__init__()
        cfg = self.config = config
        dim = cfg.dim
        self.to_patch_embedding = nn.Linear(patch_dim, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, dim))
        self.pos_emb = nn.Embedding(1 + cfg.num_frames * channels, dim)
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

    def forward(self, feats, size_embedding=None):
        B, F_, h, w, C = feats.shape
        dim = self.config.dim
        # 'b f h w c -> b f c (h w)': one token per channel map
        x_tok = self.to_patch_embedding(feats.reshape(B, F_, h * w, C).transpose(2, 3))
        table = self.pos_emb.weight
        x_cls = self.cls_token[None].expand(B, 1, dim) + table[:1][None]
        x_tok = x_tok + table[1:].reshape(F_, C, dim)[None]
        if size_embedding is not None:
            x_tok = x_tok + self.size_emb(size_embedding.long())[:, :, None, :]
            x_cls = x_cls + self.size_emb.weight[0]

        for time_attn, space_attn, ff in self.layers:
            for axis, pre in (("time", time_attn), ("space", space_attn)):
                y_tok, y_cls, _ = pre.fn(pre.norm(x_tok), pre.norm(x_cls), axis=axis,
                                         need_attn=False)
                x_tok = x_tok + y_tok
                x_cls = x_cls + y_cls
            x_tok = x_tok + ff.fn(ff.norm(x_tok))
            x_cls = x_cls + ff.fn(ff.norm(x_cls))

        cls_out = self.to_out[0](x_cls[:, 0])
        head = self.to_out[1]
        return F.linear(cls_out.float(), head.weight.float(), head.bias.float())


class ConvolutionalTimeSformer(CastModel):
    """frames ``(B, F, H, W, 3)`` (uint8 or float, NHWC) → logits ``(B,
    num_classes)`` fp32.

    Built on ``device`` (default ``"cuda"``, which raises without a card),
    computing in ``dtype`` (bf16 on the card, fp32 on the CPU by default) with
    parameters in ``param_dtype`` (default ``dtype``), weights from
    ``torch.Generator().manual_seed(seed)``. The feature grid and the channel
    count follow from ``config.image_size`` and ``config.efficient_net_block``.
    ``use_kernels`` routes the head's FFNs and time-axis attention through the
    CUDA kernels on the card (their plain versions on the CPU).
    """

    head_kind = "conv_timesformer"

    def __init__(self, config: ModelConfig, use_kernels: bool = False,
                 device: str | torch.device = "cuda", dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype | None = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.extractor = EfficientNet("efficientnet-b0", tap_block=config.efficient_net_block)
        grid = self.extractor.grid(config.image_size)
        self.head = ConvTimeSformerHead(config, grid * grid, self.extractor.feature_dim,
                                        use_kernels)
        self._place(dev, dtype, param_dtype, seed)

    def forward(self, frames, mask=None, size_embedding=None, *, train: bool = False,
                generator: torch.Generator | None = None):
        """``train`` picks train mode for the head (dropout); the extractor
        always runs in eval mode without a graph, as the JAX package runs it
        with ``train=False`` under ``stop_gradient``, so its statistics never
        move and its parameters get no gradient. ``mask`` is accepted for the
        train step's inputs and unused, as in the JAX package; so is
        ``generator``, which drives only the extractor's drop-connect."""
        B, F_ = frames.shape[:2]
        x = frames.reshape((B * F_,) + frames.shape[2:]).to(self.compute_dtype)
        self.extractor.eval()
        with torch.no_grad():
            feats = self._in_compute_dtype("extractor", x)
        self.head.train(train)
        feats = feats.reshape((B, F_) + feats.shape[1:])
        return self._in_compute_dtype("head", feats, size_embedding).float()
