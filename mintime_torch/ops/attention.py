"""Plain grouped attention with a CLS key/value column (counterpart of
``mintime_tpu/ops/attention.py:25-71``).

This is the path of the layer that returns attention maps, and the fp32
reference for the divided-attention kernel. Softmax runs in fp32 whatever the
input dtype; masked logits are filled with ``-finfo(float32).max``.
"""

from __future__ import annotations

import torch

NEG_MAX = -torch.finfo(torch.float32).max


def _masked_softmax(logits: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Softmax over the last axis in fp32; False mask entries get -finfo.max."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_MAX))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits)
    return unnorm / unnorm.sum(dim=-1, keepdim=True)


def grouped_attention_with_cls(q_g, k_g, v_g, k_cls, v_cls, mask):
    """Attention within groups (time or space), each group augmented with CLS.

    Args:
      q_g, k_g, v_g: (B, H, G, L, d), q already scaled.
      k_cls, v_cls: (B, H, 1, d) CLS key/value shared across groups.
      mask: (B, G or 1, L, 1+L) bool or None, broadcast over heads; column 0
        is the CLS key.

    Returns (B, H, G, L, d) in v's dtype.
    """
    logits_tok = torch.einsum("bhgld,bhgmd->bhglm", q_g, k_g)
    logits_cls = torch.einsum("bhgld,bhd->bhgl", q_g, k_cls[:, :, 0])[..., None]
    logits = torch.cat([logits_cls, logits_tok], dim=-1)  # (B, H, G, L, 1+L)
    m = mask[:, None] if mask is not None else None
    attn = _masked_softmax(logits, m).to(v_g.dtype)
    out = torch.einsum("bhglm,bhgmd->bhgld", attn[..., 1:], v_g)
    return out + attn[..., :1] * v_cls[:, :, 0][:, :, None, None, :]


def build_frame_mask(mask: torch.Tensor, identities_mask: torch.Tensor | None) -> torch.Tensor:
    """Time-attention mask ``(B, F, F+1)``: ``mask[b, k] AND
    identities_mask[b, q, k]`` with an always-True leading CLS-key column."""
    b, f = mask.shape
    fm = mask[:, None, :].expand(b, f, f)
    if identities_mask is not None:
        fm = fm & identities_mask
    ones = torch.ones((b, f, 1), dtype=torch.bool, device=mask.device)
    return torch.cat([ones, fm], dim=-1)
