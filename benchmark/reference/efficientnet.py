"""EfficientNet-B0 as plain float32 PyTorch over a state dict: the feature
maps ``(N, H, W, 3) -> (N, h, w, C)`` of Tan and Le (arXiv:1905.11946), with
TensorFlow's SAME padding, squeeze-excite, BatchNorm with eps 1e-3 (the batch's
mean and biased variance in train mode) and, in train mode, residual branches
dropped per sample at ``0.2 * idx / 16``. Keys are the reference repository's
(``_conv_stem``, ``_blocks.{i}._depthwise_conv``, ...).

Tapped at block ``tap`` (MINTIME's ``extract_features_at_block``), the blocks
run up to index ``tap + 1`` and the head conv only when ``tap >= 16``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.numerics import Numerics

#: B0's stages: (repeats, kernel, stride, expand, in, out)
STAGES = ((1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24), (2, 5, 2, 6, 24, 40),
          (3, 3, 2, 6, 40, 80), (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192),
          (1, 3, 1, 6, 192, 320))
STEM, HEAD, BN_EPS, DROP_CONNECT = 32, 1280, 1e-3, 0.2


def blocks() -> list[dict]:
    """One entry a physical block: kernel, stride, expand, in, out, SE width."""
    out = []
    for reps, k, s, e, cin, cout in STAGES:
        for r in range(reps):
            i = cin if r == 0 else cout
            out.append({"k": k, "s": s if r == 0 else 1, "e": e, "in": i, "out": cout,
                        "se": max(1, int(i * 0.25))})
    return out


def ran_blocks(tap: int | None) -> list[dict]:
    b = blocks()
    return b if tap is None else b[:tap + 2]


def has_head(tap: int | None) -> bool:
    return tap is None or tap >= len(blocks())


def feature_channels(tap: int | None) -> int:
    return HEAD if has_head(tap) else ran_blocks(tap)[-1]["out"]


def grid(size: int, tap: int | None) -> int:
    for s in [2] + [b["s"] for b in ran_blocks(tap)]:
        size = -(-size // s)
    return size


def _bn_spec(prefix: str, c: int) -> list:
    return [(f"{prefix}.weight", (c,), "ones"), (f"{prefix}.bias", (c,), "zeros"),
            (f"{prefix}.running_mean", (c,), "zeros"), (f"{prefix}.running_var", (c,), "ones")]


def param_spec(prefix: str, tap: int | None = None) -> list:
    """(key, shape, init) of every parameter and BatchNorm statistic."""
    spec = [(f"{prefix}._conv_stem.weight", (STEM, 3, 3, 3), "lecun")]
    spec += _bn_spec(f"{prefix}._bn0", STEM)
    for i, b in enumerate(ran_blocks(tap)):
        p, x = f"{prefix}._blocks.{i}", b["in"] * b["e"]
        if b["e"] != 1:
            spec += [(f"{p}._expand_conv.weight", (x, b["in"], 1, 1), "lecun")]
            spec += _bn_spec(f"{p}._bn0", x)
        spec += [(f"{p}._depthwise_conv.weight", (x, 1, b["k"], b["k"]), "lecun")]
        spec += _bn_spec(f"{p}._bn1", x)
        spec += [(f"{p}._se_reduce.weight", (b["se"], x, 1, 1), "lecun"),
                 (f"{p}._se_reduce.bias", (b["se"],), "zeros"),
                 (f"{p}._se_expand.weight", (x, b["se"], 1, 1), "lecun"),
                 (f"{p}._se_expand.bias", (x,), "zeros"),
                 (f"{p}._project_conv.weight", (b["out"], x, 1, 1), "lecun")]
        spec += _bn_spec(f"{p}._bn2", b["out"])
    if has_head(tap):
        last = ran_blocks(tap)[-1]["out"]
        spec += [(f"{prefix}._conv_head.weight", (HEAD, last, 1, 1), "lecun")]
        spec += _bn_spec(f"{prefix}._bn1", HEAD)
    return spec


def _same(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(num: Numerics, x, w, b=None, stride=1, groups=1):
    k = w.shape[-1]
    if k > 1 or stride > 1:
        t, bt = _same(x.shape[2], k, stride)
        lf, rt = _same(x.shape[3], k, stride)
        x = F.pad(x, (lf, rt, t, bt))
    return num.conv(x, w, b, stride, 0, groups)


def _bn(sd, p, x, train: bool, num: Numerics):
    w, b = sd[f"{p}.weight"], sd[f"{p}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = sd[f"{p}.running_mean"], sd[f"{p}.running_var"]
    shape = (1, -1, 1, 1)
    return num.q((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * w.view(shape)
                 + b.view(shape))


def drop_masks(n: int, generator: torch.Generator, tap: int | None = None) -> dict:
    """Train mode's per-sample keep masks of the residual blocks, drawn from a
    CPU ``generator`` in block order, one uniform a sample: ``{idx: (rate,
    bool mask)}``."""
    out, bl = {}, ran_blocks(tap)
    for idx, b in enumerate(bl):
        rate = DROP_CONNECT * idx / len(blocks())
        if b["s"] == 1 and b["in"] == b["out"] and rate > 0:
            out[idx] = (rate, torch.rand(n, generator=generator) < 1.0 - rate)
    return out


def block(sd, p, b, x, num: Numerics, train: bool, drop=None):
    inputs = x
    if b["e"] != 1:
        x = F.silu(_bn(sd, f"{p}._bn0", _conv(num, x, sd[f"{p}._expand_conv.weight"]), train,
                       num))
    x = F.silu(_bn(sd, f"{p}._bn1", _conv(num, x, sd[f"{p}._depthwise_conv.weight"],
                                          stride=b["s"], groups=x.shape[1]), train, num))
    s = x.mean(dim=(2, 3), keepdim=True)
    s = F.silu(_conv(num, s, sd[f"{p}._se_reduce.weight"], sd[f"{p}._se_reduce.bias"]))
    s = _conv(num, s, sd[f"{p}._se_expand.weight"], sd[f"{p}._se_expand.bias"])
    x = torch.sigmoid(s) * x
    x = _bn(sd, f"{p}._bn2", _conv(num, x, sd[f"{p}._project_conv.weight"]), train, num)
    if b["s"] == 1 and b["in"] == b["out"]:
        if drop is not None:
            rate, keep = drop
            x = x / (1.0 - rate) * keep.to(device=x.device, dtype=x.dtype)[:, None, None, None]
        x = num.q(x + inputs)
    return x


def forward(sd, prefix: str, images, num: Numerics, train: bool = False, drops=None,
            tap: int | None = None, checkpoint: bool = False):
    """``images (N, H, W, 3)`` float32 -> feature maps ``(N, h, w, C)``.
    ``drops`` (train mode): :func:`drop_masks`. ``checkpoint`` recomputes
    each block in the backward instead of keeping its insides."""
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.silu(_bn(sd, f"{prefix}._bn0", _conv(num, x, sd[f"{prefix}._conv_stem.weight"],
                                               stride=2), train, num))
    for idx, b in enumerate(ran_blocks(tap)):
        args = (sd, f"{prefix}._blocks.{idx}", b)
        d = (drops or {}).get(idx) if train else None
        if checkpoint and x.requires_grad:
            x = torch.utils.checkpoint.checkpoint(
                lambda t, a=args, dd=d: block(*a, t, num, train, dd), x, use_reentrant=False)
        else:
            x = block(*args, x, num, train, d)
    if has_head(tap):
        x = F.silu(_bn(sd, f"{prefix}._bn1", _conv(num, x, sd[f"{prefix}._conv_head.weight"]),
                       train, num))
    return x.permute(0, 2, 3, 1)
