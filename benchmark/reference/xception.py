"""Xception (Chollet, arXiv:1610.02357) as plain float32 PyTorch over a state
dict: the feature maps ``(N, H, W, 3) -> (N, h, w, 2048)`` that MINTIME-XC's
head takes, the **pre-ReLU** output of ``bn4`` (7 x 7 for a 224 input).

The structure is the one the MINTIME repository's ``models/xception.py``
(the SenseTime / Cadene Xception) builds:

* entry: ``conv1`` 3 x 3 / 2 to 32 channels and ``conv2`` 3 x 3 to 64, both
  VALID and bias-free, each followed by BatchNorm and ReLU;
* twelve blocks: ``rep``, a sequence ``[ReLU] sep BN (ReLU sep BN)*`` that
  ends, in a strided block, in a 3 x 3 / 2 max-pool padded by 1 with -inf;
  ``skip``, a 1 x 1 convolution at the block's stride and its BatchNorm
  ``skipbn`` where the block changes width or size, else the identity; the
  block's output is their sum;
* exit: ``conv3`` 1024 -> 1536, ``bn3``, ReLU, ``conv4`` 1536 -> 2048, ``bn4``.

A separable convolution (``conv1``, then ``pointwise``) is a depthwise
3 x 3 padded by 1, then a pointwise 1 x 1, both bias-free. BatchNorm is in
inference mode with its running statistics and eps 1e-5. Keys are the
reference repository's (``conv1``, ``bn1``, ``block{i}.rep.{j}``, ``.skip``,
``.skipbn``, ``conv3.conv1``, ``conv3.pointwise``, ...), ``j`` the position
in ``rep``.

Departures from the reference repository's module:

* inference mode only: no batch statistics (the benchmark only scores with
  this backbone);
* its ReLUs run in place on every ``rep`` but the first of each block; here
  each ReLU makes a new tensor, which gives the same values;
* no classifier (``fc``) and no final ReLU: MINTIME-XC reads the map before
  them;
* the input is NHWC (channels last) and is not normalised here, as the
  classifier under test takes its frames.

On the card the float32 products must be full float32: fp32 numerics
raise while TF32 is allowed (``numerics.tf32_off``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.numerics import Numerics

#: the blocks: (in, out, separable convolutions, stride, ReLU first, grow first)
BLOCKS = ((64, 128, 2, 2, False, True), (128, 256, 2, 2, True, True),
          (256, 728, 2, 2, True, True), *[(728, 728, 3, 1, True, True)] * 8,
          (728, 1024, 2, 2, True, False))
STEM = (32, 64)
EXIT = (1536, 2048)
FEATURES = 2048
BN_EPS = 1e-5


def rep(b: tuple) -> list[tuple]:
    """A block's ``rep`` in order: ``("relu",)``, ``("sep", in, out)``,
    ``("bn", channels)`` and ``("pool",)``; an entry's index is its key."""
    cin, cout, n, stride, relu_first, grow_first = b
    chans = ([(cin, cout)] + [(cout, cout)] * (n - 1) if grow_first
             else [(cin, cin)] * (n - 1) + [(cin, cout)])
    out = []
    for a, c in chans:
        out += [("relu",), ("sep", a, c), ("bn", c)]
    if not relu_first:
        out = out[1:]
    return out + [("pool",)] * (stride != 1)


def grid(size: int) -> int:
    """The side of the feature map for a ``size`` x ``size`` input."""
    size = (size - 3) // 2 + 1 - 2  # conv1 (stride 2), conv2, both VALID
    for b in BLOCKS:
        if b[3] != 1:
            size = (size - 1) // 2 + 1  # the max-pool: 3 x 3 / 2 padded by 1
    return size


def _bn_spec(p: str, c: int) -> list:
    return [(f"{p}.weight", (c,), "ones"), (f"{p}.bias", (c,), "zeros"),
            (f"{p}.running_mean", (c,), "zeros"), (f"{p}.running_var", (c,), "ones")]


def _sep_spec(p: str, cin: int, cout: int) -> list:
    return [(f"{p}.conv1.weight", (cin, 1, 3, 3), "lecun"),
            (f"{p}.pointwise.weight", (cout, cin, 1, 1), "lecun")]


def param_spec(prefix: str) -> list:
    """(key, shape, init) of every parameter and BatchNorm statistic."""
    spec = [(f"{prefix}.conv1.weight", (STEM[0], 3, 3, 3), "lecun")]
    spec += _bn_spec(f"{prefix}.bn1", STEM[0])
    spec += [(f"{prefix}.conv2.weight", (STEM[1], STEM[0], 3, 3), "lecun")]
    spec += _bn_spec(f"{prefix}.bn2", STEM[1])
    for i, b in enumerate(BLOCKS):
        p = f"{prefix}.block{i + 1}"
        for j, layer in enumerate(rep(b)):
            if layer[0] == "sep":
                spec += _sep_spec(f"{p}.rep.{j}", *layer[1:])
            elif layer[0] == "bn":
                spec += _bn_spec(f"{p}.rep.{j}", layer[1])
        if b[0] != b[1] or b[3] != 1:
            spec += [(f"{p}.skip.weight", (b[1], b[0], 1, 1), "lecun")]
            spec += _bn_spec(f"{p}.skipbn", b[1])
    spec += _sep_spec(f"{prefix}.conv3", BLOCKS[-1][1], EXIT[0]) + _bn_spec(f"{prefix}.bn3", EXIT[0])
    spec += _sep_spec(f"{prefix}.conv4", *EXIT) + _bn_spec(f"{prefix}.bn4", EXIT[1])
    return spec


def _bn(sd, p, x, num: Numerics):
    shape = (1, -1, 1, 1)
    mean, var = sd[f"{p}.running_mean"].view(shape), sd[f"{p}.running_var"].view(shape)
    return num.q((x - mean) * torch.rsqrt(var + BN_EPS) * sd[f"{p}.weight"].view(shape)
                 + sd[f"{p}.bias"].view(shape))


def _sep(sd, p, x, num: Numerics):
    x = num.conv(x, sd[f"{p}.conv1.weight"], padding=1, groups=x.shape[1])
    return num.conv(x, sd[f"{p}.pointwise.weight"])


def block(sd, p: str, b: tuple, x, num: Numerics):
    inputs = x
    for j, layer in enumerate(rep(b)):
        if layer[0] == "relu":
            x = F.relu(x)
        elif layer[0] == "sep":
            x = _sep(sd, f"{p}.rep.{j}", x, num)
        elif layer[0] == "bn":
            x = _bn(sd, f"{p}.rep.{j}", x, num)
        else:
            x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, 2)
    if b[0] != b[1] or b[3] != 1:
        inputs = _bn(sd, f"{p}.skipbn", num.conv(inputs, sd[f"{p}.skip.weight"], stride=b[3]),
                     num)
    return num.q(x + inputs)


def forward(sd, prefix: str, images, num: Numerics):
    """``images (N, H, W, 3)`` float32 -> the pre-ReLU maps ``(N, h, w, 2048)``."""
    if (num.kind == "fp32" and images.is_cuda
            and (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)):
        raise RuntimeError("TF32 is allowed: the reference computes in float32 "
                           "(numerics.tf32_off)")
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.relu(_bn(sd, f"{prefix}.bn1", num.conv(x, sd[f"{prefix}.conv1.weight"], stride=2), num))
    x = F.relu(_bn(sd, f"{prefix}.bn2", num.conv(x, sd[f"{prefix}.conv2.weight"]), num))
    for i, b in enumerate(BLOCKS):
        x = block(sd, f"{prefix}.block{i + 1}", b, x, num)
    x = F.relu(_bn(sd, f"{prefix}.bn3", _sep(sd, f"{prefix}.conv3", x, num), num))
    x = _bn(sd, f"{prefix}.bn4", _sep(sd, f"{prefix}.conv4", x, num), num)
    return x.permute(0, 2, 3, 1)
