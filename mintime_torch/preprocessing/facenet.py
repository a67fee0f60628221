"""InceptionResnetV1 face embedder (counterpart of
``mintime_tpu/preprocessing/facenet.py``), in facenet-pytorch's module tree.

The keys are facenet-pytorch's (``conv2d_1a.conv``, ``.bn``,
``repeat_1.<i>.branch1.0.conv``, ..., ``last_linear``, ``last_bn``), so its
VGGFace2 ``state_dict`` loads with :func:`load_facenet_state_dict` and the
same dict feeds the JAX package through ``facenet_params_from_torch``. Output:
L2-normalised 512-d embeddings (``classify=False``). Runs in eval mode only.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn


class ConvBn(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU: facenet-pytorch's
    ``BasicConv2d``."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Block35(nn.Module):
    """Inception-ResNet-A, residual scale 0.17."""

    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = ConvBn(256, 32, 1)
        self.branch1 = nn.Sequential(ConvBn(256, 32, 1), ConvBn(32, 32, 3, padding=1))
        self.branch2 = nn.Sequential(ConvBn(256, 32, 1), ConvBn(32, 32, 3, padding=1),
                                     ConvBn(32, 32, 3, padding=1))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x):
        mixed = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)
        return F.relu(x + self.conv2d(mixed) * self.scale)


class Block17(nn.Module):
    """Inception-ResNet-B, residual scale 0.10."""

    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = ConvBn(896, 128, 1)
        self.branch1 = nn.Sequential(ConvBn(896, 128, 1), ConvBn(128, 128, (1, 7), padding=(0, 3)),
                                     ConvBn(128, 128, (7, 1), padding=(3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        mixed = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return F.relu(x + self.conv2d(mixed) * self.scale)


class Block8(nn.Module):
    """Inception-ResNet-C, residual scale 0.20; the final block has scale 1
    and no ReLU."""

    def __init__(self, scale: float = 0.20, relu: bool = True):
        super().__init__()
        self.scale = scale
        self.relu = relu
        self.branch0 = ConvBn(1792, 192, 1)
        self.branch1 = nn.Sequential(ConvBn(1792, 192, 1), ConvBn(192, 192, (1, 3), padding=(0, 1)),
                                     ConvBn(192, 192, (3, 1), padding=(1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        mixed = torch.cat([self.branch0(x), self.branch1(x)], 1)
        out = x + self.conv2d(mixed) * self.scale
        return F.relu(out) if self.relu else out


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = ConvBn(256, 384, 3, stride=2)
        self.branch1 = nn.Sequential(ConvBn(256, 192, 1), ConvBn(192, 192, 3, padding=1),
                                     ConvBn(192, 256, 3, stride=2))
        self.branch2 = nn.MaxPool2d(3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(ConvBn(896, 256, 1), ConvBn(256, 384, 3, stride=2))
        self.branch1 = nn.Sequential(ConvBn(896, 256, 1), ConvBn(256, 256, 3, stride=2))
        self.branch2 = nn.Sequential(ConvBn(896, 256, 1), ConvBn(256, 256, 3, padding=1),
                                     ConvBn(256, 256, 3, stride=2))
        self.branch3 = nn.MaxPool2d(3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class InceptionResnetV1(nn.Module):
    """512-d face embedding net; input ``(N, 3, H, W)`` standardised
    (:func:`fixed_image_standardization`), H and W at least 75."""

    def __init__(self):
        super().__init__()
        self.conv2d_1a = ConvBn(3, 32, 3, stride=2)
        self.conv2d_2a = ConvBn(32, 32, 3)
        self.conv2d_2b = ConvBn(32, 64, 3, padding=1)
        self.maxpool_3a = nn.MaxPool2d(3, stride=2)
        self.conv2d_3b = ConvBn(64, 80, 1)
        self.conv2d_4a = ConvBn(80, 192, 3)
        self.conv2d_4b = ConvBn(192, 256, 3, stride=2)
        self.repeat_1 = nn.Sequential(*[Block35() for _ in range(5)])
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*[Block17() for _ in range(10)])
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*[Block8() for _ in range(5)])
        self.block8 = Block8(scale=1.0, relu=False)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = nn.BatchNorm1d(512, eps=1e-3)

    def forward(self, x):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(self.maxpool_3a(x))))
        x = self.repeat_3(self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(x)))))
        x = self.block8(x).mean(dim=(2, 3))  # adaptive average pool to 1 x 1
        x = self.last_bn(self.last_linear(x))
        return F.normalize(x, p=2, dim=1, eps=1e-12)


def fixed_image_standardization(x: torch.Tensor) -> torch.Tensor:
    """(x - 127.5) / 128, facenet-pytorch's input normalisation."""
    return (x.float() - 127.5) / 128.0


#: keys of a facenet-pytorch checkpoint that the embedder does not hold: the
#: classification head (``classify=True``)
DROPPED_PREFIXES = ("logits.",)


def load_facenet_state_dict(model: InceptionResnetV1, state_dict: Mapping[str, torch.Tensor]):
    """Load a facenet-pytorch ``state_dict`` (``module.`` prefixes stripped,
    the ``logits.*`` head dropped by name, every other key strict)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith(DROPPED_PREFIXES)}
    model.load_state_dict(sd, strict=True)
    return model
