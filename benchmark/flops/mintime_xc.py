"""Model FLOPs a video of MINTIME-XC (Xception per face, then the
Size-Invariant TimeSformer at 2048 input channels), by the rules of
``mintime_classifier``'s count: two FLOPs a multiply-add of every
convolution (depthwise, pointwise, the entry convolutions and the skips),
linear layer and attention product; norms, activations, max-pools and
softmax are not counted. Training adds both products of the backward
wherever gradients flow, and one for ``conv1``, whose input is the frames."""

from harness import files
from reference import xception as xc

_base = files.module("flops", "mintime_classifier")
model, head_macs = _base.model, _base.head_macs


def backbone_macs(size: int) -> tuple[int, int]:
    """(``conv1``, all other layers) multiply-adds of one image."""
    h = (size - 3) // 2 + 1
    stem = h * h * xc.STEM[0] * 3 * 9
    h -= 2
    rest = h * h * xc.STEM[1] * xc.STEM[0] * 9
    for b in xc.BLOCKS:
        for layer in xc.rep(b):
            if layer[0] == "sep":
                _, cin, cout = layer
                rest += h * h * cin * (9 + cout)
        out = h if b[3] == 1 else (h - 1) // 2 + 1
        if b[0] != b[1] or b[3] != 1:
            rest += out * out * b[0] * b[1]
        h = out
    for cin, cout in ((xc.BLOCKS[-1][1], xc.EXIT[0]), xc.EXIT):
        rest += h * h * cin * (9 + cout)
    return stem, rest


def forward(cfg: dict) -> float:
    m = model(cfg)
    stem, rest = backbone_macs(m["image_size"])
    emb, layers = head_macs(m, m["num_frames"], m["num_patches"], m["channels"])
    return 2.0 * (m["num_frames"] * (stem + rest) + emb + layers)


def train(cfg: dict) -> float:
    m = model(cfg)
    stem, rest = backbone_macs(m["image_size"])
    emb, layers = head_macs(m, m["num_frames"], m["num_patches"], m["channels"])
    return 2.0 * (m["num_frames"] * (2 * stem + 3 * rest) + 3 * (emb + layers))
