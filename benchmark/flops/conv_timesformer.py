"""Model FLOPs a video of the Convolutional TimeSformer (EfficientNet-B0
tapped at ``efficient-net-block`` and frozen, then a divided-attention head
over the ``F * C`` channel maps), counted as ``mintime_classifier``'s: the
frozen extractor's forward only; in training the head's layers twice more,
and its patch embedding (whose input, the frozen features, needs no
gradient) once more."""

from harness import files
from reference import efficientnet as eff

_base = files.module("flops", "mintime_classifier")
backbone_macs, head_macs, model = _base.backbone_macs, _base.head_macs, _base.model


def _parts(cfg: dict):
    m = model(cfg)
    tap = m["efficient_net_block"]
    stem, rest = backbone_macs(m["image_size"], tap)
    g = eff.grid(m["image_size"], tap)
    emb, layers = head_macs(m, m["num_frames"], eff.feature_channels(tap), g * g)
    return m["num_frames"] * (stem + rest), emb, layers


def forward(cfg: dict) -> float:
    ext, emb, layers = _parts(cfg)
    return 2.0 * (ext + emb + layers)


def train(cfg: dict) -> float:
    ext, emb, layers = _parts(cfg)
    return 2.0 * (ext + 2 * emb + 3 * layers)
