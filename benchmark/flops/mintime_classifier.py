"""Model FLOPs a video of MINTIME-EF (EfficientNet-B0 per face, then the
Size-Invariant TimeSformer), counted from the configuration's shapes: two
FLOPs a multiply-add of every convolution, linear layer and attention
product (query-key and probability-value, the CLS key and row included);
norms, activations and softmax are not counted. Training adds both products
of the backward wherever gradients flow (twice the forward), and one where
only the weights' gradient does (the stem convolution, whose input is the
frames)."""

from reference import efficientnet as eff


def model(cfg: dict) -> dict:
    return {k.replace("-", "_"): v for k, v in cfg["model"].items()}


def backbone_macs(size: int, tap=None) -> tuple[int, int]:
    """(stem, all other layers) multiply-adds of one image."""
    h = -(-size // 2)
    stem = h * h * eff.STEM * 3 * 9
    rest = 0
    for b in eff.ran_blocks(tap):
        x = b["in"] * b["e"]
        if b["e"] != 1:
            rest += h * h * x * b["in"]
        h = -(-h // b["s"])
        rest += h * h * x * b["k"] ** 2 + 2 * x * b["se"] + h * h * b["out"] * x
    if eff.has_head(tap):
        rest += h * h * eff.HEAD * eff.ran_blocks(tap)[-1]["out"]
    return stem, rest


def head_macs(m: dict, groups_space: int, per_frame: int, patch_dim: int) -> tuple[int, int]:
    """(patch embedding, layers and output) multiply-adds of one video's head:
    ``per_frame`` tokens in each of F frames."""
    F, dim, inner = m["num_frames"], m["dim"], m["heads"] * m["dim_head"]
    tokens = F * per_frame
    t = tokens + 1
    layer = 2 * (t * dim * 3 * inner + t * inner * dim) + t * (dim * 8 * dim + 4 * dim * dim)
    layer += 2 * inner * (tokens * (F + 1) + tokens * (per_frame + 1) + 2 * t)
    return tokens * patch_dim * dim, m["depth"] * layer + dim * m["num_classes"]


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
