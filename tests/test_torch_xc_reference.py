"""MINTIME-XC against the benchmark's plain float32 reference
(``benchmark/reference/xception.py``, then ``reference/timesformer.py``'s
head through ``benchmark/families/mintime_xc.py``'s ``logits``) on seeded
random weights on the CPU: the port's ``Xception`` alone, and the whole
classifier with its attention maps. The reference imports nothing of the
port or of JAX."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:  # after the test paths: ``tests`` stays this directory
    sys.path.append(BENCH)

from harness import files, weights  # noqa: E402
from reference import xception as xc  # noqa: E402
from reference.numerics import Numerics  # noqa: E402

from mintime_torch.config import ModelConfig  # noqa: E402
from mintime_torch.models.classifier import MintimeVideoClassifier  # noqa: E402
from mintime_torch.models.xception import Xception  # noqa: E402

FAM = files.module("families", "mintime_xc")
CLS = {"image_size": 64, "num_frames": 8, "num_patches": 4, "channels": 2048, "dim": 64,
       "depth": 2, "heads": 2, "dim_head": 32, "num_classes": 1, "max_identities": 2}


def _xception(size):
    sd = weights.make(xc.param_spec("extractor"), 5, "cpu")
    prog = Xception()
    prog.load_state_dict({k[len("extractor."):]: v for k, v in sd.items()})
    x = torch.rand(3, size, size, 3, generator=torch.Generator().manual_seed(size)) * 255
    with torch.no_grad():
        want = prog.eval()(x)
        got = xc.forward(sd, "extractor", x, Numerics())
    assert got.shape == want.shape == (3, xc.grid(size), xc.grid(size), xc.FEATURES)
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def _batch(B=3):
    F, n = CLS["num_frames"], CLS["num_patches"]
    g = np.random.default_rng(1)
    mask = np.ones((B, F), bool)
    mask[0, 5:] = False
    idm = np.zeros((B, F, F), bool)
    idm[:, :4, :4] = idm[:, 4:, 4:] = True
    pos = np.concatenate([np.zeros((B, 1), int), 1 + np.tile(np.arange(F * n), (B, 1))], 1)
    frames = g.integers(0, 256, (B, F, CLS["image_size"], CLS["image_size"], 3), dtype=np.uint8)
    return {"frames": torch.from_numpy(frames), "mask": torch.from_numpy(mask),
            "identities_mask": torch.from_numpy(idm),
            "size_embedding": torch.from_numpy(g.integers(1, 21, (B, F))),
            "positions": torch.from_numpy(pos)}


def _classifier():
    cfg = {"model": {k.replace("_", "-"): v for k, v in CLS.items()}}
    sd = FAM.calibrated(weights.make(FAM.spec(cfg), 9, "cpu"))
    prog = MintimeVideoClassifier(ModelConfig(**CLS), backbone="xception", head="timesformer",
                                  require_attention=True, use_kernels=True, device="cpu")
    prog.load_state_dict(sd)
    batch = _batch()
    with torch.no_grad():
        want, want_maps = prog(*(batch[k] for k in ("frames", "mask", "identities_mask",
                                                    "size_embedding", "positions")))
        got, got_maps = FAM.logits(sd, batch, cfg, Numerics(), want_maps=True)
    assert torch.allclose(got, want, rtol=0, atol=1e-4)
    for a, b in zip(got_maps, want_maps):  # program: (B * H, 1, N)
        assert torch.allclose(a.reshape(b.shape), b, rtol=0, atol=3e-6)


@pytest.mark.parametrize("case", ["xception_64", "xception_96", "classifier_64"])
def test_port_against_the_plain_reference(case):
    if case == "classifier_64":
        _classifier()
    else:
        _xception(int(case.rsplit("_", 1)[1]))


def test_reference_xception_imports_no_jax_nor_either_package():
    tree = ast.parse(open(os.path.join(BENCH, "reference", "xception.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names.isdisjoint({"jax", "jaxlib", "flax", "mintime_tpu", "mintime_torch"}), names
