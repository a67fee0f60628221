"""The plain reference against the port's plain (CPU, float32) path at tiny
sizes, piece by piece. The test imports both; the reference imports nothing
of the port (checked here too)."""

import numpy as np
import pytest
import torch

from harness import core, weights
from reference import assembly, efficientnet as eff, timesformer as tsf
from reference.numerics import Numerics

F32 = Numerics("fp32")


def _sd(spec, seed=0):
    return weights.make(spec, seed, "cpu")


def test_reference_imports_nothing_of_the_program():
    assert core.reference_imports() == []


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("tap", [None, 3])
def test_efficientnet(train, tap):
    from mintime_torch.models.efficientnet import EfficientNet

    sd = _sd(eff.param_spec("m", tap))
    prog = EfficientNet("efficientnet-b0", tap_block=tap)
    prog.load_state_dict({k[2:]: v for k, v in sd.items()})
    prog.train(train)
    x = torch.rand(4, 64, 64, 3) * 255
    with torch.no_grad():
        want = prog(x, generator=torch.Generator().manual_seed(7))
        drops = eff.drop_masks(4, torch.Generator().manual_seed(7), tap) if train else None
        got = eff.forward(sd, "m", x, F32, train, drops, tap)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def _head_inputs(m, B, seed=0):
    g = np.random.default_rng(seed)
    F, n = m["num_frames"], m["num_patches"]
    mask = np.ones((B, F), bool)
    mask[0, 5:] = False
    idm = np.zeros((B, F, F), bool)
    idm[:, :4, :4] = idm[:, 4:, 4:] = True
    pos = np.concatenate([np.zeros((B, 1), int), 1 + np.tile(np.arange(F * n), (B, 1))], 1)
    return (torch.randn(B, F, 2, 2, m["channels"]), torch.from_numpy(mask),
            torch.from_numpy(idm), torch.from_numpy(g.integers(1, 21, (B, F))),
            torch.from_numpy(pos))


def test_size_invariant_timesformer_and_maps():
    from mintime_torch.config import ModelConfig
    from mintime_torch.models.timesformer import SizeInvariantTimeSformer

    m = {"num_frames": 8, "num_patches": 4, "dim": 64, "depth": 2, "heads": 2, "dim_head": 32,
         "channels": 24, "num_classes": 1}
    sd = _sd(tsf.param_spec("h", m, 24, 32))
    cfg = ModelConfig(num_frames=8, num_patches=4, dim=64, depth=2, heads=2, dim_head=32,
                      channels=24)
    prog = SizeInvariantTimeSformer(cfg, require_attention=True, use_kernels=True)
    prog.load_state_dict({k[2:]: v for k, v in sd.items()})
    args = _head_inputs(m, 3)
    with torch.no_grad():
        want, want_maps = prog(*args)
        got, got_maps = tsf.size_invariant(sd, "h", *args, m, F32, want_maps=True)
    assert torch.allclose(got, want, atol=1e-5)
    for a, b in zip(got_maps, want_maps):  # program: (B*H, 1, N)
        assert torch.allclose(a.reshape(b.shape), b, atol=1e-6)


def test_conv_head():
    from mintime_torch.config import ModelConfig
    from mintime_torch.models.conv_timesformer import ConvTimeSformerHead

    m = {"num_frames": 8, "dim": 64, "depth": 1, "heads": 2, "dim_head": 32, "num_classes": 1}
    sd = _sd(tsf.param_spec("h", m, 4, 8 * 24))
    cfg = ModelConfig(num_frames=8, num_patches=24, dim=64, depth=1, heads=2, dim_head=32,
                      channels=24)
    prog = ConvTimeSformerHead(cfg, 4, 24, use_kernels=True)
    prog.load_state_dict({k[2:]: v for k, v in sd.items()})
    feats, size = torch.randn(2, 8, 2, 2, 24), torch.randint(1, 21, (2, 8))
    with torch.no_grad():
        assert torch.allclose(tsf.conv_head(sd, "h", feats, size, m, F32), prog(feats, size),
                              atol=1e-5)


def _identities(rng, counts, sides):
    return {k: [(30 * s, k, rng.integers(0, 256, (side, side, 3), dtype=np.uint8), [0, 0, 1, 1])
                for s in range(n)] for k, (n, side) in enumerate(zip(counts, sides))}


@pytest.mark.parametrize("counts", [(3,), (2, 9), (9, 3), (7, 7, 2), (12, 1, 5)])
def test_plan_against_the_port(counts):
    from mintime_torch.data.assembler import IdentityFaces, build_sequence_plan

    rng = np.random.default_rng(sum(counts))
    ids = _identities(rng, counts, [40 + 7 * i for i in range(len(counts))][::-1])
    p = assembly.plan(ids, 16, 4, 2)
    infos = [IdentityFaces(str(k), [t[0] for t in v], float(np.mean([t[2].shape[1] for t in v])))
             for k, v in ids.items()]
    want = build_sequence_plan(infos, 16, 4, 2, ordering=0, parity=1)
    assert (p["mask"] == want.mask).all()
    assert (p["identities_mask"] == want.identities_mask).all()
    assert (p["positions"] == want.positions).all()
    assert p["cum_frames"] == [t // 4 for _, t in want.tokens_per_identity]


@pytest.mark.parametrize("side", [17, 40, 64, 90, 200])
def test_transform_against_the_port(side):
    from mintime_torch.data.augment import create_val_transform

    crop = np.random.default_rng(side).integers(0, 256, (side, side, 3), dtype=np.uint8)
    want = create_val_transform(64)([crop], "cpu")[0].int()
    got = assembly.transform(crop, 64, "cpu").int()
    # float32 arithmetic against cv2's own rounding: a level at most
    assert (got - want).abs().max() <= 1


def test_bucket_and_aggregate_against_the_port():
    from mintime_torch.data.assembler import size_bucket
    from mintime_torch.utils.attention_viz import aggregate_attentions

    for h in (20, 64, 150, 320, 900):
        assert assembly.bucket(h, h, 1080, 1920) == size_bucket(h, h, 1080, 1920, True)
    maps = [np.random.default_rng(i).random((2, 1, 1 + 8 * 4)).astype(np.float32) / 33
            for i in range(2)]
    _, want = aggregate_attentions(maps, 2, 8, [5, 8])
    got, frames = assembly.aggregate([m[:, 0] for m in maps], 8, [5, 8])
    assert np.allclose(got, want)
    assert np.allclose(frames, aggregate_attentions(maps, 2, 8, [5, 8])[0][2])
