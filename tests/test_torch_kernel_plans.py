"""The launch plans the wrappers hand the CUDA kernels, checked on the CPU:
the FFN backward's split-K planner (``ops/geglu_ffn.py::product_splits``)
and the depthwise forward's channel tile and row ring (``ops/dw_conv.py::
plan``). The kernels take these plans as they are, so what is checked here
is what runs on the card."""

import pytest

from mintime_torch.experiments.dw_conv_cuda_vs_cudnn import GEOMS
from mintime_torch.ops import dw_conv
from mintime_torch.ops import geglu_ffn as ffn

SMS = 132  # the H100's SMs

#: (M, D, H): the main paths' FFN shapes, ragged row counts, and tiny ones
FFN_CASES = [(6272, 512, 2048), (8, 512, 2048), (81920, 256, 1024), (8, 256, 1024),
             (1, 512, 2048), (100, 256, 1024), (6280, 512, 2048), (37, 512, 2048),
             (129, 64, 64), (5000, 128, 192)]


def _products(m, dim, hidden):
    """name -> (output rows, output columns, reduction depth)."""
    return {"dw0": (2 * hidden, dim, m), "dw1": (dim, hidden, m), "dx": (m, dim, 2 * hidden)}


@pytest.mark.parametrize("m,dim,hidden", FFN_CASES)
@pytest.mark.parametrize("sms", [SMS, 4])
def test_split_k_slices_cover_the_reduction_in_order(m, dim, hidden, sms):
    splits = ffn.product_splits(m, dim, hidden, sms)
    for name, (rows, cols, k) in _products(m, dim, hidden).items():
        s, chunk = splits[name]
        bounds = [(i * chunk, min(k, (i + 1) * chunk)) for i in range(s)]
        assert bounds[0][0] == 0 and bounds[-1][1] == k, (name, bounds)
        assert all(a < b for a, b in bounds), f"{name}: an empty slice {bounds}"
        assert all(bounds[i][1] == bounds[i + 1][0] for i in range(s - 1)), (name, bounds)
        if s > 1:
            assert chunk % 32 == 0, f"{name}: slices must be whole 32-deep stages, got {chunk}"
        tiles = -(-rows // 128) * -(-cols // 128)
        if tiles >= sms:
            assert s == 1, f"{name}: {tiles} tiles fill {sms} SMs, yet S = {s}"
        assert tiles * s <= max(tiles, 2 * sms), f"{name}: {tiles} tiles x {s} slices pass one wave"


@pytest.mark.parametrize("m,dim,hidden", FFN_CASES)
def test_split_k_scratch_is_slices_times_the_output(m, dim, hidden):
    splits = ffn.product_splits(m, dim, hidden, SMS)
    scratch = ffn.split_scratch(m, dim, hidden, splits)
    for name, (rows, cols, _) in _products(m, dim, hidden).items():
        s = splits[name][0]
        assert scratch[name] == (s * rows * cols if s > 1 else 0)


def test_split_k_at_the_main_path_shapes():
    """The conv model's weight gradients split (too few tiles for 132 SMs)
    into one wave of 256 blocks; its dx does not split; at the CLS rows dx
    splits its 2H-deep reduction."""
    assert ffn.product_splits(81920, 256, 1024, SMS) == {
        "dw0": (8, 10240), "dw1": (16, 5120), "dx": (1, 2048)}
    assert ffn.product_splits(6272, 512, 2048, SMS) == {
        "dw0": (2, 3136), "dw1": (4, 1568), "dx": (1, 4096)}
    assert ffn.product_splits(8, 512, 2048, SMS) == {"dw0": (1, 8), "dw1": (1, 8), "dx": (64, 64)}
    # 2 MB of dW0 partials a slice at D = 256, 8 MB at D = 512
    assert ffn.split_scratch(81920, 256, 1024, ffn.product_splits(81920, 256, 1024, SMS))["dw0"] \
        == 8 * 2048 * 256
    assert ffn.split_scratch(6272, 512, 2048, ffn.product_splits(6272, 512, 2048, SMS))["dw0"] \
        == 2 * 4096 * 512


COLS = 7  # output columns a depthwise forward thread owns

#: (H, W, C, K) -> (ct, threads) at the depthwise probe's geometries:
#: channel tiles that divide C and fill whole warps
GEOM_PLANS = {(112, 112, 32, 3): (32, 256), (56, 56, 144, 3): (72, 288),
              (28, 28, 240, 5): (80, 160), (14, 14, 480, 3): (96, 96),
              (14, 14, 480, 5): (96, 96), (14, 14, 672, 5): (96, 96),
              (7, 7, 1152, 5): (128, 64), (7, 7, 1152, 3): (128, 64)}


def test_dw_plan_covers_every_probe_geometry():
    assert sorted(GEOM_PLANS) == sorted((H, W, C, K) for H, W, C, K, _ in GEOMS)


@pytest.mark.parametrize("geom,want", sorted(GEOM_PLANS.items()))
def test_dw_plan_at_the_probe_geometries(geom, want):
    H, W, C, K = geom
    ct, threads = dw_conv.plan(H, W, C, K)
    assert (ct, threads) == want
    assert C % ct == 0 and ct % 8 == 0 and W % COLS == 0
    assert threads == W // COLS * ct // 2  # one item a thread, whole warps


@pytest.mark.parametrize("H,W,C,K", [(9, 7, 17, 3), (5, 9, 13, 5), (6, 6, 3, 3), (1, 1, 1, 5),
                                     (4, 300, 1000, 5), (12, 14, 200, 3), (3, 600, 1152, 5),
                                     (8, 10, 130, 3)])
def test_dw_plan_invariants(H, W, C, K):
    ct, threads = dw_conv.plan(H, W, C, K)
    assert ct % 2 == 0 and 2 <= ct <= 128
    if C % 8 == 0:
        assert ct % 8 == 0  # 16-byte staging
    else:
        assert ct >= min(C, 128)  # one masked tile where C allows
    groups = -(-W // COLS)  # the last group masked where 7 does not divide W
    assert threads % 32 == 0 and 32 <= threads <= 512
    assert threads >= min(512, groups * ct // 2)
    ring = (K + 1) * (groups * COLS + K - 1) * ct * 2
    assert ring <= 200 * 1024, ring
