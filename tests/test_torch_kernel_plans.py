"""The launch plans the wrappers hand the CUDA kernels, checked on the CPU:
the FFN forward's tiles and k slices (``ops/geglu_ffn.py::fwd_plan``), the
FFN backward's split-K planner (``ops/geglu_ffn.py::product_splits``),
the depthwise forward's channel tile and row ring (``ops/dw_conv.py::
plan``), the attention backward's group packs, row chunks and CLS-row
chunks (``ops/divided_attention.py::bwd_plan``) and the token-row kernels'
tiles of whole groups, blocks and scratch (``ops/token_rows.py::plan``).
The kernels take these plans as they are, so what is checked here is what
runs on the card."""

import numpy as np
import pytest
import torch

from mintime_torch.experiments.dw_conv_cuda_vs_cudnn import GEOMS
from mintime_torch.ops import divided_attention as da
from mintime_torch.ops import dw_conv
from mintime_torch.ops import geglu_ffn as ffn
from mintime_torch.ops import token_rows as tr

SMS = 132  # the H100's SMs

#: (M, D, H): the main paths' FFN shapes, ragged row counts, and tiny ones
FFN_CASES = [(6272, 512, 2048), (8, 512, 2048), (81920, 256, 1024), (8, 256, 1024),
             (1, 512, 2048), (100, 256, 1024), (6280, 512, 2048), (37, 512, 2048),
             (129, 64, 64), (5000, 128, 192)]


#: (M, D, H) of the forward's plan cases: one row, the CLS rows of a batch
#: of 8, a row short of a tile, the flagship's token rows, the conv model's
FWD_CASES = [(m, dim, hidden) for m in (1, 8, 127, 6272, 81920)
             for dim, hidden in ((512, 2048), (256, 1024))]


def _cover(starts, length, total):
    """How many of the spans [s, min(total, s + length)) hold each index."""
    hits = np.zeros(total, dtype=int)
    for s in starts:
        hits[s:min(total, s + length)] += 1
    return hits


@pytest.mark.parametrize("m,dim,hidden", FWD_CASES)
def test_fwd_plan_covers_every_row_column_and_k_once(m, dim, hidden):
    """Launch A's blocks hold every (row, hidden column) once, val and gate
    together; launch B's every (row, output column) once a slice, and its
    slices every k once, in whole 64-deep stages."""
    plan = ffn.fwd_plan(m, dim, hidden, SMS)
    rows, up, down = plan["rows"], plan["up"], plan["down"]
    row_tiles = range(0, -(-m // rows) * rows, rows)
    assert (_cover(row_tiles, rows, m) == 1).all()
    assert hidden % up == 0 and (_cover(range(0, hidden, up), up, hidden) == 1).all()
    assert plan["up_blocks"] == len(row_tiles) * (hidden // up)
    assert dim % down == 0 and (_cover(range(0, dim, down), down, dim) == 1).all()
    s, chunk = plan["slices"], plan["k_chunk"]
    assert chunk % 64 == 0 and (s - 1) * chunk < hidden <= s * chunk
    assert (_cover(range(0, s * chunk, chunk), chunk, hidden) == 1).all()
    assert plan["down_blocks"] == len(row_tiles) * (dim // down) * s
    assert plan["launches"] == (2 if s == 1 else 3)


@pytest.mark.parametrize("m,dim,hidden", FWD_CASES)
def test_fwd_plan_scratch_is_what_the_wrapper_allocates(m, dim, hidden):
    plan = ffn.fwd_plan(m, dim, hidden, SMS)
    x2 = torch.empty((m, dim), dtype=torch.bfloat16, device="meta")
    prod, partial = ffn.fwd_scratch(x2, hidden, plan)
    assert prod.shape == (m, hidden) and prod.dtype == torch.bfloat16
    assert prod.numel() == plan["prod"]
    assert (0 if partial is None else partial.numel()) == plan["partial"]
    assert partial is None or (partial.dtype == torch.float32
                               and partial.shape == (plan["slices"], m, dim))


@pytest.mark.parametrize("m,dim,hidden", [c for c in FWD_CASES if c[0] < 128])
def test_fwd_plan_gives_every_sm_a_block_at_few_rows(m, dim, hidden):
    """Under one row tile (the CLS rows) the weights' bytes bound the call:
    both launches spread them over at least a block an SM."""
    plan = ffn.fwd_plan(m, dim, hidden, SMS)
    assert plan["up_blocks"] >= SMS and plan["down_blocks"] >= SMS


def test_fwd_plan_at_the_main_path_shapes():
    """The token rows take the wide tiles in two launches; the CLS rows of
    8 videos narrow tiles and split slices."""
    assert {k: ffn.fwd_plan(6272, 512, 2048, SMS)[k] for k in ("up", "down", "slices")} == {
        "up": 64, "down": 128, "slices": 1}
    assert {k: ffn.fwd_plan(81920, 256, 1024, SMS)[k] for k in ("up", "down", "slices")} == {
        "up": 64, "down": 128, "slices": 1}
    assert {k: ffn.fwd_plan(8, 512, 2048, SMS)[k] for k in ("up", "down", "slices")} == {
        "up": 8, "down": 16, "slices": 6}
    assert {k: ffn.fwd_plan(8, 256, 1024, SMS)[k] for k in ("up", "down", "slices")} == {
        "up": 4, "down": 16, "slices": 16}


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


#: (B, G, L) of the attention backward on the main paths: the flagship's
#: time and space axes, the conv model's at tap block 10 (both whole-slice)
#: and its time axis at tap block 20 (1280 channel groups of 8 frames)
ATTN_SHAPES = [(8, 49, 16), (8, 16, 49), (8, 192, 8), (8, 8, 192), (8, 1280, 8)]
#: the groups the whole-slice shapes attend within (the tap-20 time axis
#: takes the token-row kernels, so its G = 1280 is checked at L = 8 only);
#: the L sweep runs at B = 2, so that group packs span two videos
ATTN_GROUPS = (8, 16, 49, 192)


def _tile(plan, B, G, L, block, warp):
    """The rows (row launch) or keys (column launch) that warp ``warp`` of
    block ``block`` of a token-row launch takes under ``plan``, found as the
    kernel's ``block_tile`` finds them: ``(n, first, count)``, group n = b *
    G + g and its positions first .. first + count - 1, or None for a warp
    without rows."""
    gpb, chunks = plan["groups_per_block"], plan["row_chunks"]
    wpg = plan["threads"] // 32 // gpb
    n0, chunk = block // chunks * gpb, block % chunks
    j, first = warp // wpg, chunk * 64 + warp % wpg * 16
    end = min(L, (chunk + 1) * 64)
    if j >= min(gpb, B * G - n0) or first >= end:
        return None
    return n0 + j, first, min(16, end - first)


def _tile_coverage(B, G, L):
    """How many warps' tiles hold each (group, row) under the plan, after
    checking that each tile lies in one 64-row chunk and its block's group
    pack; and the (block, warp) pairs left without rows."""
    plan = da.bwd_plan(B, G, L)
    gpb, chunks, threads = plan["groups_per_block"], plan["row_chunks"], plan["threads"]
    assert threads % 32 == 0 and 32 <= threads <= 128 and (threads // 32) % gpb == 0
    assert chunks == -(-L // 64) and (chunks == 1 or gpb == 1)
    seen, idle = np.zeros((B * G, L), np.int64), []
    for block in range(plan["blocks"]):
        for warp in range(threads // 32):
            tile = _tile(plan, B, G, L, block, warp)
            if tile is None:
                idle.append((block, warp))
                continue
            n, first, count = tile
            assert block // chunks * gpb <= n < (block // chunks + 1) * gpb, (G, block, warp)
            assert first % 16 == 0 and 1 <= count <= 16
            assert first // 64 == (first + count - 1) // 64 == block % chunks
            seen[n, first:first + count] += 1
    return seen, idle


@pytest.mark.parametrize("L", range(1, 257))
def test_attention_bwd_tiles_cover_every_row_once(L):
    """Every query row (row launch) and key (column launch, the same
    tiling) of every group falls in exactly one warp's 16-row tile, inside
    one 64-row chunk and one block's group pack; no block outgrows four
    warps."""
    for G in ATTN_GROUPS:
        seen, _ = _tile_coverage(2, G, L)
        assert (seen == 1).all(), (G, L, np.argwhere(seen != 1)[:4])


@pytest.mark.parametrize("B,G,L", [s for s in ATTN_SHAPES if s[2] <= 16])
def test_attention_bwd_short_axes_leave_no_warp_idle(B, G, L):
    """At L = 16 and 8 a block packs four groups, one a warp; at the main
    paths' shapes every row falls in one tile and every warp of every block
    has rows."""
    plan = da.bwd_plan(B, G, L)
    assert (plan["groups_per_block"], plan["threads"]) == (4, 128)
    seen, idle = _tile_coverage(B, G, L)
    assert (seen == 1).all() and not idle, idle[:4]


@pytest.mark.parametrize("B,G,L", ATTN_SHAPES + [(2, 1, 1), (1, 7, 33), (3, 12288, 1)])
def test_attention_bwd_cls_chunks_cover_the_keys_in_order(B, G, L):
    """The CLS row's chunks, each one block of its launches, take keys
    c * k .. min(G*L, (c + 1) * k) - 1 for k = ceil(G*L / chunks), as the
    kernels compute it: together every key once, in order, at most 128 a
    chunk, none empty."""
    plan = da.bwd_plan(B, G, L)
    n, chunks = G * L, plan["cls_chunks"]
    k = -(-n // chunks)
    bounds = [(c * k, min(n, (c + 1) * k)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a < b <= a + 128 for a, b in bounds), bounds
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(chunks - 1))


@pytest.mark.parametrize("B,G,L", ATTN_SHAPES + [(2, 5, 40), (3, 8, 256), (1, 1, 1)])
@pytest.mark.parametrize("heads", [8, 6])
def test_attention_bwd_scratch_is_what_the_wrapper_allocates(B, G, L, heads):
    """The wrapper's fp32 scratch has the plan's sizes per (b, h), and those
    are the kernel's layouts: each CLS key's logit and d_cls . v, each
    chunk's partial (sum e k, sum e dp k, sum e, sum e dp, max), the stats,
    the CLS row's dk_cls and dv_cls terms; a dk_cls, dv_cls part per group
    chunk; max, sum and s_dot per token row."""
    dh = 64
    plan = da.bwd_plan(B, G, L, dh)
    cls_scratch, kv_part, row_stats = da._bwd_scratch(plan, B, G, L, heads, dh, "cpu")
    assert plan["cls_scratch"] == 2 * G * L + plan["cls_chunks"] * (2 * dh + 3) + 3 + 2 * dh
    assert plan["kv_part"] == G * plan["row_chunks"] * 2 * dh and plan["row_stats"] == G * L * 3
    for t, key in ((cls_scratch, "cls_scratch"), (kv_part, "kv_part"), (row_stats, "row_stats")):
        assert t.numel() == B * heads * plan[key], key
    assert cls_scratch.shape[:2] == (B, heads) and kv_part.shape[0] == B


def test_attention_bwd_plan_at_the_main_path_shapes():
    """Four groups a block on the short time axes, one group on four warps
    at L = 49, 64-row chunks at L = 192; 128-key CLS chunks."""
    want = {(8, 49, 16): (4, 1, 98, 7), (8, 16, 49): (1, 1, 128, 7),
            (8, 192, 8): (4, 1, 384, 12), (8, 8, 192): (1, 3, 192, 12)}
    for shape, (gpb, chunks, blocks, cls_chunks) in want.items():
        plan = da.bwd_plan(*shape)
        assert (plan["groups_per_block"], plan["row_chunks"], plan["blocks"],
                plan["cls_chunks"], plan["threads"]) == (gpb, chunks, blocks, cls_chunks, 128)


#: group counts of the token-row plan's cases: one group, odd counts (a
#: video's last tile short), the masked rows' 96, the conv time axis's 1280
TOKEN_ROWS_GROUPS = (1, 7, 96, 1280, 1281)


def _token_tile_rows(p, G, L, runs, block, chunk, run, warp):
    """The (b, g, position, head) rows that warp ``warp`` takes in run
    ``run`` of block ``(block, chunk)`` of a tiled token-row launch of
    ``runs`` runs a block under ``p``, found as the kernel finds them
    (``csrc/token_rows_tile.cuh``: ``block_of``, ``run_of``, a warp a head),
    as an array of four columns."""
    gpt, hpb = p["groups_per_tile"], p["heads_per_block"]
    span = gpt * runs
    bpv = -(-G // span)
    b, g_first = block // bpv, block % bpv * span
    none = np.zeros((0, 4), np.int64)
    if run >= -(-min(span, G - g_first) // gpt):  # the block's runs
        return none
    g0 = g_first + run * gpt
    groups = min(gpt, G - g0)
    h0 = chunk * hpb
    if warp >= min(hpb, p["heads"] - h0):
        return none
    r = np.arange(16)
    r = r[(r < gpt * L) & (r // L < groups)]
    return np.stack([np.full_like(r, b), g0 + r // L, r % L, np.full_like(r, h0 + warp)], 1)


def _token_rows_coverage(B, G, L, heads, which):
    """How many warp tiles of the token-row forward or backward (``which``)
    hold each (b, g, position, head) under the plan, after checking that
    every tile lies in one video; the tiled path's items, the divided row
    launch's tiles above."""
    p = {**tr.plan(B, G, L, heads), "heads": heads}
    seen = np.zeros((B, G, L, heads), np.int64)
    if p["tiled"]:
        runs = p["bwd_runs"] if which == "bwd" else 1
        blocks = p[f"{which}_blocks"]
        assert p["threads"] == 32 * p["heads_per_block"] <= 256
        assert blocks == B * -(-G // (p["groups_per_tile"] * runs))
        for block in range(blocks):
            for chunk in range(p["head_chunks"]):
                for run in range(runs):
                    for warp in range(p["threads"] // 32):
                        rows = _token_tile_rows(p, G, L, runs, block, chunk, run, warp)
                        if len(rows):
                            assert len(set(rows[:, 0])) == 1 and rows[0, 0] < B, (block, warp)
                            assert 1 <= len(rows) <= 16 and (rows[:, 1] < G).all()
                            np.add.at(seen, tuple(rows.T), 1)
        return seen
    # above 16 positions: the divided backward's row launch, a tile one group's
    # 16 rows at every head (``_tile`` finds them as the kernel does)
    assert p["head_chunks"] == heads
    for block in range(p["blocks"]):
        for warp in range(p["threads"] // 32):
            tile = _tile(p, B, G, L, block, warp)
            if tile is not None:
                n, first, count = tile
                seen[n // G, n % G, first:first + count] += 1
    return seen


@pytest.mark.parametrize("G", TOKEN_ROWS_GROUPS)
@pytest.mark.parametrize("L", range(1, 65))
def test_token_rows_plan_covers_every_row_once(L, G):
    """Every (b, g, position, head) of the token rows falls in exactly one
    warp tile of the forward and one of the backward, and no tile holds rows
    of two videos: up to 16 positions a tile holds 16 // L whole groups of
    one video, above it 16 rows of one group."""
    for which in ("fwd", "bwd"):
        seen = _token_rows_coverage(2, G, L, 6, which)
        assert (seen == 1).all(), (which, G, L, np.argwhere(seen != 1)[:4])


@pytest.mark.parametrize("heads", [1, 8, 9, 16])
@pytest.mark.parametrize("L", [1, 5, 8, 16])
def test_token_rows_plan_splits_many_heads_over_blocks(heads, L):
    """More heads than a block's eight warps go to several head chunks of
    the same rows; each (row, head) still falls in one tile."""
    p = tr.plan(3, 7, L, heads)
    assert p["heads_per_block"] * p["head_chunks"] >= heads > p["heads_per_block"] * (
        p["head_chunks"] - 1)
    assert p["threads"] <= 256
    assert (_token_rows_coverage(3, 7, L, heads, "bwd") == 1).all()


@pytest.mark.parametrize("L", range(1, 65))
def test_token_rows_scratch_is_what_the_wrapper_allocates(L):
    """The backward's fp32 scratch has the plan's shapes, and those are the
    kernels' layouts: up to 16 positions a CLS-key partial a block and head
    (the tile launch writes element ((x * H + h) * 2 + k/v) * dh + e of
    block x), above a partial a group chunk and head and three statistics
    a row; the tile launches' shared memory fits an SM."""
    for G in TOKEN_ROWS_GROUPS:
        p = tr.plan(2, G, L, 6)
        kv_part, row_stats = tr.bwd_scratch(p, "cpu")
        assert kv_part.dtype == torch.float32
        if p["tiled"]:
            assert kv_part.shape == (p["bwd_blocks"], 6, 2, 64) and row_stats is None
            assert max(p["smem_fwd"], p["smem_bwd"]) <= 227 * 1024
            assert p["bwd_launches"] == 2
        else:
            assert kv_part.shape == (2 * G * p["row_chunks"], 6, 2, 64)
            assert row_stats.shape == (2, G, 6, L, 3) and p["bwd_launches"] == 3
        assert p["fwd_launches"] == 1


def test_token_rows_plan_at_the_main_path_shape():
    """The conv time axis (8 videos, 1280 groups of 8 frames, 6 heads): two
    groups a warp tile and all six heads a block (six warps); the forward a
    pair of groups a block, 640 blocks a video; the backward four pairs in
    turn, double-buffered, 160 blocks a video and one partial a block."""
    p = tr.plan(8, 1280, 8, 6)
    assert {k: p[k] for k in ("tiled", "groups_per_tile", "heads_per_block", "head_chunks",
                              "threads", "fwd_blocks", "bwd_runs", "bwd_blocks")} == {
        "tiled": True, "groups_per_tile": 2, "heads_per_block": 6, "head_chunks": 1,
        "threads": 192, "fwd_blocks": 5120, "bwd_runs": 4, "bwd_blocks": 1280}
    assert p["kv_part"] == (1280, 6, 2, 64)
    assert (p["smem_fwd"], p["smem_bwd"]) == (6 * 6144 + 3072, 2 * 6 * 8192 + 6144)


@pytest.mark.parametrize("G,runs", [(1280, 4), (96, 1), (7, 1), (200, 3)])
def test_token_rows_backward_runs_leave_two_blocks_an_sm(G, runs):
    """The backward takes up to four runs a block, as many as leave at least
    two blocks an SM of the H100 (8 videos of G groups of 8 frames)."""
    p = tr.plan(8, G, 8, 6)
    assert p["bwd_runs"] == runs
    assert runs == 1 or p["bwd_blocks"] >= 2 * 132


def test_token_rows_long_axes_take_the_divided_backward_plan():
    """Above 16 positions the token-row backward launches the divided
    backward's row and column launches with that plan's group packs."""
    for L in (17, 33, 49, 64):
        p = tr.plan(8, 96, L, 6)
        want = da.bwd_plan(8, 96, L)
        assert {k: p[k] for k in ("groups_per_block", "row_chunks", "threads", "blocks")} == {
            k: want[k] for k in ("groups_per_block", "row_chunks", "threads", "blocks")}
