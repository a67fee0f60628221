"""The work counts against hand counts at small shapes, and the per-layer
readers on a made-up record."""

import pytest
import torch

from harness import files, readers
from harness.core import Record


def test_kernel_work_by_hand():
    k = files.modules("kernels")
    M, D, H = 10, 8, 32
    x, w0, b0 = torch.zeros(2, 5, D, dtype=torch.bfloat16), torch.zeros(2 * H, D), torch.zeros(2 * H)
    w1, b1 = torch.zeros(D, H), torch.zeros(D)
    out = torch.zeros(2, 5, D, dtype=torch.bfloat16)
    f, b = k["geglu_ffn"].work((x, w0, b0, w1, b1), {}, out)
    assert f == 2 * M * D * 2 * H + 2 * M * H * D
    assert b == 2 * M * D * 2 + 4 * (2 * H * D + 2 * H + D * H + D)
    f, _ = k["geglu_ffn_bwd"].work((x, w0, b0, w1, out), {}, (x, w0, b0, w1, b1))
    assert f == 3 * (2 * M * D * 2 * H) + 2 * (2 * M * H * D)
    B, G, L, inner = 2, 3, 4, 16
    qkv, qc = torch.zeros(B, G, L, 3 * inner), torch.zeros(B, 1, 3 * inner)
    o, oc = torch.zeros(B, G, L, inner), torch.zeros(B, 1, inner)
    f, b = k["divided_attention"].work((qkv, qc, None, None), {}, (o, oc))
    # each token row: L keys and the CLS key; the CLS row: G L keys and itself
    assert f == 4 * inner * (B * G * L * (L + 1) + B * (G * L + 1))
    assert b == 4 * (qkv.numel() + qc.numel() + o.numel() + oc.numel())
    f, _ = k["divided_attention_bwd"].work((qkv, qc, None, None, o, oc), {}, (qkv, qc))
    assert f == 10 * inner * (B * G * L * (L + 1) + B * (G * L + 1))
    f, _ = k["token_rows_attention"].work((qkv, qc, None), {}, o)
    assert f == 4 * inner * B * G * L * (L + 1)


def test_backbone_macs_by_hand():
    fl = files.module("flops", "mintime_classifier")
    # B0's published 0.39 G multiply-adds at 224 px
    stem, rest = fl.backbone_macs(224)
    assert stem == 112 * 112 * 32 * 27
    assert 0.38e9 < stem + rest < 0.41e9


def test_head_macs_by_hand():
    fl = files.module("flops", "mintime_classifier")
    m = {"num_frames": 2, "dim": 4, "heads": 1, "dim_head": 2, "depth": 1, "num_classes": 1}
    emb, layers = fl.head_macs(m, 2, 3, 5)  # 2 frames of 3 tokens, 5 inputs a token
    t = 7
    by_hand = (2 * (t * 4 * 6 + t * 2 * 4) + t * (4 * 32 + 16 * 4)
               + 2 * 2 * (6 * 3 + 6 * 4 + 2 * t) + 4)
    assert emb == 6 * 5 * 4 and layers == by_hand


def test_flagship_forward_near_the_issue_count():
    cfg = files.load_json(files.BENCH + "/configs/mintime_ef.json")
    fl = files.module("flops", "mintime_classifier")
    assert 85e9 < fl.forward(cfg) < 92e9
    assert fl.train(cfg) < 3 * fl.forward(cfg)


def _record():
    rec = Record(items_per_s=100.0, flops_per_item=1e12, device_kind="NVIDIA H100 80GB HBM3")
    rec.traced = {"kernels": [("geglu_ffn_up_kernel<128>", 0, 2_000_000),
                              ("elementwise", 1_000_000, 3_000_000),
                              ("ffn_bwd_dh_kernel", 5_000_000, 6_000_000)],
                  "window_s": 0.01, "host": []}
    rec.traced_calls = 2
    rec.kernel_calls = [("geglu_ffn", 989e9, 0), ("geglu_ffn_bwd", 0, 3.35e9)]
    return rec


def test_readers():
    rec = _record()
    assert readers.mfu_pct(rec) == pytest.approx(100 * 1e14 / 989e12)
    # busy 0-3 ms and 5-6 ms of a 10 ms window
    assert readers.idle_pct(rec) == pytest.approx(60.0)
    # least 1 ms + 1 ms over the hand-written kernels' 2 ms + 1 ms
    assert readers.roofline_pct(rec) == pytest.approx(100 * 2 / 3)
    assert readers.per_call(rec) == 1.5


def test_readers_return_nothing_without_a_trace():
    rec = Record()
    assert readers.idle_pct(rec) is None and readers.roofline_pct(rec) is None
    assert readers.mfu_pct(Record(items_per_s=1.0, flops_per_item=1.0, device_kind="cpu")) is None
