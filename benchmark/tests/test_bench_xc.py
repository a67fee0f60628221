"""MINTIME-XC's parts of the benchmark: its configuration holds the yaml
with nothing changed, its FLOP count against a hook count of the port's
Xception, its family's program against its reference at a tiny size, and the
backbone's device-time metric."""

import os

import pytest
import torch
import yaml

import tiny
from harness import compare, core, files, weights
from reference import assembly, xception as xc
from reference.numerics import Numerics

CFG = files.load_json(os.path.join(files.BENCH, "configs", "mintime_xc.json"))


def test_config_is_the_yaml_unchanged():
    raw = yaml.safe_load(open(os.path.join(files.ROOT, "configs",
                                           "size_invariant_timesformer.yaml")))
    for section, values in raw.items():
        assert CFG[section] == values, section
    assert CFG["model"]["channels"] == xc.FEATURES == 2048
    assert CFG["backbone"] == "xception" and CFG["family"] == "mintime_xc"
    entry = next(c for c in files.benchmark()["configs"] if c["name"] == "mintime_xc")
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/mintime_xc.json"


def _hook_macs(size: int) -> int:
    """Multiply-adds of every convolution of the port's Xception on one
    ``size`` px face, from the shapes its forward hooks see (on the meta
    device: nothing is computed)."""
    from mintime_torch.models.xception import Xception

    model, total = Xception().to("meta").eval(), []

    def hook(m, inputs, out):
        total.append(out.numel() * m.in_channels // m.groups * m.kernel_size[0]
                     * m.kernel_size[1])
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    model(torch.empty(1, size, size, 3, device="meta"))
    return sum(total)


def test_flops_against_a_hook_count():
    fl = files.module("flops", "mintime_xc")
    stem, rest = fl.backbone_macs(224)
    assert stem + rest == _hook_macs(224) == 4_550_831_072
    assert sum(fl.backbone_macs(96)) == _hook_macs(96)
    assert fl.forward(CFG) == pytest.approx(222.35e9, abs=0.01e9)
    assert fl.train(CFG) > 2.9 * fl.forward(CFG)


def test_program_against_its_reference_at_a_tiny_size():
    cell = tiny.cell("xc_score_b96")
    cfg, traffic = cell["config_file"], cell["traffic_file"]
    fam = files.module("families", "mintime_xc")
    sd = weights.make(fam.spec(cfg), 3, "cpu")
    videos = files.module("inputs", traffic["inputs"]).make(traffic, cfg, 4, "cpu")[:3]
    prog = fam.Serving(cfg, sd, "cpu")
    ref = fam.ReferenceServing(cfg, sd, "cpu", Numerics())
    got, want = prog.predict(prog.prepare(videos, traffic)), ref.predict(ref.prepare(videos, traffic))
    m = fam.model(cfg)
    gaps = compare.answers(got, want, assembly.SCALE, 1 + m["num_frames"] * m["num_patches"])
    assert gaps["prob_gap"] < 1e-5 and gaps["share_gap"] < 1e-4 and gaps["attn_gap"] < 1e-3, gaps
    assert 0.05 < min(g[0] for g in got) and max(g[0] for g in got) < 0.95
    assert core.reference_imports() == []


def test_calibration_leaves_the_weights_and_sets_the_stem():
    fam = files.module("families", "mintime_xc")
    sd = weights.make(xc.param_spec("extractor"), 0, "cpu")
    cal = fam.calibrated(sd)
    assert torch.equal(sd["extractor.bn1.running_var"], torch.ones(32))
    w = sd["extractor.conv1.weight"]
    assert torch.allclose(cal["extractor.bn1.running_mean"], 127.5 * w.sum((1, 2, 3)))
    assert set(cal) == set(sd)
    assert all(cal[k] is sd[k] for k in sd if not k.startswith("extractor.bn1.running"))


def test_extractor_device_ms(monkeypatch):
    from harness import spans

    metric = files.module("metrics", "extractor_device_ms.score")
    monkeypatch.setattr(spans, "counters",
                        lambda: {"extractor_device_us": 361_500, "extractor_timed": 3})
    assert metric.read(None) == pytest.approx(120.5)
    monkeypatch.setattr(spans, "counters", lambda: {"faces_run": 10})
    assert metric.read(None) is None
    monkeypatch.setattr(spans, "counters", lambda: None)
    assert metric.read(None) is None
