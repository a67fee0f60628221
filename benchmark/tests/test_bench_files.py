"""The harness finds every cell, configuration, traffic mix, limit, driver,
input maker, family, FLOP count, metric and kernel by name, and
BENCHMARK.json keeps to the contract's form."""

import json
import os
import re

import pytest

from harness import files

BENCH = files.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(files.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(w):
    c = files.cell(BENCH, w)
    t, cfg = c["traffic_file"], c["config_file"]
    assert files.module("drivers", t["driver"]).run
    assert files.module("inputs", t["inputs"]).make
    fam = files.module("families", cfg["family"])
    assert fam.spec(cfg) and fam.logits
    flops = files.module("flops", cfg["family"])
    assert flops.forward(cfg) > 0 and flops.train(cfg) > flops.forward(cfg)
    assert c["limits"] and c["chips"] in (1, 4)
    e2e = files.cell_metrics(BENCH, w, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert files.cell_metrics(BENCH, w, "per_layer")


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_by_name(m):
    spec = next(x for x in BENCH["per_layer"] if x["name"] == m)
    assert spec["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert callable(files.module("metrics", m).read)


def test_kernels_by_name():
    ks = files.modules("kernels")
    assert {"geglu_ffn", "geglu_ffn_bwd", "divided_attention", "divided_attention_bwd",
            "token_rows_attention", "token_rows_attention_bwd"} <= set(ks)
    for k in ks.values():
        assert k.MODULE.startswith("mintime_torch.") and k.KERNELS and callable(k.work)


def test_config_entries():
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(files.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        json.load(open(os.path.join(files.ROOT, c["file"])))
