"""Each configuration file holds its yaml's values as data."""

import os

import yaml

from harness import files

CASES = {"mintime_ef": ("size_invariant_timesformer.yaml", {("model", "channels"): 1280}),
         "conv_timesformer_b20": ("convolutional_timesformer.yaml", {})}


def test_configs_hold_the_yaml():
    for name, (y, changed) in CASES.items():
        entry = next(c for c in files.benchmark()["configs"] if c["name"] == name)
        cfg = files.load_json(os.path.join(files.ROOT, entry["file"]))
        raw = yaml.safe_load(open(os.path.join(files.ROOT, "configs", y)))
        for section, values in raw.items():
            for k, v in values.items():
                want = changed.get((section, k), v)
                assert cfg[section][k] == want, (name, section, k)
        assert set(cfg["model"]) == set(raw["model"])


def test_ef_channels_is_efficientnet_b0():
    from reference import efficientnet as eff

    cfg = files.load_json(os.path.join(files.BENCH, "configs", "mintime_ef.json"))
    assert cfg["model"]["channels"] == eff.feature_channels(None) == 1280
