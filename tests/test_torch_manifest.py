"""``mintime_torch.data.manifest.load_manifest`` (no pandas) against
``mintime_tpu.data.manifest.load_manifest`` (pandas) on the same split lists:
the same videos, labels and method ids, NaN where the JAX package has NaN."""

import math
import os

import numpy as np
import pytest

from mintime_torch.data import manifest as port_manifest
from mintime_tpu.data import manifest as jax_manifest

ROWS = [
    "real/a 0",
    "fake/b 1 3",
    "fake/c 1 1",
    "real/d 0 NaN",
    "real/e 0 nan",
    "fake/f 1.0 2",
    "real/g 0 0",
    "fake/missing 1 4",
    "",
    "fake/h 1 4.0",
    "real/i 0",
    "fake/j 1 2",
]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("manifest")
    for row in ROWS:
        if row and "missing" not in row:
            os.makedirs(root / "faces" / row.split(" ")[0])
    path = root / "test.csv"
    path.write_text("\n".join(ROWS) + "\n")
    return str(path), str(root / "faces")


def _same(got, want):
    assert got.videos == want.videos
    assert got.labels == want.labels
    assert all(isinstance(x, float) for x in got.labels + got.multiclass)
    assert len(got.multiclass) == len(want.multiclass)
    for g, w in zip(got.multiclass, want.multiclass):
        assert (math.isnan(g) and math.isnan(w)) or g == w, (got.multiclass, want.multiclass)


@pytest.mark.parametrize("kwargs", [
    {},
    {"data_path": True},
    {"data_path": True, "deepfake_methods": [1, 2]},
    {"data_path": True, "deepfake_methods": [0, 4]},
    {"deepfake_methods": [0]},
    {"data_path": True, "max_videos": 4},
    {"data_path": True, "max_videos": 4, "shuffle_seed": 42},
    {"max_videos": 20, "shuffle_seed": 7},
    {"data_path": True, "shuffle_seed": 42},
    {"data_path": True, "deepfake_methods": [3, 4], "max_videos": 1, "shuffle_seed": 3},
], ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()) or "plain")
def test_load_manifest_matches_jax(split, kwargs):
    csv, faces = split
    kwargs = {**kwargs, "data_path": faces} if kwargs.get("data_path") else kwargs
    got = port_manifest.load_manifest(csv, **kwargs)
    want = jax_manifest.load_manifest(csv, **kwargs)
    _same(got, want)
    assert len(got) == len(want) > 0


def test_missing_fields_and_na_spellings_read_as_nan(tmp_path):
    path = tmp_path / "l.csv"
    path.write_text("v0 1\nv1 0 NA\nv2 1 null\nv3 0 5\n")
    rows = port_manifest.read_rows(str(path))
    assert [r[0] for r in rows] == ["v0", "v1", "v2", "v3"]
    assert [r[1] for r in rows] == [1.0, 0.0, 1.0, 0.0]
    assert np.isnan([r[2] for r in rows[:3]]).all() and rows[3][2] == 5.0
    _same(port_manifest.load_manifest(str(path)), jax_manifest.load_manifest(str(path)))


def test_too_many_fields_raise(tmp_path):
    path = tmp_path / "l.csv"
    path.write_text("v0 1 2 3\n")
    with pytest.raises(ValueError, match="4 fields"):
        port_manifest.load_manifest(str(path))
