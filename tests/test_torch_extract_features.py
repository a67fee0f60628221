"""The port's offline feature extraction
(``mintime_torch/preprocessing/extract_features.py``) against the JAX
package's (``mintime_tpu/preprocessing/extract_features.py``) on the same PNG
tree and weights, on the CPU. The JAX function runs B0 in bf16 only, the port
in fp32 on the CPU, so each feature map is held to the repo's bf16 vs fp32
tolerance: 5e-2 of max |JAX|; the files' layout and count are equal. The
crops are resized to 32 (both functions take the size) to keep B0 small; the
CLI runs at its 224.
"""

import os

import numpy as np
import pytest
import torch

from mintime_torch.preprocessing import extract_features as port

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root) -> list[str]:
    """Five crops of several sizes (some under 32 px, some over) in the
    reference's ``<video>/<identity>/<frame>_<face>.png`` layout."""
    rng = np.random.default_rng(0)
    paths = []
    for v, sides in enumerate(((20, 48), (33, 64, 40))):
        for i, side in enumerate(sides):
            d = os.path.join(root, f"video_{v}", str(i))
            os.makedirs(d, exist_ok=True)
            p = os.path.join(d, f"{30 * i}_0.png")
            cv2.imwrite(p, rng.integers(0, 256, (side, side + 3, 3), dtype=np.uint8))
            paths.append(p)
    return sorted(paths)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX B0 variables and the same weights as an Extractor_checkpoint file."""
    from mintime_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
    from mintime_torch.convert import efficientnet_state_dict
    from tests.test_torch_efficientnet import random_variables

    variables = random_variables(JaxEfficientNet("efficientnet-b0"),
                                 np.zeros((1, 32, 32, 3), np.float32))
    path = tmp_path_factory.mktemp("w") / "Extractor_checkpoint"
    torch.save(efficientnet_state_dict(variables), path)
    return variables, str(path)


def _read(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = np.load(os.path.join(d, f))
    return out


@pytest.mark.parametrize("imagenet_norm", [False, True])
def test_features_match_jax(tmp_path, weights, imagenet_norm):
    from mintime_tpu.preprocessing.extract_features import extract_features as jax_extract

    variables, path = weights
    faces = tmp_path / "faces"
    paths = _tree(str(faces))
    n_jax = jax_extract(paths, variables, str(tmp_path / "jax"), str(faces), image_size=32,
                        batch_size=4, imagenet_norm=imagenet_norm)
    model = port.build_extractor(path, device="cpu")
    n_port = port.extract_features(paths, model, str(tmp_path / "port"), str(faces),
                                   image_size=32, batch_size=4, imagenet_norm=imagenet_norm)
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert n_jax == n_port == len(paths) == len(got)
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        assert got[name].dtype == np.float32 and got[name].shape == ref.shape == (1, 1, 1280)
        err = np.abs(got[name] - ref).max()
        assert err <= 5e-2 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_decoded_crops_give_the_same_files(tmp_path, weights):
    """The function takes the crops decoded (what the card's machine does)
    or a reader of paths, and writes the same maps either way."""
    _, path = weights
    faces = tmp_path / "faces"
    paths = _tree(str(faces))
    model = port.build_extractor(path, device="cpu")
    port.extract_features(paths, model, str(tmp_path / "a"), str(faces), image_size=32)
    crops = [cv2.imread(p) for p in paths]
    port.extract_features(paths, model, str(tmp_path / "b"), str(faces), crops=crops,
                          image_size=32)
    a, b = _read(tmp_path / "a"), _read(tmp_path / "b")
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_cli_at_224(tmp_path, weights, capsys):
    _, path = weights
    faces = tmp_path / "faces"
    paths = _tree(str(faces))[:2]
    for p in _tree(str(faces))[2:]:
        os.remove(p)
    n = port.main(["--faces_path", str(faces), "--output_path", str(tmp_path / "out"),
                   "--extractor_weights", path, "--batch_size", "2", "--device", "cpu"])
    assert n == len(paths) and "wrote 2 feature files" in capsys.readouterr().out
    assert {v.shape for v in _read(tmp_path / "out").values()} == {(7, 7, 1280)}


def test_cli_without_weights_warns(tmp_path, capsys):
    faces = tmp_path / "faces"
    _tree(str(faces))
    for p in _tree(str(faces))[1:]:
        os.remove(p)
    port.main(["--faces_path", str(faces), "--output_path", str(tmp_path / "out"),
               "--device", "cpu"])
    assert "WARNING: no --extractor_weights" in capsys.readouterr().out


def test_extractor_file_with_a_missing_key_raises(tmp_path, weights):
    _, path = weights
    sd = torch.load(path)
    sd.pop("_conv_stem.weight")
    torch.save(sd, tmp_path / "bad")
    with pytest.raises(KeyError):
        port.build_extractor(str(tmp_path / "bad"), device="cpu")
