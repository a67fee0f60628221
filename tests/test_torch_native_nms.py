"""The port's native greedy NMS (``mintime_torch/native``) against the JAX
package's (``mintime_tpu.native``): keep sets bit-equal for float32 and
float64, IoU and min overlap, with and without MATLAB's +1 areas, on scores
with ties, degenerate and NaN/inf boxes, and empty input. The port's numpy
version (its plain version) gives the same keep sets. Tolerance: none, the
keep sets are compared for equality."""

import numpy as np
import pytest

import mintime_tpu.native as jax_native
from mintime_torch import native
from mintime_torch.preprocessing import mtcnn as port_mtcnn
from mintime_tpu.preprocessing import mtcnn as jax_mtcnn


def _random_boxes(rng, n, dtype, wild=False):
    cx = rng.uniform(0, 200, n)
    cy = rng.uniform(0, 200, n)
    s = rng.uniform(0.5, 60, n)
    boxes = np.stack([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2], 1)
    if wild and n >= 8:
        boxes[0] = [10, 10, 10, 10]  # zero area
        boxes[1] = [50, 50, 30, 30]  # inverted
        boxes[2, 2] = np.nan
        boxes[3, 1] = np.inf
        boxes[4] = boxes[5]  # exact duplicate
    return boxes.astype(dtype)


def _cases(dtype, seed):
    rng = np.random.default_rng(seed)
    for trial in range(25):
        n = int(rng.integers(0, 400))
        boxes = _random_boxes(rng, n, dtype, wild=trial % 3 == 0)
        # quantised scores force ties
        scores = ((rng.uniform(0, 1, n) * 8).round() / 8).astype(dtype)
        yield trial, boxes, scores, [0.5, 0.7][trial % 2]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method_min", [False, True])
@pytest.mark.parametrize("plus_one", [False, True])
def test_keep_sets_equal_the_jax_packages(dtype, method_min, plus_one):
    assert jax_native._lib is not None, "the JAX package's native NMS must load here"
    for trial, boxes, scores, thr in _cases(dtype, seed=42 + 2 * method_min + plus_one):
        order = np.argsort(-scores, kind="stable")
        want = jax_native.greedy_nms(boxes, order, thr, method_min=method_min, plus_one=plus_one)
        got = native.greedy_nms(boxes, order, thr, method_min=method_min, plus_one=plus_one)
        plain = native.greedy_nms_numpy(boxes, order, thr, method_min=method_min,
                                        plus_one=plus_one)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(plain, want, err_msg=f"numpy, trial {trial}")
        np.testing.assert_array_equal(order, np.argsort(-scores, kind="stable"))  # unmutated


@pytest.mark.parametrize("flavor", ["tv", "union", "min"])
def test_cascade_nms_equals_the_jax_cascades(flavor):
    """The cascade's three NMS calls keep what the JAX cascade's keep."""
    for dtype in (np.float32, np.float64):
        for trial, boxes, scores, thr in _cases(dtype, seed=7):
            if flavor == "tv":
                got, want = port_mtcnn.nms_tv(boxes, scores, thr), jax_mtcnn.nms_tv(boxes, scores, thr)
            else:
                got = port_mtcnn.nms(boxes, scores, thr, method=flavor)
                want = jax_mtcnn.nms(boxes, scores, thr, method=flavor)
            np.testing.assert_array_equal(got, want, err_msg=f"{dtype} trial {trial}")


def test_empty_input_and_tied_scores():
    empty = np.zeros((0, 4), np.float32)
    order = np.zeros(0, np.int64)
    assert native.greedy_nms(empty, order, 0.5, False, False).tolist() == []
    assert native.greedy_nms_numpy(empty, order, 0.5, False, False).tolist() == []
    # two identical boxes with the same score: the first in the order is kept
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [50, 50, 60, 60]], np.float32)
    for order in ([0, 1, 2], [1, 0, 2]):
        order = np.array(order)
        want = jax_native.greedy_nms(boxes, order, 0.5, method_min=False, plus_one=False)
        assert native.greedy_nms(boxes, order, 0.5, False, False).tolist() == want.tolist()
        assert want.tolist() == [order[0], 2]


def test_library_is_built_under_the_package_and_loaded():
    lib = native.load()
    assert lib is native.load()
    assert native.library_path().exists()
    assert native.library_path().parent.name == ".build"


def test_bad_input_raises():
    boxes = np.zeros((2, 4), np.int32)
    with pytest.raises(TypeError, match="float32 or float64"):
        native.greedy_nms(boxes, np.array([0, 1]), 0.5, False, False)
    with pytest.raises(IndexError):
        native.greedy_nms(boxes.astype(np.float32), np.array([0, 2]), 0.5, False, False)


def test_failed_build_raises_with_gccs_output(tmp_path, monkeypatch):
    """A source gcc refuses raises with gcc's message; nothing falls back."""
    bad = tmp_path / "nms.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="gcc failed to build nms.c"):
        native.load()
