"""The port's evaluation transform (torch, no cv2) vs the JAX package's
(``cv2.resize`` with INTER_AREA down and INTER_CUBIC up, then a centred pad)
on seeded random uint8 crops, on the CPU.

Bitwise: cv2 sums its area weights in float32 in an order the port
follows, and hands its cubic resize to IPP (float32 fused multiply-adds in
a fixed order), which the port follows too.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mintime_torch.data import augment  # noqa: E402
from mintime_tpu.data.augment import create_val_transform as jax_val_transform  # noqa: E402

SIZES = [
    (40, 40), (57, 40), (100, 161), (150, 223), (223, 223),  # up: INTER_CUBIC
    (224, 224), (224, 150), (97, 224),  # the longer side is already 224: pad only
    (225, 225), (301, 448), (448, 448), (448, 300), (672, 672), (500, 333), (233, 517),
    (700, 700), (700, 365),  # down: INTER_AREA, at 2x, 3x and non-integer scales
]


def _crops(h, w, n=2):
    rng = np.random.default_rng([h, w])
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_matches_the_cv2_transform(h, w):
    crops = _crops(h, w)
    want = np.asarray(jax_val_transform(224)(crops, np.random.default_rng(0)))
    got = augment.create_val_transform(224)(crops, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (2, 224, 224, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mixed_sizes_in_one_call():
    crops = _crops(90, 120, 1) + _crops(224, 224, 1) + _crops(450, 400, 1)
    got = augment.create_val_transform(64)(crops, device="cpu")
    want = np.asarray(jax_val_transform(64)(crops, np.random.default_rng(0)))
    assert tuple(got.shape) == want.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", [(225, 301), (96, 71)])
def test_isotropic_size_rounds_half_to_even(h, w):
    """Python's round, as the reference's: 224 * 225 / 301 = 167.44 → 167,
    224 * 71 / 96 = 165.67 → 166, and a side landing on .5 goes to even."""
    img = _crops(h, w, 1)[0]
    s = 224 / max(h, w)
    assert augment.isotropic_size(h, w, 224) == (int(round(h * s)), int(round(w * s)))
    assert augment.isotropic_size(301, 448, 224) == (150, 224)  # 150.5 → 150
    resized = augment.resize(torch.from_numpy(img), *augment.isotropic_size(h, w, 224))
    assert tuple(resized.shape[:2]) == cv2.resize(
        img, augment.isotropic_size(h, w, 224)[::-1]).shape[:2]


def test_area_weights_sum_to_one():
    for src, dst in ((301, 150), (700, 224), (225, 224)):
        idx, wt = augment.area_taps(src, dst)
        np.testing.assert_allclose(wt.sum(1), 1.0, atol=1e-6)
        assert idx.min() >= 0 and idx.max() < src
