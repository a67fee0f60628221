"""The train-mode augmentations on a card against the same code on the CPU
(``mintime_torch.data.augment``, the JPEG round trip of
``mintime_torch.data.jpeg``), on seeded frames and draws at 224 px: bitwise
for HorizontalFlip, InvertImg, CoarseDropout, RandomBrightnessContrast,
RandomGamma, RGBShift, GaussNoise, MultiplicativeNoise, MedianBlur and the
INTER_CUBIC resize, within one level for every other transform. Needs an
NVIDIA GPU and skips without one; the file imports no cv2, so it runs on
the card's machine:
``python -m pytest tests/test_torch_augment_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from mintime_torch.data import augment, augment_plan, jpeg

S, F = 224, 4
BITWISE = ("HorizontalFlip", "InvertImg", "CoarseDropout", "RandomBrightnessContrast",
           "RandomGamma", "RGBShift", "GaussNoise", "MultiplicativeNoise", "MedianBlur")


def _frames(seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    base = np.stack([xx, yy, (xx + yy) // 2], -1) * r.uniform(0.3, 1.0)
    out = [np.clip(base + r.normal(0, 20, (S, S, 3)) + r.integers(0, 60), 0, 255)
           .astype(np.uint8) for _ in range(F - 1)]
    return torch.from_numpy(np.stack(out + [np.zeros((S, S, 3), np.uint8)]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(augment.STACK_STEPS))
def test_card_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t = getattr(augment_plan, name)()
    for seed in range(3):
        params = t.sample(np.random.default_rng(seed), (S, S, 3))
        x = _frames(seed)
        cpu = augment.apply_step(x, (t, params))
        card = augment.apply_step(x.cuda(), (t, params)).cpu()
        diff = (card.to(torch.int16) - cpu.to(torch.int16)).abs()
        assert int(diff.max()) <= (0 if name in BITWISE else 1), (name, seed, int(diff.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [60, 75, 90, 100])
def test_jpeg_card_matches_cpu(quality):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = _frames(quality)
    odd = x[:, :75, :101].contiguous()
    for img in (x, odd):
        assert torch.equal(jpeg.jpeg_roundtrip(img.cuda(), quality).cpu(),
                           jpeg.jpeg_roundtrip(img, quality))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(2, 150), (57, 40), (100, 161), (223, 60)])
def test_cubic_resize_card_matches_cpu(h, w):
    """INTER_CUBIC growing a crop, OpenCV's own path (a side under 4) and
    IPP's: the card's float64 fused multiply-adds give the CPU's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    img = torch.from_numpy(np.random.default_rng(h * w).integers(0, 256, (h, w, 3), np.uint8))
    nh, nw = augment.isotropic_size(h, w, S)
    assert torch.equal(augment.resize(img.cuda(), nh, nw, "cubic").cpu(),
                       augment.resize(img, nh, nw, "cubic"))

