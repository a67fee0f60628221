"""The draws of the train-mode augmentations (counterpart of the parameter
side of ``mintime_tpu/data/augment.py:39-760``), numpy only.

A video's augmentation is drawn once and applied to every one of its crops
(albumentations' ``additional_targets``). This module makes the draws and
nothing else, so that a loader's spawned worker can make them without
torch; :mod:`mintime_torch.data.augment` applies them on a device.

Each transform here holds what its JAX namesake was built with and draws
what that one's ``sample`` draws, from the same generator, in the same
order:

* a transform draws ``rng.random()`` against its ``p`` first, even when
  ``p`` is 1.0, then its ``sample``;
* ``OneOf`` draws its ``p``, then the member's index, then the member's
  ``sample``, and ignores the member's own ``p``;
* a ``sample`` reads the shape of the video's first frame at its turn:
  the first crop's shape through the resize chain, ``(size, size, 3)``
  after it.

Calling a :class:`Compose` on ``(crop_shapes, rng)`` returns the steps that
fire, in order, as ``(transform, params)`` pairs: the transform (which
names the operation and holds its settings) and its ``sample`` dict, arrays
included (``GaussNoise``'s noise, ``MultiplicativeNoise``'s ``m``, the seeds
of ``ISONoise`` and ``GlassBlur``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

#: interpolations of ``IsotropicResize``, as cv2 names them
INTER_AREA, INTER_LINEAR, INTER_CUBIC = "area", "linear", "cubic"


class Transform:
    p: float = 1.0

    def sample(self, rng: np.random.Generator, shape) -> dict:
        return {}

    def shape_after(self, shape: tuple) -> tuple:
        """The first frame's shape after this transform."""
        return shape

    def draw(self, steps: list, shape: tuple, rng: np.random.Generator) -> tuple:
        """Append this transform's step to ``steps`` if it fires; returns
        the first frame's shape after it."""
        if rng.random() >= self.p:
            return shape
        steps.append((self, self.sample(rng, shape)))
        return self.shape_after(shape)

    @property
    def name(self) -> str:
        return type(self).__name__


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def draw(self, steps, shape, rng):
        for t in self.transforms:
            shape = t.draw(steps, shape, rng)
        return shape

    def __call__(self, crop_shapes: Sequence[tuple], rng: np.random.Generator) -> list:
        """The steps that fire for a video whose crops have these shapes."""
        steps: list = []
        self.draw(steps, tuple(crop_shapes[0]), rng)
        return steps


class OneOf(Transform):
    def __init__(self, transforms: Sequence[Transform], p: float = 0.5):
        self.transforms = list(transforms)
        self.p = p

    def draw(self, steps, shape, rng):
        if rng.random() >= self.p:
            return shape
        t = self.transforms[rng.integers(len(self.transforms))]
        steps.append((t, t.sample(rng, shape)))
        return t.shape_after(shape)


# ---------------------------------------------------------------- geometry
class IsotropicResize(Transform):
    def __init__(self, max_side, interpolation_down=INTER_AREA, interpolation_up=INTER_CUBIC,
                 p=1.0):
        self.max_side = max_side
        self.down = interpolation_down
        self.up = interpolation_up
        self.p = p

    def shape_after(self, shape):
        h, w = shape[:2]
        if max(h, w) == self.max_side:
            return shape
        scale = self.max_side / max(h, w)
        return (int(round(h * scale)), int(round(w * scale))) + tuple(shape[2:])


class PadIfNeeded(Transform):
    def __init__(self, min_height, min_width, p=1.0):
        self.min_h = min_height
        self.min_w = min_width
        self.p = p

    def shape_after(self, shape):
        return (max(shape[0], self.min_h), max(shape[1], self.min_w)) + tuple(shape[2:])


class Resize(Transform):
    def __init__(self, height, width, p=1.0):
        self.h, self.w = height, width
        self.p = p

    def shape_after(self, shape):
        return (self.h, self.w) + tuple(shape[2:])


class HorizontalFlip(Transform):
    def __init__(self, p=0.5):
        self.p = p


class ShiftScaleRotate(Transform):
    def __init__(self, shift_limit=0.1, scale_limit=0.2, rotate_limit=5, p=0.5):
        self.shift = shift_limit
        self.scale = scale_limit
        self.rot = rotate_limit
        self.p = p

    def sample(self, rng, shape):
        return {
            "dx": rng.uniform(-self.shift, self.shift),
            "dy": rng.uniform(-self.shift, self.shift),
            "scale": 1 + rng.uniform(-self.scale, self.scale),
            "angle": rng.uniform(-self.rot, self.rot),
        }


# ---------------------------------------------------------------- photometric
class ImageCompression(Transform):
    def __init__(self, quality_lower=60, quality_upper=100, p=0.2):
        self.lo, self.hi = quality_lower, quality_upper
        self.p = p

    def sample(self, rng, shape):
        return {"quality": int(rng.integers(self.lo, self.hi + 1))}


class GaussNoise(Transform):
    def __init__(self, var_limit=(10.0, 50.0), p=0.3):
        self.var = var_limit
        self.p = p

    def sample(self, rng, shape):
        sigma = math.sqrt(rng.uniform(*self.var))
        return {"noise": rng.standard_normal(shape, dtype=np.float32) * np.float32(sigma)}


class MultiplicativeNoise(Transform):
    def __init__(self, mult=(0.9, 1.1), p=1.0):
        self.mult = mult
        self.p = p

    def sample(self, rng, shape):
        return {"m": rng.uniform(*self.mult, size=shape).astype(np.float32)}


class ISONoise(Transform):
    def __init__(self, color_shift=(0.01, 0.05), intensity=(0.1, 0.5), p=1.0):
        self.color_shift = color_shift
        self.intensity = intensity
        self.p = p

    def sample(self, rng, shape):
        return {
            "shift": rng.uniform(*self.color_shift),
            "intensity": rng.uniform(*self.intensity),
            "seed": int(rng.integers(2**31)),
        }


class GaussianBlur(Transform):
    def __init__(self, blur_limit=3, p=0.05):
        self.limit = blur_limit
        self.p = p

    def sample(self, rng, shape):
        return {"k": int(rng.integers(1, self.limit // 2 + 2)) * 2 + 1}


class MedianBlur(Transform):
    def __init__(self, blur_limit=7, p=1.0):
        self.limit = blur_limit
        self.p = p

    def sample(self, rng, shape):
        return {"k": int(rng.integers(1, self.limit // 2 + 1)) * 2 + 1}


class MotionBlur(Transform):
    def __init__(self, blur_limit=7, p=1.0):
        self.limit = blur_limit
        self.p = p

    def sample(self, rng, shape):
        k = int(rng.integers(3, self.limit + 1))
        kernel = np.zeros((k, k), np.float32)
        angle = rng.uniform(0, 180)
        c = (k - 1) / 2
        dx, dy = math.cos(math.radians(angle)), math.sin(math.radians(angle))
        for t in np.linspace(-c, c, k * 2):
            x, y = int(round(c + t * dx)), int(round(c + t * dy))
            if 0 <= x < k and 0 <= y < k:
                kernel[y, x] = 1
        return {"kernel": kernel / max(kernel.sum(), 1)}


class GlassBlur(Transform):
    def __init__(self, sigma=0.7, max_delta=2, p=1.0):
        self.sigma = sigma
        self.max_delta = max_delta
        self.p = p

    def sample(self, rng, shape):
        return {"seed": int(rng.integers(2**31))}


class Downscale(Transform):
    def __init__(self, scale_min=0.25, scale_max=0.5, p=1.0):
        self.lo, self.hi = scale_min, scale_max
        self.p = p

    def sample(self, rng, shape):
        return {"scale": rng.uniform(self.lo, self.hi)}


class InvertImg(Transform):
    pass


class RandomBrightnessContrast(Transform):
    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, p=1.0):
        self.b, self.c = brightness_limit, contrast_limit
        self.p = p

    def sample(self, rng, shape):
        return {
            "alpha": 1 + rng.uniform(-self.c, self.c),
            "beta": rng.uniform(-self.b, self.b) * 255,
        }


class RandomGamma(Transform):
    def __init__(self, gamma_limit=(80, 120), p=0.1):
        self.lim = gamma_limit
        self.p = p

    def sample(self, rng, shape):
        return {"gamma": rng.uniform(*self.lim) / 100.0}


class HueSaturationValue(Transform):
    def __init__(self, hue=20, sat=30, val=20, p=1.0):
        self.h, self.s, self.v = hue, sat, val
        self.p = p

    def sample(self, rng, shape):
        return {
            "dh": rng.uniform(-self.h, self.h),
            "ds": rng.uniform(-self.s, self.s),
            "dv": rng.uniform(-self.v, self.v),
        }


class RGBShift(Transform):
    def __init__(self, limit=20, p=1.0):
        self.limit = limit
        self.p = p

    def sample(self, rng, shape):
        return {"shift": rng.uniform(-self.limit, self.limit, size=3)}


class FancyPCA(Transform):
    def __init__(self, alpha=0.1, p=1.0):
        self.alpha = alpha
        self.p = p

    def sample(self, rng, shape):
        return {"coeffs": rng.normal(0, self.alpha, size=3)}


class ColorJitter(Transform):
    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.02, p=1.0):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.p = p

    def sample(self, rng, shape):
        return {
            "b": 1 + rng.uniform(-self.b, self.b),
            "c": 1 + rng.uniform(-self.c, self.c),
            "s": 1 + rng.uniform(-self.s, self.s),
            "h": rng.uniform(-self.h, self.h) * 180,
        }


class ToGray(Transform):
    def __init__(self, p=0.2):
        self.p = p


class ToSepia(Transform):
    def __init__(self, p=0.05):
        self.p = p


class CLAHE(Transform):
    def __init__(self, clip_limit=4.0, p=0.05):
        self.clip = clip_limit
        self.p = p

    def sample(self, rng, shape):
        return {"clip": rng.uniform(1, self.clip)}


class CoarseDropout(Transform):
    def __init__(self, max_holes=8, max_height=8, max_width=8, p=1.0):
        self.n, self.h, self.w = max_holes, max_height, max_width
        self.p = p

    def sample(self, rng, shape):
        h, w = shape[:2]
        holes = []
        for _ in range(int(rng.integers(1, self.n + 1))):
            hh = int(rng.integers(1, self.h + 1))
            ww = int(rng.integers(1, self.w + 1))
            y = int(rng.integers(0, max(1, h - hh)))
            x = int(rng.integers(0, max(1, w - ww)))
            holes.append((y, x, hh, ww))
        return {"holes": holes}


class RandomShadow(Transform):
    def __init__(self, p=0.05):
        self.p = p

    def sample(self, rng, shape):
        h, w = shape[:2]
        pts = rng.integers(0, [w, h], size=(4, 2)).astype(np.int32)
        return {"pts": pts, "strength": rng.uniform(0.3, 0.7)}


class RandomFog(Transform):
    def sample(self, rng, shape):
        return {"coef": rng.uniform(0.1, 0.4)}


class RandomRain(Transform):
    def sample(self, rng, shape):
        h, w = shape[:2]
        n = max(1, (h * w) // 600)
        return {
            "drops": rng.integers(0, [w, h], size=(n, 2)),
            "length": int(rng.integers(5, 15)),
        }


class RandomSunFlare(Transform):
    def sample(self, rng, shape):
        h, w = shape[:2]
        return {
            "center": (int(rng.integers(0, w)), int(rng.integers(0, h // 2 + 1))),
            "radius": int(rng.integers(min(h, w) // 6 + 1, min(h, w) // 3 + 2)),
        }


# ---------------------------------------------------------------- presets
def create_train_plan(size: int, augmentation: str = "max") -> Compose:
    """The draws of ``create_train_transforms`` (deepfakes_dataset.py:57-100).
    ``"min"`` gives the light preset; any other name gives ``max``, as in
    the JAX package."""
    resize_chain = [
        OneOf(
            [
                IsotropicResize(size, INTER_AREA, INTER_CUBIC),
                IsotropicResize(size, INTER_AREA, INTER_LINEAR),
                IsotropicResize(size, INTER_LINEAR, INTER_LINEAR),
            ],
            p=1.0,
        ),
        PadIfNeeded(size, size),
        Resize(size, size),
    ]
    if augmentation == "min":
        return Compose(
            resize_chain
            + [
                ImageCompression(60, 100, p=0.2),
                GaussNoise(p=0.3),
                GaussianBlur(blur_limit=3, p=0.05),
                HorizontalFlip(p=0.5),
                OneOf([RandomBrightnessContrast(), FancyPCA(), HueSaturationValue()], p=0.4),
                ToGray(p=0.2),
                ShiftScaleRotate(0.1, 0.2, 5, p=0.5),
            ]
        )
    return Compose(
        resize_chain
        + [
            ImageCompression(60, 100, p=0.2),
            OneOf([GaussianBlur(blur_limit=3), MedianBlur(), GlassBlur(), MotionBlur()], p=0.1),
            OneOf([HorizontalFlip(p=1.0), InvertImg()], p=0.5),
            OneOf([RandomBrightnessContrast(), FancyPCA(), HueSaturationValue()], p=0.5),
            OneOf([RGBShift(), ColorJitter()], p=0.1),
            OneOf([MultiplicativeNoise(), ISONoise(), GaussNoise()], p=0.3),
            OneOf([CoarseDropout(), CoarseDropout(max_holes=4, max_height=12, max_width=12)],
                  p=0.1),
            OneOf([RandomFog(), RandomRain(), RandomSunFlare()], p=0.02),
            RandomShadow(p=0.05),
            RandomGamma(p=0.1),
            CLAHE(p=0.05),
            ToGray(p=0.2),
            ToSepia(p=0.05),
            ShiftScaleRotate(0.1, 0.2, 5, p=0.5),
        ]
    )
