"""The evaluation transform (copy of ``Compose``, ``IsotropicResize``,
``PadIfNeeded``, ``Resize`` and ``create_val_transform`` from
``mintime_tpu/data/augment.py:80-184,763-771``).

``cv2`` is imported only where a frame actually has to be resized or padded,
so a crop that is already ``size`` square passes through without it.
Images stay uint8 0..255. The evaluation path draws nothing at random, so
the random-application machinery of the training augmentations is left out.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Transform:
    def apply(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_batch(self, stack: np.ndarray) -> np.ndarray:
        """Apply to a stacked ``(F, H, W, 3)`` array of same-size frames."""
        return np.stack([self.apply(f) for f in stack])

    def __call__(self, frames):
        if isinstance(frames, np.ndarray):
            return self.apply_batch(frames)
        return [self.apply(f) for f in frames]


def _stack_if_uniform(frames):
    """List of same-shaped frames → one contiguous (F, H, W, 3) stack."""
    if isinstance(frames, np.ndarray) or not frames:
        return frames
    shape = frames[0].shape
    if all(f.shape == shape for f in frames):
        return np.stack(frames)
    return frames


class Compose(Transform):
    """Sequential combinator; the result is stacked once at the end."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, frames):
        for t in self.transforms:
            frames = t(frames)
        return _stack_if_uniform(frames)


class IsotropicResize(Transform):
    """Aspect-preserving resize to ``max_side``: cv2's INTER_AREA down,
    INTER_CUBIC up (the evaluation path's defaults)."""

    def __init__(self, max_side):
        self.max_side = max_side

    def apply(self, img):
        h, w = img.shape[:2]
        if max(h, w) == self.max_side:
            return img
        import cv2

        scale = self.max_side / max(h, w)
        interp = cv2.INTER_CUBIC if scale > 1 else cv2.INTER_AREA
        nh, nw = int(round(h * scale)), int(round(w * scale))
        return cv2.resize(img, (nw, nh), interpolation=interp)

    def apply_batch(self, stack):
        if max(stack.shape[1:3]) == self.max_side:
            return stack
        return np.stack([self.apply(f) for f in stack])


class PadIfNeeded(Transform):
    """Center-pad to at least (min_h, min_w) with constant black borders."""

    def __init__(self, min_height, min_width):
        self.min_h = min_height
        self.min_w = min_width

    def apply(self, img):
        h, w = img.shape[:2]
        ph, pw = max(0, self.min_h - h), max(0, self.min_w - w)
        if ph == 0 and pw == 0:
            return img
        import cv2

        top, left = ph // 2, pw // 2
        return cv2.copyMakeBorder(
            img, top, ph - top, left, pw - left, cv2.BORDER_CONSTANT, value=0
        )

    def apply_batch(self, stack):
        h, w = stack.shape[1:3]
        ph, pw = max(0, self.min_h - h), max(0, self.min_w - w)
        if ph == 0 and pw == 0:
            return stack
        top, left = ph // 2, pw // 2
        return np.pad(stack, ((0, 0), (top, ph - top), (left, pw - left), (0, 0)))


class Resize(Transform):
    def __init__(self, height, width):
        self.h, self.w = height, width

    def apply(self, img):
        if img.shape[:2] == (self.h, self.w):
            return img
        import cv2

        return cv2.resize(img, (self.w, self.h), interpolation=cv2.INTER_LINEAR)

    def apply_batch(self, stack):
        if stack.shape[1:3] == (self.h, self.w):
            return stack
        return np.stack([self.apply(f) for f in stack])


def create_val_transform(size: int) -> Compose:
    """IsotropicResize → PadIfNeeded → Resize, the evaluation path."""
    return Compose([IsotropicResize(size), PadIfNeeded(size, size), Resize(size, size)])
