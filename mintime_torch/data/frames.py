"""Frame-level dataset of extractor pretraining (counterpart of
``mintime_tpu/pretrain_extractor.py:158-188``): one face crop an item.

As :class:`~mintime_torch.data.dataset.DeepfakesDataset` does, an item is
made in two steps: :meth:`FramesDataset.load` (the crop's read and, in mode
``"train"``, the augmentation's draws from
:mod:`mintime_torch.data.augment_plan`; numpy only, in a loader's workers)
and :meth:`FramesDataset.transform_crops` (the drawn augmentation, or the
evaluation transform, in torch on the dataset's device). A frame is a
one-frame stack. The item's generator is ``np.random.default_rng((seed,
index))``, with no epoch, as in the JAX package: a frame gets the same
augmentation in every epoch.

A crop path names a PNG, or an entry of its video's ``crops.pack``
(``<video>/<identity>/<frame>_<face>.png`` rebuilt from the pack's header,
:func:`pack_crop_names`), which needs no cv2: the card's machine has none.
The module imports torch only inside the transform.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Sequence

import numpy as np

from mintime_torch.data.augment_plan import create_train_plan
from mintime_torch.data.crop_store import CropPack, find_pack

if TYPE_CHECKING:
    import torch


def pack_crop_names(pack: CropPack) -> list[str]:
    """The crop file names a pack's entries stand for, relative to its
    video folder: ``<identity>/<frame>_<face>.png``, or ``<frame>_<face>.png``
    for a loose crop; in entry order."""
    return [f"{frame}_{face}.png" if ident is None else f"{ident}/{frame}_{face}.png"
            for ident, frame, face, *_ in pack.entries]


class FramesDataset:
    """Frame-level dataset over face-crop paths: ``dataset[i]`` is
    ``{"frames": (S, S, 3) uint8 tensor on device, "labels": float32}``.
    ``mode="train"`` draws the ``augmentation`` preset, else the evaluation
    transform. ``device`` (default the card) is kept as a string, so that
    the dataset unpickles without torch in a spawned worker."""

    def __init__(self, paths, labels, image_size: int, mode: str = "train",
                 augmentation: str = "min", seed: int = 42,
                 device: str | torch.device = "cuda"):
        self.paths = list(paths)
        self.labels = list(labels)
        self.image_size = image_size
        self.mode = mode
        self.seed = seed
        self.device = str(device)
        self.train_plan = create_train_plan(image_size, augmentation) if mode == "train" else None
        self._packs: dict[str, tuple[CropPack, dict[str, int]]] = {}

    def __len__(self):
        return len(self.paths)

    def _pack_entry(self, path: str):
        """(pack, entry index) of a crop path whose video folder holds a
        ``crops.pack`` naming it, else None."""
        for vdir in (os.path.dirname(path), os.path.dirname(os.path.dirname(path))):
            if vdir not in self._packs:
                pack_path = find_pack(vdir)
                if pack_path is None:
                    continue
                pack = CropPack(pack_path)
                self._packs[vdir] = (pack, {n: i for i, n in enumerate(pack_crop_names(pack))})
            pack, names = self._packs[vdir]
            i = names.get(os.path.relpath(path, vdir))
            if i is not None:
                return pack, i
        return None

    def read(self, index: int) -> np.ndarray:
        """The crop, BGR uint8, from its video's pack or its PNG."""
        path = self.paths[index]
        entry = self._pack_entry(path)
        if entry is not None:
            return entry[0].read(entry[1])
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def load(self, index: int) -> dict:
        """The item with ``crops`` (the one crop) in place of ``frames`` and,
        in mode ``"train"``, ``steps``, its drawn augmentation: no torch."""
        img = self.read(index)
        sample = {"crops": [img], "labels": np.float32(self.labels[index])}
        if self.train_plan is not None:
            rng = np.random.default_rng((self.seed, index))
            sample["steps"] = self.train_plan([img.shape], rng)
        return sample

    def transform_crops(self, crops: Sequence[Sequence[np.ndarray]],
                        steps: Sequence[list] | None = None) -> torch.Tensor:
        """``B`` items' crops → ``(B, S, S, 3)`` uint8 on the dataset's device."""
        import torch

        from mintime_torch.data.augment import create_val_transform, train_transform

        if self.train_plan is None:
            return create_val_transform(self.image_size)([c[0] for c in crops], self.device)
        if steps is None or len(steps) != len(crops):
            raise ValueError("mode 'train' needs each item's drawn steps (load()['steps'])")
        return torch.cat([train_transform(c, s, self.device) for c, s in zip(crops, steps)])

    def __getitem__(self, index: int) -> dict:
        sample = self.load(index)
        steps = [sample.pop("steps")] if "steps" in sample else None
        sample["frames"] = self.transform_crops([sample.pop("crops")], steps)[0]
        return sample
