"""Face-crop geometry (copy of ``square_crop`` and ``pick_detection_frame``
from ``mintime_tpu/preprocessing/extract_crops.py:25-66``)."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def square_crop(frame: np.ndarray, bbox_half_res: Sequence[float]) -> np.ndarray:
    """Crop one face: the half-res box scaled x2, each side padded by a third
    of the box, then squared by trimming the long axis."""
    xmin, ymin, xmax, ymax = [int(b * 2) for b in bbox_half_res]
    w = xmax - xmin
    h = ymax - ymin
    p_h = h // 3
    p_w = w // 3
    crop_h = (ymax + p_h) - max(ymin - p_h, 0)
    crop_w = (xmax + p_w) - max(xmin - p_w, 0)
    if crop_h > crop_w:
        p_h -= int((crop_h - crop_w) / 2)
    else:
        p_w -= int((crop_w - crop_h) / 2)
    crop = frame[max(ymin - p_h, 0) : ymax + p_h, max(xmin - p_w, 0) : xmax + p_w]
    h, w = crop.shape[:2]
    if h > w:
        diff = int((h - w) / 2)
        crop = crop[diff:-diff, :] if diff > 0 else crop[1:, :]
    elif h < w:
        diff = int((w - h) / 2)
        crop = crop[:, diff:-diff] if diff > 0 else crop[:, :-1]
    return crop


def pick_detection_frame(
    boxes: Mapping[str, list | None], second_start: int, fps: int
) -> int | None:
    """First frame in (start, start+fps-1), exclusive of both ends, with
    detections (the reference's index walk never yields the window's last
    index)."""
    limit = second_start + fps - 1
    index = second_start
    keys = {int(k) for k in boxes}
    while index + 1 < limit:
        index += 1
        if index in keys and boxes[str(index)] is not None:
            return index
    return None
