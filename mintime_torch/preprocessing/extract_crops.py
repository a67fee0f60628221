"""Face-crop extraction: a video and its boxes JSON → square face crops on
disk (counterpart of ``mintime_tpu/preprocessing/extract_crops.py:25-169``).

One detection a second: the half-resolution boxes are scaled x2 back to
full resolution, each side padded by a third of the box, then squared by
trimming the long axis. Crops are written ``<frame>_<face>.png`` into one
folder a video, with a ``video_dims.json`` sidecar of the frame size, or as
one ``crops.pack`` shard (``packed=True``). cv2 (decode and PNG writes) is
imported inside the functions that need it; ``python -m
mintime_torch.preprocessing.extract_crops`` runs :func:`main`.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
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


def extract_video(
    video_path: str,
    boxes_path: str,
    output_dir: str,
    write: bool = True,
    packed: bool = False,
) -> list[tuple[int, int, np.ndarray]]:
    """About one crop set a second of ``video_path``; returns
    ``[(frame_idx, face_idx, crop)]``. ``packed=True`` writes one
    ``crops.pack`` shard (every entry's identity None: clustering has not
    run yet) in place of the PNGs."""
    import cv2

    with open(boxes_path) as f:
        boxes = json.load(f)
    capture = cv2.VideoCapture(video_path)
    fps = int(capture.get(cv2.CAP_PROP_FPS)) or 30
    frames: list[np.ndarray] = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()

    dims = None
    if frames:
        dims = {"width": frames[0].shape[1], "height": frames[0].shape[0], "fps": fps}
    out = []
    if write:
        os.makedirs(output_dir, exist_ok=True)
        if dims:
            # the frame size for the size buckets, without the original video
            with open(os.path.join(output_dir, "video_dims.json"), "w") as f:
                json.dump(dims, f)
    for i in range(0, len(frames), fps):
        det = pick_detection_frame(boxes, i, fps)
        if det is None:
            continue
        for j, bbox in enumerate(boxes[str(det)] or []):
            crop = square_crop(frames[i], bbox)
            if crop.size == 0:
                continue
            out.append((i, j, crop))
            if write and not packed:
                cv2.imwrite(os.path.join(output_dir, f"{i}_{j}.png"), crop)
    if write and packed and out:
        from mintime_torch.data.crop_store import PACK_NAME, write_pack

        write_pack(os.path.join(output_dir, PACK_NAME),
                   ((None, f, j, c) for f, j, c in out), dims=dims)
    return out


def main(argv=None):
    """Every ``.mp4`` under ``--video_path`` with a boxes JSON at the same
    relative path under ``--boxes_path`` → its crops under
    ``--output_path``; a video whose output folder holds files is skipped."""
    import argparse
    import glob

    p = argparse.ArgumentParser("mintime-torch extract_crops")
    p.add_argument("--video_path", required=True, help="root of .mp4 videos")
    p.add_argument("--boxes_path", required=True, help="root of per-video boxes json")
    p.add_argument("--output_path", required=True)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--packed", action="store_true", default=False,
                   help="write one crops.pack shard per video instead of "
                        "PNGs (see mintime_torch.data.crop_store)")
    opt = p.parse_args(argv)

    videos = sorted(glob.glob(os.path.join(opt.video_path, "**", "*.mp4"), recursive=True))

    def job(video):
        stem = os.path.splitext(os.path.relpath(video, opt.video_path))[0]
        bpath = os.path.join(opt.boxes_path, stem + ".json")
        if not os.path.exists(bpath):
            return 0
        outdir = os.path.join(opt.output_path, stem)
        if os.path.isdir(outdir) and os.listdir(outdir):
            return 0
        return len(extract_video(video, bpath, outdir, packed=opt.packed))

    with ThreadPoolExecutor(opt.workers) as pool:  # cv2 releases the GIL
        total = sum(pool.map(job, videos))
    print(f"wrote {total} crops from {len(videos)} videos")


if __name__ == "__main__":
    main()
