"""Face-detection driver: videos → per-video boxes JSON (counterpart of
``mintime_tpu/preprocessing/detect_faces.py``).

Every frame is decoded and halved (the reference's ``face_detector.py:78``),
the MTCNN cascade runs on it, and ``<output_root>/<rel>.json`` holds
``{frame_idx: [[x1, y1, x2, y2], ...] | null}`` in half-resolution
coordinates, with a ``<rel>.dims.json`` sidecar of the original width,
height and fps. A video whose JSON exists is skipped; videos where no frame
had a face are reported as missed.

:func:`process_videos` overlaps three stages across consecutive videos: the
decode of the next videos, the detector's stage 1 on the device for video
i + 1 (:meth:`MTCNNDetector.detect_videos_iter`'s one video of lookahead)
and the host's finish and JSON for video i. ``decode_workers > 0`` decodes in
**spawned** processes (the parent holds a live CUDA context, which a forked
child must not inherit), which hand their frames over in shared memory.

cv2 and torch are imported inside the functions that need them; a decode
worker never touches CUDA.
"""

from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

CHANNEL_ORDERS = ("rgb", "bgr")


def _validate_channel_order(channel_order: str) -> None:
    if channel_order not in CHANNEL_ORDERS:
        raise ValueError(f"channel_order must be 'rgb' or 'bgr', got {channel_order!r}")


def _open(video_path: str):
    """``(capture, fps, dims)`` of a video: fps 30 where the container has none."""
    import cv2

    capture = cv2.VideoCapture(video_path)
    fps = int(capture.get(cv2.CAP_PROP_FPS)) or 30
    dims = {"width": int(capture.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT)), "fps": fps}
    return capture, fps, dims


def _half(frame: np.ndarray, channel_order: str) -> np.ndarray:
    import cv2

    frame = cv2.resize(frame, (frame.shape[1] // 2, frame.shape[0] // 2))
    return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB) if channel_order == "rgb" else frame


def decode_half_res(video_path: str, channel_order: str = "rgb", with_dims: bool = False):
    """All frames at half resolution (RGB, or BGR for a detector that swaps
    on the device); ``with_dims`` also returns the original-resolution dims."""
    _validate_channel_order(channel_order)
    capture, fps, dims = _open(video_path)
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(_half(frame, channel_order))
    capture.release()
    return (frames, fps, dims) if with_dims else (frames, fps)


def detect_video(video_path: str, detector, every_n: int = 1) -> dict:
    """The cascade over every ``every_n``-th frame of one video → boxes dict."""
    frames, _ = decode_half_res(video_path, channel_order=getattr(detector, "channel_order", "rgb"))
    indices = list(range(0, len(frames), every_n))
    per_frame = detector.detect_batch([frames[i] for i in indices])
    return {str(i): b[:, :4].tolist() if len(b) else None for i, b in zip(indices, per_frame)}


def _decode_to_shm(path: str, channel_order: str):
    """Decode-worker body: the half-resolution frames land in a POSIX
    shared-memory block, so the hand-off to the parent copies nothing.

    Returns ``(shm_name | None, shape, fps, dims, frames | None)``; the
    frames come pickled instead when the container's frame count undershoots
    the stream or no shared memory is left."""
    import cv2
    from multiprocessing import resource_tracker, shared_memory

    _validate_channel_order(channel_order)
    capture, fps, dims = _open(path)
    n_est = max(int(capture.get(cv2.CAP_PROP_FRAME_COUNT)), 0) + 8
    h2, w2 = dims["height"] // 2, dims["width"] // 2
    shm = buf = None
    tried_alloc = False
    overflow: list = []
    t = 0
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frame = _half(frame, channel_order)
        if not tried_alloc:
            tried_alloc = True
            h2, w2 = frame.shape[:2]  # the decoded size is authoritative
            try:
                shm = shared_memory.SharedMemory(create=True, size=max(n_est, 1) * h2 * w2 * 3)
                buf = np.ndarray((n_est, h2, w2, 3), np.uint8, buffer=shm.buf)
            except OSError:
                pass  # no room in /dev/shm: pickle the frames
        # once a frame overflows, all later ones do, so the order holds
        if buf is not None and not overflow and t < n_est and frame.shape[:2] == (h2, w2):
            buf[t] = frame
        else:
            overflow.append(frame)
        t += 1
    capture.release()
    if overflow or shm is None:
        in_buf = 0 if buf is None else t - len(overflow)
        frames = [np.array(buf[i]) for i in range(in_buf)] + overflow
        if shm is not None:
            buf = None
            shm.close()
            shm.unlink()  # also unregisters it, pairing with create
        return None, (len(frames), h2, w2, 3), fps, dims, frames
    # the parent owns the segment from here and unlinks it after detection:
    # unregister it, so this worker's exit does not unlink it
    resource_tracker.unregister(shm._name, "shared_memory")
    buf = None
    shm.close()
    return shm.name, (t, h2, w2, 3), fps, dims, None


def _unlink_shm(name: str) -> None:
    from multiprocessing import shared_memory

    try:
        s = shared_memory.SharedMemory(name=name)
        s.close()
        s.unlink()
    except FileNotFoundError:
        pass


def process_videos(videos: Sequence[str], video_root: str, output_root: str, detector,
                   every_n: int = 1, decode_workers: int = 0) -> list[str]:
    """Detect faces in each video, writing ``<output_root>/<rel>.json`` and
    its ``.dims.json``; returns the videos with no detection (the miss
    report). ``decode_workers=0`` decodes on one thread; ``N > 0`` in N
    spawned processes, at most ``N + 1`` videos in flight."""
    channel_order = getattr(detector, "channel_order", "rgb")
    todo = []
    for video in videos:
        rel = os.path.relpath(video, video_root)
        out_path = os.path.join(output_root, os.path.splitext(rel)[0] + ".json")
        if not os.path.exists(out_path):
            todo.append((video, out_path))

    if decode_workers > 0:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        decode_pool = ProcessPoolExecutor(max_workers=decode_workers,
                                          mp_context=mp.get_context("spawn"))
        lookahead = decode_workers + 1

        def decode(path):
            return decode_pool.submit(_decode_to_shm, path, channel_order)

        def consume(fut):
            from multiprocessing import shared_memory

            name, shape, _, dims, frames = fut.result()
            if name is None:
                return frames, dims, None
            shm = shared_memory.SharedMemory(name=name)
            arr = np.ndarray(shape, np.uint8, buffer=shm.buf)
            frames = [arr[i] for i in range(shape[0])]

            def cleanup():
                # views of the last video may still be alive: close() then
                # raises BufferError, and the unlinked segment is freed when
                # its last mapping goes
                try:
                    shm.close()
                except BufferError:
                    pass
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass

            return frames, dims, cleanup
    else:
        decode_pool = ThreadPoolExecutor(max_workers=1)
        lookahead = 2

        def decode(path):
            return decode_pool.submit(
                lambda: decode_half_res(path, channel_order=channel_order, with_dims=True))

        def consume(fut):
            frames, _, dims = fut.result()
            return frames, dims, None

    missed: list[str] = []
    in_flight: deque = deque()
    cleanups: dict[int, object] = {}
    try:
        dims_by_index: dict[int, dict] = {}
        indices_by_video: list[list[int]] = []

        def frame_lists():
            nxt = 0

            def submit():
                nonlocal nxt
                if nxt < len(todo):
                    in_flight.append(decode(todo[nxt][0]))
                    nxt += 1

            for _ in range(lookahead):
                submit()
            i = 0
            while in_flight:
                frames, dims, cleanup = consume(in_flight.popleft())
                submit()
                dims_by_index[i] = dims
                if cleanup is not None:
                    cleanups[i] = cleanup
                idx = list(range(0, len(frames), every_n))
                indices_by_video.append(idx)
                yield [frames[j] for j in idx]
                i += 1

        for i, per_frame in enumerate(detector.detect_videos_iter(frame_lists())):
            video, out_path = todo[i]
            boxes = {str(j): b[:, :4].tolist() if len(b) else None
                     for j, b in zip(indices_by_video[i], per_frame)}
            if not any(v for v in boxes.values()):
                missed.append(video)
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(boxes, f)
            with open(os.path.splitext(out_path)[0] + ".dims.json", "w") as f:
                json.dump(dims_by_index.pop(i), f)
            # video i's results are numpy now: its block can go, while video
            # i + 1's frames are still in the detector's lookahead
            cleanup = cleanups.pop(i, None)
            if cleanup is not None:
                cleanup()
    finally:
        for cleanup in cleanups.values():  # error paths leak nothing
            cleanup()
        # videos decoded but never consumed: their blocks are ours to unlink
        while in_flight:
            fut = in_flight.popleft()
            try:
                res = fut.result()
            except Exception:
                continue
            if decode_workers > 0 and res[0] is not None:
                _unlink_shm(res[0])
        decode_pool.shutdown(wait=True)
    return missed


def main(argv=None):
    import argparse
    import glob

    import torch

    from mintime_torch.preprocessing.mtcnn import NETS, MTCNNDetector

    p = argparse.ArgumentParser("mintime-torch detect_faces")
    p.add_argument("--video_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--mtcnn_weights", default=None,
                   help="dir with pnet.pt/rnet.pt/onet.pt (facenet-pytorch)")
    p.add_argument("--every_n", type=int, default=1)
    p.add_argument("--decode_workers", type=int, default=0,
                   help="decode processes (0 = one decode thread; use ~cores/4 on multi-core "
                        "hosts)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)

    if opt.mtcnn_weights:
        state_dicts = {name: torch.load(os.path.join(opt.mtcnn_weights, f"{name}.pt"),
                                        map_location="cpu") for name in NETS}
    else:
        print("WARNING: no --mtcnn_weights; using random cascade (structural run)")
        state_dicts = MTCNNDetector.init_state_dicts()
    # the decode feeds the detector raw BGR; the swap happens on the device
    detector = MTCNNDetector(state_dicts, channel_order="bgr", device=opt.device)

    videos = sorted(glob.glob(os.path.join(opt.video_path, "**", "*.mp4"), recursive=True))
    missed = process_videos(videos, opt.video_path, opt.output_path, detector, opt.every_n,
                            decode_workers=opt.decode_workers)
    print(f"processed {len(videos)} videos; {len(missed)} with no detections")
    for m in missed:
        print("missed:", m)


if __name__ == "__main__":
    main()
