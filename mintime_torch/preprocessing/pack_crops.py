"""Pack a faces tree into one ``crops.pack`` shard a video (copy of
``mintime_tpu/preprocessing/pack_crops.py:24-73``).

Run after detection, extraction and clustering: each video's PNG folder
(identity subfolders and loose crops) becomes one shard in the format of
:mod:`mintime_torch.data.crop_store`, which the dataset then reads with no
image decode and no directory walk. Identity names and loose crops are kept
in the pack's header, so packed and unpacked trees give the same samples.
``--remove_images`` deletes the PNGs after packing; by default both stay
and the pack wins. ``python -m mintime_torch.preprocessing.pack_crops``
runs :func:`main`.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor


def iter_video_dirs(faces_root: str):
    """Every folder that holds crops itself or in identity subfolders: the
    dataset's video folders at any depth
    (``faces/<split>/<class>/<video>/<identity_k>/*.png``)."""
    from mintime_torch.data.dataset import _CROP_EXTS

    for dirpath, dirnames, filenames in os.walk(faces_root):
        has_crops = any(f.lower().endswith(_CROP_EXTS) for f in filenames)
        child_has_crops = False
        for d in dirnames:
            try:
                child = os.listdir(os.path.join(dirpath, d))
            except OSError:
                continue
            if any(f.lower().endswith(_CROP_EXTS) for f in child) and not any(
                os.path.isdir(os.path.join(dirpath, d, f)) for f in child
            ):
                child_has_crops = True
        if child_has_crops or (has_crops and not dirnames):
            yield dirpath
            dirnames[:] = []  # don't descend into identity folders


def main(argv=None):
    import argparse

    from mintime_torch.data.crop_store import pack_video_dir

    p = argparse.ArgumentParser("mintime-torch pack_crops")
    p.add_argument("--faces_dir", required=True,
                   help="root of the clustered faces tree to pack")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--remove_images", action="store_true", default=False,
                   help="delete the source PNGs after packing")
    opt = p.parse_args(argv)

    dirs = list(iter_video_dirs(opt.faces_dir))
    with ThreadPoolExecutor(max(1, opt.workers)) as pool:
        done = sum(1 for r in pool.map(
            lambda d: pack_video_dir(d, remove_images=opt.remove_images), dirs) if r)
    print(f"packed {done}/{len(dirs)} video folders under {opt.faces_dir}")


if __name__ == "__main__":
    main()
