"""Offline feature extraction: the backbone's feature map of every crop
(counterpart of ``mintime_tpu/preprocessing/extract_features.py``).

Every face crop is resized to 224 with cv2's ``INTER_LINEAR`` (computed by
:func:`mintime_torch.data.augment.resize`, bitwise equal to
``cv2.resize``'s default, in torch on the card) and pushed through the
frozen EfficientNet-B0 in fixed-size batches (the last one padded with
zeros); each crop's ``(7, 7, 1280)`` float32 map is written as ``.npy`` in
the crop's relative layout. Raw 0..255 input by default, as training feeds
it; ``imagenet_norm`` gives the reference's offline normalisation.

The crops reach :func:`extract_features` decoded (a sequence of BGR uint8
arrays, or a function that reads one path): the file read is the CLI's,
since the card's machine has no cv2 to decode a PNG.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def read_crop(path: str, image_size: int = 224) -> np.ndarray:
    """A crop as ``cv2.imread`` gives it (BGR uint8), a black square for a
    file that does not decode, as the JAX CLI takes it."""
    import cv2

    img = cv2.imread(path)
    return np.zeros((image_size, image_size, 3), np.uint8) if img is None else img


def extract_features(
    image_paths: Sequence[str],
    model,
    output_root: str,
    input_root: str,
    crops: Sequence[np.ndarray] | Callable[[str], np.ndarray] = read_crop,
    image_size: int = 224,
    batch_size: int = 64,
    imagenet_norm: bool = False,
) -> int:
    """Write one ``.npy`` feature map a crop under ``output_root``, at the
    crop path's place relative to ``input_root``. ``model`` is an
    :class:`~mintime_torch.models.efficientnet.EfficientNet` on its device
    in its dtype; ``crops`` the decoded crops in the order of
    ``image_paths``, or a function that reads one path. Returns the number
    of files written."""
    import torch

    from mintime_torch.data.augment import resize

    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    read = crops if callable(crops) else None
    model.eval()
    n_written = 0
    for start in range(0, len(image_paths), batch_size):
        chunk = image_paths[start:start + batch_size]
        imgs = [read(p) if read else crops[start + i] for i, p in enumerate(chunk)]
        x = torch.stack([resize(torch.as_tensor(np.ascontiguousarray(img)).to(dev), image_size,
                                image_size, "linear") for img in imgs]).float()
        if imagenet_norm:
            mean, std = (torch.as_tensor(a, device=dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
            x = (x / 255.0 - mean) / std
        pad = batch_size - len(chunk)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        with torch.no_grad():
            feats = model(x.to(dtype)).float()[:len(chunk)].cpu().numpy()
        for p, f in zip(chunk, feats):
            rel = os.path.relpath(p, input_root)
            out = os.path.join(output_root, os.path.splitext(rel)[0] + ".npy")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            np.save(out, f)
            n_written += 1
    return n_written


def build_extractor(extractor_weights: str | None = None, device="cuda", dtype=None, seed: int = 0):
    """EfficientNet-B0 on ``device`` in ``dtype`` (bf16 on the card, fp32 on
    the CPU), from a reference ``Extractor_checkpoint`` state_dict when given
    (every key of the network must be there), else drawn from ``seed``."""
    import torch

    from mintime_torch.device import default_dtype, resolve_device
    from mintime_torch.models.classifier import init_weights
    from mintime_torch.models.efficientnet import EfficientNet
    from mintime_torch.utils.checkpoint import _load_torch_state_dict, _take, strip_prefixes

    dev = resolve_device(device)
    model = EfficientNet("efficientnet-b0")
    init_weights(model, torch.Generator().manual_seed(seed))
    if extractor_weights:
        sd = strip_prefixes(_load_torch_state_dict(extractor_weights),
                            ("module.", "efficient_net."))
        model.load_state_dict(_take(model.state_dict(), "", sd, extractor_weights))
    model.to(device=dev, dtype=dtype or default_dtype(dev))
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model.eval()


def main(argv=None):
    import argparse
    import glob

    p = argparse.ArgumentParser("mintime-torch extract_features")
    p.add_argument("--faces_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--extractor_weights", default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--imagenet_norm", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)

    if not opt.extractor_weights:
        print("WARNING: no --extractor_weights; random features (structural run)")
    model = build_extractor(opt.extractor_weights, device=opt.device)
    paths = sorted(glob.glob(os.path.join(opt.faces_path, "**", "*.png"), recursive=True))
    n = extract_features(paths, model, opt.output_path, opt.faces_path,
                         batch_size=opt.batch_size, imagenet_norm=opt.imagenet_norm)
    print(f"wrote {n} feature files")
    return n


if __name__ == "__main__":
    main()
