"""Day-one verification of real published weights (counterpart of
``mintime_tpu/verify_weights.py``).

The published files (facenet-pytorch's MTCNN ``pnet/rnet/onet.pt`` and
vggface2 ``InceptionResnetV1``, the MINTIME zoo
``Model_checkpoint*``/``Extractor_checkpoint*``, pytorchvideo's
``slowfast_r50``) are not in the repository. This CLI makes loading them a
one-command check the day they are: each file loads strictly into the port's
module (unknown or missing keys raise), a forward pass checks each model's
outputs are finite, and, given an example video, the whole predict pipeline
runs end to end (the decode needs cv2: on the CPU only).

Usage (any subset of flags; each is verified independently)::

    python -m mintime_torch.verify_weights \\
        --mtcnn_weights weights/mtcnn/ \\
        --facenet_weights weights/vggface2.pt \\
        --model_weights weights/Model_checkpoint_XC \\
        --extractor_weights weights/Extractor_checkpoint_XC --extractor_model 1 \\
        --slowfast_weights weights/SLOWFAST_8x8_R50.pyth \\
        [--video example.mp4 --device cpu]

Exit code 0: every requested file loaded strictly and gave finite outputs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _ok(name, detail=""):
    print(f"[ OK ] {name}" + (f" — {detail}" if detail else ""))


def _section(name):
    print(f"\n=== {name}")


def verify_mtcnn(weights_dir: str, video: str | None, device="cuda") -> dict:
    import torch

    from mintime_torch.preprocessing.mtcnn import NETS, MTCNNDetector

    _section("MTCNN cascade (facenet-pytorch pnet/rnet/onet.pt)")
    sds = {name: torch.load(os.path.join(weights_dir, f"{name}.pt"), map_location="cpu")
           for name in NETS}
    det = MTCNNDetector(sds, device=device)  # strict load_state_dict of each net
    _ok("converter", f"{sum(len(s) for s in sds.values())} torch tensors loaded strictly")
    if video:
        from mintime_torch.preprocessing.detect_faces import decode_half_res

        frames, fps = decode_half_res(video)
        boxes = det.detect_batch(frames[: min(len(frames), 30)])
        n = sum(len(b) for b in boxes)
        assert n > 0, "real MTCNN weights should detect faces in the example"
        _ok("detection", f"{n} boxes over {len(boxes)} half-res frames")
    else:
        rng = np.random.default_rng(0)
        det.detect_batch([rng.integers(0, 255, (180, 320, 3), dtype=np.uint8)])
        _ok("forward", "cascade ran on a synthetic frame")
    return {"detector": det}


def verify_facenet(path: str, device="cuda") -> dict:
    import torch

    from mintime_torch.preprocessing.cluster_faces import FaceEmbedder

    _section("InceptionResnetV1 vggface2 embedder")
    sd = torch.load(path, map_location="cpu")
    emb = FaceEmbedder(sd, device=device)  # strict, the logits head dropped by name
    _ok("converter", f"{len(sd)} torch tensors loaded strictly")
    rng = np.random.default_rng(0)
    out = emb([rng.integers(0, 255, (160, 160, 3), dtype=np.uint8)])
    assert np.isfinite(out).all()
    # facenet-pytorch L2-normalizes its output embedding
    _ok("forward", f"embedding norm {float(np.linalg.norm(out[0])):.4f} (expect ~1)")
    return {"embedder": emb}


def verify_classifier(model_weights: str, extractor_weights: str | None, config: str,
                      extractor_model: int, device="cuda", cfg=None) -> dict:
    """The zoo checkpoint through the predict CLI's model: fp32 parameters
    computing in bf16 with the kernels, its attention maps on. ``cfg``
    stands in for the ``config`` file."""
    import torch

    from mintime_torch.config import load_config
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.utils.checkpoint import load_model_state

    _section("MINTIME zoo checkpoint (Model/Extractor)")
    cfg = cfg if cfg is not None else load_config(config)
    backbone = "efficientnet-b0" if extractor_model == 0 else "xception"
    model = MintimeVideoClassifier(cfg.model, backbone=backbone, head="timesformer",
                                   require_attention=True, use_kernels=True, device=device,
                                   dtype=torch.bfloat16, param_dtype=torch.float32)
    model.load_state_dict(load_model_state(model, cfg, model_weights, extractor_weights))
    _ok("converter", f"{backbone} + timesformer state loaded strictly")
    m = cfg.model
    B, F = 1, m.num_frames
    dev = model.device
    inputs = (torch.full((B, F, m.image_size, m.image_size, 3), 128.0),
              torch.ones((B, F), dtype=torch.bool), torch.ones((B, F, F), dtype=torch.bool),
              torch.ones((B, F), dtype=torch.int32),
              (torch.arange(1 + F * m.num_patches, dtype=torch.int32) % (F * m.num_patches))[None])
    with torch.inference_mode():
        logits, _ = model(*(t.to(dev) for t in inputs))
    val = float(logits[0, 0])
    assert np.isfinite(val)
    _ok("forward", f"logit on a gray sequence: {val:+.4f}")
    return {"model": model, "cfg": cfg, "logit": val}


def verify_slowfast(path: str, device="cuda") -> dict:
    import torch

    from mintime_torch.models.slowfast import SlowFastClassifier
    from mintime_torch.utils.checkpoint import _load_torch_state_dict, _slowfast_state

    _section("SlowFast R-50 (pytorchvideo checkpoint)")
    obj = _load_torch_state_dict(path)
    sd = obj.get("model_state", obj)
    # head size follows the checkpoint: kinetics hub weights carry a
    # 400-way proj the reference replaces with Linear(2304, 1)
    num_classes = int(next(v for k, v in sd.items() if k.endswith("proj.weight")).shape[0])
    net = SlowFastClassifier(num_classes=num_classes, device=device)
    net.load_state_dict(_slowfast_state(net.state_dict(), sd, path))  # unknown or missing raise
    _ok("converter", f"{len(sd)} torch tensors loaded (strict, all consumed)")
    with torch.inference_mode():
        out = net.blocks(torch.zeros((1, 2, 32, 32, 3), dtype=net.dtype, device=net.device),
                         torch.zeros((1, 8, 32, 32, 3), dtype=net.dtype, device=net.device))
    assert torch.isfinite(out).all()
    _ok("forward", f"logits shape {tuple(out.shape)}")
    return {"slowfast": net}


def main(argv=None, config=None) -> int:
    """The CLI; ``config`` stands in for the ``--config`` file, for a caller
    without yaml. Returns the exit code (0: every requested file verified)."""
    p = argparse.ArgumentParser("mintime-torch verify_weights")
    p.add_argument("--mtcnn_weights", default=None,
                   help="dir with pnet.pt / rnet.pt / onet.pt")
    p.add_argument("--facenet_weights", default=None,
                   help="InceptionResnetV1 vggface2 state_dict (.pt)")
    p.add_argument("--model_weights", default=None,
                   help="reference Model_checkpoint* (torch) or the port's checkpoint")
    p.add_argument("--extractor_weights", default=None)
    p.add_argument("--extractor_model", type=int, default=0)
    p.add_argument("--slowfast_weights", default=None)
    p.add_argument("--config", default="configs/size_invariant_timesformer.yaml")
    p.add_argument("--video", default=None,
                   help="optional example .mp4: runs the FULL predict pipeline when "
                        "mtcnn+facenet+model weights are given (cv2's decode: the CPU only)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    opt = p.parse_args(argv)
    if not any((opt.mtcnn_weights, opt.facenet_weights, opt.model_weights,
                opt.slowfast_weights)):
        p.error("nothing to verify: pass at least one weights flag")

    from mintime_torch.device import resolve_device

    dev = resolve_device(opt.device)
    parts = {}
    if opt.mtcnn_weights:
        parts.update(verify_mtcnn(opt.mtcnn_weights, opt.video, dev))
    if opt.facenet_weights:
        parts.update(verify_facenet(opt.facenet_weights, dev))
    if opt.model_weights:
        parts.update(verify_classifier(opt.model_weights, opt.extractor_weights, opt.config,
                                       opt.extractor_model, dev, cfg=config))
    if opt.slowfast_weights:
        verify_slowfast(opt.slowfast_weights, dev)

    if opt.video and {"detector", "embedder", "model"} <= parts.keys():
        from mintime_torch.predict import predict_video

        _section("end-to-end predict on " + os.path.basename(opt.video))
        result = predict_video(opt.video, parts["model"], None, parts["cfg"],
                               parts["detector"], parts["embedder"])
        _ok("predict", f"fake probability {result.probability:.4f}, "
                       f"{len(result.identities)} identities, "
                       f"attention {result.identity_attentions}")
    print("\nall requested artifacts verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
