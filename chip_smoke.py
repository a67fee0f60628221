#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``mintime_torch``) runs on an NVIDIA
GPU: ``python3 chip_smoke.py`` from the root of a checkout, on a machine with
one card. It builds the CUDA kernels itself.

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device and build: the card, its power limit, torch and CUDA versions, the
   seconds ``nvcc`` took for ``mintime_torch/csrc/*.cu``;
2. kernels: every kernel of the serving path against its plain PyTorch
   version on the card in bf16 at the flagship shapes (max abs error <= 2e-2),
   with its time, the plain version's time and the card's bound for the work;
   the divided attention is also timed as one dense masked
   ``scaled_dot_product_attention`` call (a yardstick the port never calls);
3. slice: the flagship EfficientNet-B0 + Size-Invariant TimeSformer at full
   width (224 px, 1280 channels, dim 512, depth 9, 8 x 64 heads, F = 16,
   n = 49, two identities), seeded random weights, through the port's
   ``crops_from_frames → cluster_crops → assemble_inputs → predict_assembled``
   (forward + ``aggregate_attentions``) for 8 synthetic in-memory videos at
   batch 8. The launch counters must show 16 attention and 18 FFN kernel
   launches for that forward; kernel-mode logits must match plain-mode logits
   within 2e-2 on the card and a CPU fp32 run of the same weights within
   5e-2; throughput at batch 8 and latency at batch 1 are printed;
4. profile: one forward at batch 8 and at batch 1 under ``torch.profiler``:
   the device's busy and idle share of the host window, device time by
   layer (cuDNN convolutions, cuBLAS matmuls, the two kernels, copies, the rest)
   and the top kernels.

The line before the last holds ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
TOL = 2e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call, by CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def phase_device():
    import torch

    from mintime_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_s = _build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in _build.BUILD_LOG.items()}
    emit({"phase": "device", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "build_s": build_s, "ptxas": ptxas})
    return smi


def _attention_inputs(axis, gen, B=8, F=16, n=49, H=8, dh=64):
    """Flagship qkv for one axis with invalid frames and two identities."""
    import torch

    from mintime_torch.ops.attention import build_frame_mask
    from mintime_torch.ops.divided_attention import mask_to_bias

    inner = H * dh
    qkv = torch.randn(B, F, n, 3 * inner, generator=gen).cuda().bfloat16()
    qkvc = torch.randn(B, 1, 3 * inner, generator=gen).cuda().bfloat16()
    mask = torch.ones(B, F, dtype=torch.bool)
    mask[1, 10:] = False
    mask[5, 4:] = False
    ids = torch.ones(B, F, F, dtype=torch.bool)
    ids[:, :8, 8:] = False
    ids[:, 8:, :8] = False
    rb = mask_to_bias(mask.cuda())
    if axis == "time":
        return (qkv.transpose(1, 2), qkvc, mask_to_bias(build_frame_mask(mask, ids).cuda()),
                rb[:, None, :])
    return qkv, qkvc, None, rb[:, :, None]


def _as_one_attention(qkv, qkvc, sb, rbias, H, dh):
    """The same divided attention as one dense attention over the CLS row and
    all G*L tokens: q, k, v (B, H, 1+G*L, dh), CLS first, and a boolean mask
    (B, 1, N, N) that keeps each token to the CLS key and its own group (and
    ``seq_bias``) and the CLS row to every key its ``row_bias`` allows. Built
    outside the timed call; the port never calls it."""
    import torch

    from mintime_torch.ops.divided_attention import NEG

    B, G, L, _ = qkv.shape
    N, dev = 1 + G * L, qkv.device
    t = qkv.unflatten(-1, (3, H, dh))
    tc = qkvc[:, 0].unflatten(-1, (3, H, dh))
    q, k, v = (torch.cat([tc[:, i, :, None], t[..., i, :, :].reshape(B, G * L, H, dh)
                          .transpose(1, 2)], dim=2).contiguous() for i in range(3))
    pos = torch.arange(G * L, device=dev)
    tok = (pos[:, None] // L == pos[None, :] // L).expand(B, G * L, G * L)
    if sb is not None:
        keep = sb > NEG / 2  # (B, L, 1+L), column 0 the CLS key
        tok = tok & keep[:, pos % L][:, :, 1 + pos % L]
    mask = torch.zeros(B, N, N, dtype=torch.bool, device=dev)
    mask[:, 0, 0] = True
    mask[:, 0, 1:] = (rbias.expand(B, G, L) > NEG / 2).reshape(B, G * L)
    mask[:, 1:, 0] = True if sb is None else sb[:, pos % L, 0] > NEG / 2
    mask[:, 1:, 1:] = tok
    return q, k, v, mask[:, None]


def _split_one_attention(o, G, L):
    """(B, H, 1+G*L, dh) → (tokens (B, G, L, H*dh), CLS (B, 1, H*dh))."""
    B, H, _, dh = o.shape
    return (o[:, :, 1:].transpose(1, 2).reshape(B, G, L, H * dh),
            o[:, :, 0].reshape(B, 1, H * dh))


def phase_kernels(smi):
    """Each kernel vs its plain version at the flagship shapes."""
    import torch
    import torch.nn.functional as F

    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import geglu_ffn as ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    rows = {"geglu_ffn": [], "divided_attention": []}

    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    w0, b0, w1, b1 = r(4096, 512, sc=0.044), r(4096, sc=0.02), r(512, 2048, sc=0.022), r(512, sc=0.02)
    # (M, calls per forward): the token rows and the CLS rows of 8 videos
    for m, calls in ((8 * 16 * 49, 9), (8, 9)):
        x = r(m, 512)
        args = (x, w0, b0, w1, b1)
        err = max_err(ffn.geglu_ffn_cuda(*args), ffn.geglu_ffn_plain(*args))
        nbytes = 2 * (2 * m * 512 + w0.numel() + b0.numel() + w1.numel() + b1.numel())
        flops = 2 * m * (512 * 4096 + 2048 * 512)
        b_ms, b_by = bound(nbytes, flops)
        rows["geglu_ffn"].append({
            "shape": f"M={m}", "calls": calls, "max_abs_err": err,
            "ms": time_ms(lambda: ffn.geglu_ffn_cuda(*args)),
            "plain_ms": time_ms(lambda: ffn.geglu_ffn_plain(*args)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })

    H, dh = 8, 64
    for axis, calls in (("time", 8), ("space", 8)):
        qkv, qkvc, sb, rbias = _attention_inputs(axis, gen)
        B, G, L, c3 = qkv.shape
        kw = dict(heads=H, dim_head=dh)
        err = max_err(da.divided_attention_cuda(qkv, qkvc, sb, rbias, **kw),
                      da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw))
        inner = H * dh
        nbytes = (2 * (qkv.numel() + qkvc.numel() + B * G * L * inner + B * inner)
                  + 4 * ((sb.numel() if sb is not None else 0) + rbias.numel()))
        flops = 4 * B * H * dh * (G * L * (1 + L) + G * L + 1)
        b_ms, b_by = bound(nbytes, flops)
        lq, lk, lv, lmask = _as_one_attention(qkv, qkvc, sb, rbias, H, dh)
        sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)  # noqa: E731
        lib_err = max_err(_split_one_attention(sdpa(), G, L),
                          da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw))
        if not lib_err <= TOL:
            raise AssertionError(f"the one-call attention yardstick differs by {lib_err}")
        rows["divided_attention"].append({
            "shape": f"{axis} B={B} G={G} L={L} H={H} dh={dh}", "calls": calls,
            "max_abs_err": err,
            "ms": time_ms(lambda: da.divided_attention_cuda(qkv, qkvc, sb, rbias, **kw)),
            "plain_ms": time_ms(lambda: da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(sdpa),
            "library": "scaled_dot_product_attention, one dense masked call",
            "library_max_abs_err": lib_err,
        })

    for name, shapes in rows.items():
        for s in shapes:
            emit({"phase": "kernel", "name": name, "card": smi, **s})
            if not s["max_abs_err"] <= TOL:
                raise AssertionError(f"{name} {s['shape']}: max abs error {s['max_abs_err']} > {TOL}")
    return rows


def _synthetic_videos(n_videos, seed):
    """In-memory videos with up to two faces and boxes sized so every square
    crop is exactly 224 px (the val transform is then the identity, so no
    cv2 is needed). Face A sits in the top-left corner, face B in the
    bottom-right; each is tinted so the stand-in embedder tells them apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    W, H, fps = 640, 360, 10
    box_a = [0.0, 0.0, 84.0, 84.0]  # half-res; full-res 168 px + a third each side
    box_b = [W / 2 - 84, H / 2 - 84, W / 2, H / 2]
    videos = []
    for v in range(n_videos):
        seconds = 4 + 2 * v  # short videos leave padded (masked) frames
        faces = [box_a] if v == 0 else [box_a, box_b]
        full = {}
        for i in range(0, seconds * fps, fps):
            frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            frame[:224, :224] = np.clip(frame[:224, :224] // 2 + (100, 40, 40), 0, 255)
            frame[H - 224:, W - 224:] = np.clip(frame[H - 224:, W - 224:] // 2 + (40, 40, 100), 0, 255)
            full[i] = frame
        boxes = {str(j): list(faces) for j in range(seconds * fps)}
        videos.append((full, boxes, fps, (W, H)))
    return videos


def stand_in_embedder(crops):
    """Unit vector of each crop's mean colour minus mid grey (FaceNet is a
    later slice of the port)."""
    import numpy as np

    e = np.stack([c.reshape(-1, 3).mean(0) - 128.0 for c in crops])
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def set_use_kernels(model, flag: bool) -> None:
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = flag


def phase_slice(smi):
    import numpy as np
    import torch

    from mintime_torch import predict
    from mintime_torch.config import MintimeConfig, ModelConfig
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import geglu_ffn as ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = ModelConfig(image_size=224, num_frames=16, num_patches=49, channels=1280, dim=512,
                       depth=9, heads=8, dim_head=64, max_identities=2)
    cfg = MintimeConfig(model=mcfg)
    t0 = time.perf_counter()
    model = MintimeVideoClassifier(mcfg, backbone="efficientnet-b0", head="timesformer",
                                   require_attention=True, use_kernels=True, device="cuda",
                                   seed=0)
    build_model_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    staged = []
    for full, boxes, fps, dims in _synthetic_videos(8, seed=1):
        crops = predict.crops_from_frames(full, boxes, fps)
        assert crops and all(c[2].shape == (224, 224, 3) for c in crops), "crops must be 224 px"
        identities, _ = predict.cluster_crops(crops, stand_in_embedder)
        staged.append(predict.assemble_inputs(identities, dims, cfg))
    stage_s = time.perf_counter() - t0
    n_ids = [len(s[1].identity_keys) for s in staged]
    n_masked = [int((~s[0]["mask"]).sum()) for s in staged]
    assert n_ids[0] == 1 and all(k == 2 for k in n_ids[1:]), n_ids
    assert any(n_masked), "the run should hold padded frames"

    # the main path: counters at 0 just before, read just after
    torch.cuda.synchronize()
    ffn.reset_launches()
    da.reset_launches()
    t0 = time.perf_counter()
    results = predict.predict_assembled(staged, model, None, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"divided_attention": da.launches, "geglu_ffn": ffn.launches}
    if launches != {"divided_attention": 16, "geglu_ffn": 18}:
        raise AssertionError(f"launches per forward {launches}, want 16 attention and 18 FFN")

    # what came out: probabilities, per-identity attention, aggregated maps
    assert len(results) == 8
    for res, k in zip(results, n_ids):
        assert 0.0 <= res.probability <= 1.0 and np.isfinite(res.probability)
        assert len(res.identity_attentions) == k
        for a in res.aggregated_attentions:
            assert a.shape == (16,) and abs(float(a.sum()) - 1.0) < 1e-6

    # kernel mode vs plain mode on the same batch and weights
    stacked = {k: np.concatenate([s[0][k] for s in staged]) for k in staged[0][0]}
    logits_k, maps_k = predict.forward_batch(model, None, stacked)
    set_use_kernels(model, False)
    logits_p, maps_p = predict.forward_batch(model, None, stacked)
    set_use_kernels(model, True)
    for m in maps_k:
        assert m.shape == (8 * 8, 1, 1 + 16 * 49) and np.isfinite(m).all()
        np.testing.assert_allclose(m.sum(-1), 1.0, atol=1e-5)
    assert logits_k.shape == (8,) and np.isfinite(logits_k).all()
    logit_err = float(np.abs(logits_k - logits_p).max())
    map_err = max(float(np.abs(a - b).max()) for a, b in zip(maps_k, maps_p))

    # the same weights in fp32 on the CPU (plain path) on video 1
    cpu = MintimeVideoClassifier(mcfg, require_attention=True, device="cpu", seed=0)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    one = {k: v[1:2] for k, v in stacked.items()}
    logits_cpu, _ = predict.forward_batch(cpu, None, one)
    cpu_err = float(abs(logits_cpu[0] - logits_k[1]))
    emit({"phase": "slice_check", "logits_kernel": logits_k.tolist(),
          "logits_plain": logits_p.tolist(), "kernel_vs_plain_logit_err": logit_err,
          "kernel_vs_plain_map_err": map_err, "cpu_fp32_logit": float(logits_cpu[0]),
          "card_vs_cpu_fp32_logit_err": cpu_err})
    if not logit_err <= TOL:
        raise AssertionError(f"kernel vs plain logits differ by {logit_err} > {TOL}")
    if not cpu_err <= 5e-2:
        raise AssertionError(f"bf16 card vs fp32 CPU logit differs by {cpu_err} > 5e-2")

    # throughput at batch 8 and latency at batch 1, forward + aggregation
    def run(batch):
        predict.predict_assembled(batch, model, None, cfg)
        torch.cuda.synchronize()

    def samples(batch, n):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            run(batch)
            out.append(time.perf_counter() - t)
        return sorted(out)

    run(staged)
    b8 = samples(staged, 7)
    run(staged[1:2])
    b1 = samples(staged[1:2], 15)
    fwd_ms = time_ms(lambda: predict.forward_batch(model, None, stacked), iters=5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    run(staged)
    emit({"phase": "slice", "card": smi, "videos": 8, "batch": 8, "launches": launches,
          "identities": n_ids, "masked_frames": n_masked, "build_model_s": build_model_s,
          "host_stage_s_per_video": stage_s / 8, "first_forward_s": first_s,
          "videos_per_s_batch8": 8 / b8[len(b8) // 2], "batch8_s": b8,
          "p50_latency_ms_batch1": 1e3 * b1[len(b1) // 2], "batch1_s": b1,
          "forward_batch8_device_ms": fwd_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "probabilities": [r.probability for r in results]})
    return launches, model, stacked


def _kind(name: str) -> str:
    """Coarse layer of a CUDA kernel, from its name."""
    low = name.lower()
    if "geglu" in low:
        return "geglu_ffn kernel"
    if "token_rows" in low or "cls_row" in low:
        return "divided_attention kernel"
    if any(w in low for w in ("conv2d", "convolution", "cudnn", "implicit", "depthwise", "fprop")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low:
        return "memory copies"
    if "softmax" in low or "reduce" in low or "norm" in low:
        return "reduction / norm"
    return "elementwise"


def phase_profile(smi, model, stacked):
    """Where the device time of one forward goes, by ``torch.profiler``: the
    device's busy share of the host window, time by layer and the top
    kernels, at batch 8 and batch 1."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mintime_torch import predict

    for batch in (8, 1):
        rows = {k: v[:batch] for k, v in stacked.items()}
        predict.forward_batch(model, None, rows)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            predict.forward_batch(model, None, rows)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        busy, end = 0.0, float("-inf")
        for a, b in spans:  # union of the kernels' intervals
            if b > end:
                busy += b - max(a, end)
                end = b
        by_kind, by_name = {}, {}
        for e in kernels:
            us = e.time_range.end - e.time_range.start
            by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + us / 1e3
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        emit({"phase": "profile", "card": smi, "batch": batch, "host_window_ms": wall_us / 1e3,
              "kernels": len(kernels),
              "device_busy_ms": busy / 1e3 if kernels else "not measured",
              "device_idle_share": 1 - busy / wall_us if kernels else "not measured",
              "ms_by_layer": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
              "top_kernels": [{"name": k[:90], "launches": n, "ms": t} for k, (n, t) in top]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    try:
        import mintime_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repo ({e})", file=sys.stderr)
        return 1

    smi = phase_device()
    rows = phase_kernels(smi)
    launches, model, stacked = phase_slice(smi)
    phase_profile(smi, model, stacked)

    sources = {"geglu_ffn": ("mintime_torch/csrc/geglu_ffn.cu", "mintime_tpu/ops/pallas_ffn.py:57"),
               "divided_attention": ("mintime_torch/csrc/divided_attention.cu",
                                     "mintime_tpu/ops/pallas_attention.py:140")}
    kernels = []
    for name, shapes in rows.items():
        calls = sum(s["calls"] for s in shapes)
        per_call = lambda key: sum(s[key] * s["calls"] for s in shapes) / calls  # noqa: E731
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            # per launch, averaged over the shapes one forward launches it at
            "ms": per_call("ms"), "plain_ms": per_call("plain_ms"),
            "bound_ms": per_call("bound_ms"),
            "bound_by": max(shapes, key=lambda s: s["calls"] * s["bound_ms"])["bound_by"],
            "library_ms": (per_call("library_ms")
                           if all(s["library_ms"] is not None for s in shapes) else None),
            "card": smi, "shapes": shapes,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
