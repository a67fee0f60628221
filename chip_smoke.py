#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``mintime_torch``) runs on an NVIDIA
GPU: ``python3 chip_smoke.py`` from the root of a checkout, on a machine with
one card. It builds the CUDA kernels itself.

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device and build: the card, its power limit, torch and CUDA versions, the
   seconds ``nvcc`` took for the ten ``mintime_torch/csrc/*.cu`` sources;
2. kernels: every kernel of the serving, training and probe paths against
   its plain PyTorch version on the card in bf16 at the paths' shapes (the
   FFN at widths 512 and 256, the divided attention at the flagship's and
   at the conv model's long axes (G = 8 groups of L = 80, 112, 192 and 256,
   and 192 groups of 8; 6 x 64 heads, batch 8), the token rows at the Convolutional TimeSformer's time axis and, with masked
   frames, at 96 groups; the v1 grouped attention at flagship width, masked
   and not; the chunked attention at the attention probe's B = 32 and
   packing (one call each profiled by launch: the packed tiles' token rows
   and the CLS row's three launches) and at its edges (``CHUNKED_EDGES``;
   rows with no calls; within 2e-2 * max(1, max |plain|)), two reruns
   bitwise equal; the depthwise forward and weight gradient at the dw probes' 512
   images and geometries; Xception's depthwise 3 x 3 kernel at each of
   Xception's 9 depthwise shapes at 224 px, ReLU on and off, 256 images,
   within one bf16 rounding of the largest plain output, reruns bitwise
   equal; forward attentions: max abs error <= 2e-2; the
   depthwise forward <= 2e-2 * max(1, max |plain|), its weight gradient
   <= 2e-2 * max |plain|; backward, with unit-scale cotangents: per gradient
   <= 2e-2 * max(1, max |plain|), each gradient's error and max printed),
   with its time, the plain version's time, the card's bound for the work
   and one library call's time as a yardstick the port never calls
   (``scaled_dot_product_attention``, forward and backward, or cuDNN). The
   divided-attention backward also at the edges of its token-row tiles
   (L = 1, 17 and 33: four, two and one groups a block; L = 63 masked;
   L = 65 and 129 past a 64-row chunk; L = 200 masked; a masked row has a
   sequence mask and a CLS-row bias that masks part of the row; rows with
   no calls, so they leave the per-launch averages alone), under 5% of its
   bf16 d_qkv differing from the plain version's at every L; at L = 192
   and at the flagship space axis two reruns must give the same bits of
   ``d_qkv`` and ``d_qkvc``, and one call is profiled by CUDA launch (the
   CLS row's logits, chunk sums and finish, the token rows' row and column
   launches, the reduce). The
   forward too: two reruns at L = 192 bitwise equal and one call profiled
   by launch (the token rows and the CLS row's three launches). The FFN
   forward by device time (``host_ms`` beside it), with the same function
   as PyTorch's three calls (``F.linear``, the gate, ``F.linear``: cuBLAS
   products) by device time as ``cublas_products_ms``; also at row counts
   off its plans' tiles (M = 1, 127, 129, 6273 at both widths; rows with no
   calls), and at the flagship's token and CLS rows two reruns bitwise equal
   and one call profiled by launch (launch A, launch B and, with split
   slices, the reduce: exactly the plan's kernels a call). The token-row
   backward also at 33, 49 and 64 frames, masked and not (rows with no
   calls). The FFN
   backward also at row counts off its 128-row tiles (M = 1, 100 and, at
   width 512, 6272 + 8; rows with no calls), two reruns at the flagship's
   and the conv model's token rows bitwise equal and one call each profiled
   by launch (the dh kernel, the three products in one launch, the ordered
   reduce); its ``ms`` is device time too, ``host_ms`` beside it. The grouped
   attention also at its
   edges (L = 1, 17, 33, 64, a head width of 30, rows whose every token key
   is masked; rows with no calls) and two reruns at each flagship axis
   bitwise equal. The attention forwards, the attention backward and their
   library calls are timed by device time (``device_ms``: their launches
   finish quicker than Python issues them), with the host's time per call
   beside it;
3. slice: the flagship EfficientNet-B0 + Size-Invariant TimeSformer at full
   width (224 px, 1280 channels, dim 512, depth 9, 8 x 64 heads, F = 16,
   n = 49, two identities), seeded random weights, through the port's
   ``crops_from_frames → cluster_crops → assemble_inputs → predict_assembled``
   (forward + ``aggregate_attentions``) for 8 synthetic in-memory videos at
   batch 8. The launch counters must show 16 attention and 18 FFN kernel
   launches for that forward; kernel-mode logits must match plain-mode logits
   within 2e-2 on the card and a CPU fp32 run of the same weights within
   5e-2; throughput at batch 8 and latency at batch 1 are printed;
3b. detect: the port's face detector and embedder at DFDC's frame size, with
   no hand-written kernel. 8 synthetic BGR videos of 150 frames (5 s at
   30 fps) at 1920 x 1080 (8-px blocks of seeded noise drifting 4 px a
   frame), made one video at a time, so the host holds at most two; seeded
   random-init P/R/O-Nets (seed 1) with their score layers x75 and
   thresholds (0.03, 0.75, 0.94), which leave about 150 stage-1 candidates
   and 3.5 faces a frame. ``MTCNNDetector(input_scale=2,
   channel_order="bgr", device_crops=True)`` runs ``detect_videos`` over all
   8 (every frame), ``predict.crops_from_frames`` takes a crop a second at
   full resolution and ``predict.cluster_crops`` embeds them with the
   ``FaceEmbedder`` (random-init InceptionResnetV1 at 128 px, fp32). Checks:
   the nets' parameters on the card; the native NMS library loaded; no
   P-Net truncation warning; on two frames of video 0 the card's boxes
   against the same detector on the CPU and against ``device_crops=False``
   on the card within 2e-2, with the same counts; video 0's embeddings on
   the card against the CPU's within 1e-4 and the same cluster memberships;
   no kernel launched; videos 0-2 through ``detect_videos`` of a detector
   with a head of 0 cells (``pnet_head_k=0``: every video copies its
   stage-1 tail from the card after the next video's stage 1 is enqueued,
   3 such copies counted) against the main path's boxes within 2e-2, with
   the same counts. Printed: detection frames/s by host clock (frame
   making excluded), device ms of stage 1 and of stages 2-3 by CUDA events,
   host ms of NMS and of the box bookkeeping, the videos that copied their
   stage-1 tail, candidates and faces a frame, the embedder's crops/s and
   device ms, clustering ms, peak memory;
3c. predict (after 3b): the predict CLI's loading code and the whole
   pipeline from decoded frames, for MINTIME-EF (EfficientNet-B0, 1280
   channels) and MINTIME-XC (Xception, 2048 channels) at full width (the
   published Size-Invariant TimeSformer otherwise: 224 px, dim 512, depth 9,
   8 x 64 heads, F = 16, n = 49, bf16 compute on fp32 parameters).
   Reference-format weight files of seeded random weights (the TimeSformer
   head with the reference's oversized embedding tables, each extractor,
   the three MTCNN nets and FaceNet of phase 3b) are written to a temporary
   directory in the checkout and read back through
   ``predict.load_predict_models``; phase 3b's 8 videos run through
   ``predict.stage_decoded`` (detection with phase 3b's options, crops,
   identities, the evaluation transform on the card, assembly) and
   ``predict.predict_assembled`` at batch 8. Checks per backbone: 16
   attention and 18 FFN launches for the run (one forward), and for
   MINTIME-XC 34 of Xception's depthwise kernel; kernel-mode logits against
   plain mode (no hand-written kernel launched, Xception's depthwise layers
   on cuDNN) within 2e-2, the first video's against a CPU
   fp32 run within 5e-2; the card's evaluation transform against the CPU's
   on every crop of the run (all under 224 px: the cubic path) and on five
   larger crops of a frame (the area path; at most one level, on at most
   0.1% of the pixels); finite probabilities and maps; the identities of
   phase 3b.
   Printed: videos/s of the whole pipeline (a second, warm run by host
   clock ending in a synchronise, frame making excluded), its split into
   detection, crops, clustering, transform and forward, the forward's
   device ms at batch 8, peak memory. Then the served path's pipelining
   (paths ``predict_ef_pipelined``, ``predict_xc_pipelined``): the same
   videos through ``predict.stage_decoded_pipelined`` (video i+1's stage 1
   enqueued before video i's host stages) and ``predict.predict_staged``
   (``predict_videos``' batch logic) at batch 8, counted (16 / 18 launches,
   and 34 depthwise for MINTIME-XC),
   its probabilities within 1e-6 of the sequential run's and its
   identities equal; then sequential, pipelined, pipelined, sequential by
   host clock, with each turn's host ms in ``_dispatch_stage1`` and, within
   it, in the frames' upload and the pyramid's launches, stage 1's device
   ms, the tail copies and peak memory, and the device's idle share over a
   profiled pipelined run;
3d. evaluate (after 3c): the evaluation CLI's function,
   ``evaluate.evaluate_split`` (what ``python -m mintime_torch.evaluate``
   calls after reading its yaml), on a test split written to a temporary
   directory in the checkout: 48 videos as ``crops.pack`` shards from
   ``crop_store.write_pack`` (8-pixel block noise in a band of 64 levels
   that each video draws, square faces of 64-320 px as in DFDC's 1920 x
   1080 frames, one crop a second for 10 s an identity;
   16 videos of one identity, 24 of two, 8 of three; every sixth with loose
   crops that merge into identity 0; every eighth with its frame size in a
   ``video_dims.json`` sidecar, the rest in the pack header) and a
   ``test.csv`` (half fake with methods 1-4, pristine with none). MINTIME-EF
   from phase 3c's weight files at full width, but for the output layer:
   a random head maps every video to nearly one logit, so the output layer
   is fitted first, by a plain fp32 run on the card, to the direction in
   which the split's CLS embeddings vary with the videos' crop level, apart
   from identity count (logits of standard deviation 0.15 around their
   median); 4 spawned workers. Checks: 18 attention and
   18 FFN launches a forward (6 forwards at batch 8, the counted main path;
   48 at the yaml's test batch of 1); kernel logits within 2e-2 of a plain
   run's (``fused_attention=0``) and within a quarter of the plain logits'
   standard deviation, the same sign on every video whose plain logit lies
   more than 2e-2 from 0 (a quarter of the videos or more on each side),
   the reports' ``n_videos`` equal and their accuracy equal when no logit
   lies within 2e-2 of 0; the first two videos' logits within 5e-2 of a
   CPU fp32 run of the same files; ``n_videos`` 48, and 32 with
   ``only_multiidentity``; every field of every report finite. Printed:
   the time of the counted ``evaluate_split`` call, the CLI's whole work,
   with its split by stage; videos/s from the files on disk to the report
   at batch 8 and 1 (a warm second pass of a loader built as
   ``evaluate_split`` builds it, whose workers are up), its split into the
   wait on the loader, the transform on the card and the forward with its
   copies (host clocks ending in a synchronise), peak memory, the reports;
4. profile: one forward at batch 8 and at batch 1 under ``torch.profiler``:
   the device's busy and idle share of the host window, device time by
   layer (cuDNN convolutions, cuBLAS matmuls, the kernels, copies, the rest)
   and the top kernels;
5. train: the same flagship classifier at full width with fp32 master
   weights computing in bf16, kernels on, trained for 5 SGD steps (lr 0.01,
   weight decay 1e-4, cosine) on 8 synthetic videos assembled as in phase 3,
   half labelled fake. Each step must launch 18 attention and 18 FFN kernels
   forward, and 18 attention and 17 FFN kernels backward (the last layer's
   token FFN does not reach the logits, so autograd skips its backward); one
   step's gradients with kernels must match the plain path's (loss within
   2e-2; each tensor's max abs gap within 5e-2 of its largest plain gradient
   beyond the gap of a kernel-free twin run, tensors whose fp32 gradient is
   zero to rounding aside; every tensor over 5e-2 is named with its
   readings); every parameter must get a finite, non-zero gradient; the loss
   after the 5 steps must be below the first; the BatchNorm statistics must
   move. Steps/s, videos/s, device ms per step, peak memory and a profile of
   one step are printed;
5b. augment (after 5): the train-mode augmentations on the card, on 8
   videos of 16 slots (dummy slots included) of a train split written as
   phase 3d writes its test split (48 videos as packs, faces of 64-320 px,
   1-3 identities, 24 of each label, DFDC's 1920 x 1080): each video's
   natural ``max`` resize chain, then each of the 26 transforms forced once
   a video (a one-member ``OneOf(p=1.0)``, drawn from a seed), held against
   the port on the CPU on the same stack and draws: bitwise for
   HorizontalFlip, InvertImg, CoarseDropout, RandomBrightnessContrast,
   RandomGamma, RGBShift, GaussNoise, MultiplicativeNoise and MedianBlur,
   within one level for the rest; its ms a video, the largest difference and
   the share of values that differ are printed. Then the natural ``max``
   and ``min`` draws of those videos: ms a slot of the resize chain and of
   the augmentations, and what a batch of 8 would be of phase 5's step;
5c. train_disk: ``DeepfakesDataset(mode="train", augmentation="max")``
   over that split through the port's ``DataLoader`` (batch 8, shuffled, 4
   spawned workers), the flagship of phase 5 (fp32 masters in bf16, SGD)
   trained for 2 epochs of 6 steps through ``train.make_train_step``. Each
   step must launch 18 / 18 attention / FFN kernels forward and 18 / 17
   backward and none of the others, and give a finite loss; one step's loss
   kernels vs plain on the same augmented batch within 2e-2; every video's
   frames bitwise equal in both epochs (the JAX package's ``(seed, index)``
   draw, which ignores the epoch). Printed: each epoch's steps/s and
   videos/s, split by host clocks ending in a synchronise into the wait on
   the loader, the transform (resize chain, augmentations) and the step;
   the launches a step; the losses; peak memory;
5d. train_main: the training CLI's function (``train_loop.main`` with an
   argv list and the config of ``configs/size_invariant_timesformer.yaml``
   built in code; its 2048 channels are Xception's, so ``--extractor_model
   1``, MINTIME-XC) on that split: 48 train videos, 16 of them as the
   validation list, batch 8, 4 spawned workers, 2 epochs, then an automatic
   resumption that runs one more epoch from the last checkpoint. Each train
   step must launch 18 / 18 attention / FFN kernels forward and 18 / 17
   backward and none of the others, each validation forward 18 / 18 and
   Xception's 34 depthwise launches (no gradient there); the
   losses finite, ``Validation/Loss`` logged every epoch, a checkpoint
   written, and the resumed run starting at that checkpoint's epoch + 1 and
   step. Printed: each epoch's steps/s and videos/s, its validation pass and
   its checkpoint write timed apart;
5e. slowfast: SlowFast R-50 (``configs/slowfast.yaml``: 256 px, 32 fast and
   8 slow frames, widths 64 to 2048 and 8 to 256) from a weight file in
   pytorchvideo's ``slowfast_r50`` keys that the phase writes (seeded
   draws): ``evaluate.evaluate_split(model=2)`` over phase ``evaluate``'s
   48-video split at the yaml's batch of 32, the first video's logit against
   a CPU fp32 run within 5e-2; SGD steps at batch 32 through
   ``train.make_train_step`` (every parameter a finite non-zero gradient,
   every BatchNorm's statistics moved); one epoch of ``train_loop.main
   --model 2``. No hand-written kernel may launch. Printed: videos/s,
   steps/s, device ms a step, peak memory;
5f. profiling: the profiler CLI's function (``utils.profiling.main``) at
   flagship width, batch 8, 3 traced calls of a forward and of ``--train``
   (the real train step); the table must name the kernels, and each
   kernel's launches in the trace (template variants summed) must equal its
   wrapper's counter over the traced calls: 18 attention and 18 FFN a
   forward (no attention maps, so every layer takes the kernels), 18 / 18 /
   18 / 17 a step; a trace that lost a kernel is taken again (3 tries).
   Printed: videos/s under the trace, the top rows by section;
5g. extract_features: ``extract_features.extract_features`` over every
   crop of a split of packs (phase ``evaluate``'s writer) at batch 64, B0 in
   bf16 from a seeded ``Extractor_checkpoint`` file, the crops decoded from
   the packs; one ``.npy`` a crop; the first 8 crops' maps against the CPU
   in fp32 within 5e-2 of max |CPU|. Printed: crops/s, peak memory;
5h. verify_weights: ``verify_weights.main`` on seeded files in the
   published formats (MTCNN, FaceNet, MINTIME-EF's Model/Extractor, a
   ``slowfast_r50`` hub file): rc 0, 8 ``[ OK ]`` lines, 16 / 18 launches;
5i. pretrain: ``pretrain_extractor.main`` with
   ``configs/extractor_pretraining.yaml``'s config (224 px, batch 16, the
   ``min`` preset, SGD, StepLR) for 2 epochs on that split, every third
   video the validation list, 4 spawned workers; finite losses, no kernel
   launch, the exported ``Extractor_checkpoint`` equal to the checkpoint's
   extractor and loaded into MINTIME-EF bitwise. Printed: a warm epoch's
   steps/s and images/s, the step's share, peak memory;
5j. parallel: ``train_loop.main`` in a spawned process of a one-rank NCCL
   group (``torchrun``'s environment) for one step of 8 videos and its
   validation (18 / 18 / 18 / 17 and 18 / 18 launches); then two spawned
   ranks over gloo on the one card (NCCL refuses two ranks on one card):
   the flagship's DP=2 train step at full width, batch 8 as 4 + 4, against
   one process: in fp32 on the plain path (TF32 off) each gradient within
   1e-3 of its tensor's max (tensors zero in fp32 aside, as in phase
   ``train``) and the loss within 1e-4, then in bf16 with the
   kernels the loss within 2e-2, the ranks' parameters bitwise equal, the
   gradient gaps printed beside a kernel-free twin's; and TP=2 (4 heads and
   1024 hidden units a rank) against TP=1 on the loss within 2e-2, each
   rank's launches 18 / 18 / 18 / 17. Printed: each run's seconds, the
   ranks' step seconds, losses, the worst gradients;
6. conv: the Convolutional TimeSformer preset (``configs/
   convolutional_timesformer.yaml``: EfficientNet-B0 tapped at block 20, 1280
   channel tokens of width 49 per frame, dim 256, depth 4, 6 x 64 heads,
   F = 8) at full width, bf16 weights from seed 0, through
   ``train.make_eval_step`` at batch 8 on ``bench.py``'s inputs
   (standard-normal frames, all-true mask, size bucket 1). One forward must
   launch 4 token-row and 8 FFN kernels and no whole-slice attention (the
   space axis, L = 1280, stays plain); kernel-mode logits must match
   plain-mode logits within 2e-2 and a CPU fp32 run of the first video within
   5e-2; videos/s, forward device ms, peak memory and a profile are printed;
7. conv_train: the same model with fp32 masters computing in bf16, 5 SGD
   steps at batch 8 (lr 0.01, weight decay 1e-4, half labelled fake) through
   ``train.make_train_step``. Each step must launch 4 token-row and 8 FFN
   kernels forward and 4 token-row and 7 FFN kernels backward; the gradient
   rule of phase 5 over the head's parameters, each with a finite non-zero
   gradient; the frozen extractor gets no gradient, its BatchNorm statistics
   stay bitwise unchanged and its weights move by weight decay alone; the
   loss falls. Steps/s, device ms per step, peak memory and a profile are
   printed;
6b, 7b. conv_tap10, conv_tap10_train: phases 6 and 7 with the extractor
   tapped at block 10 (192 channel tokens of 7 x 7): both axes of every
   layer take the whole-slice kernels (8 groups of 192 and 192 groups of 8),
   so one forward must launch 8 divided-attention, 8 FFN and no token-row
   kernels, and a train step's backward 8 divided-attention and 7 FFN
   kernels; every check of phases 6 and 7;
8. grouped: the JAX package's v1 ``fused_grouped_attention`` through the
   port's function at flagship width (B = 8, 8 x 64 heads) on both axes,
   masked as ``tests/test_pallas_attention.py`` masks and unmasked: four
   kernel launches, each output within 2e-2 of the plain grouped attention
   in fp32 and of the kernel's plain version;
9. probes: the three probes' ``run()`` (``mintime_torch/experiments/``: the
   attention variants A, B, G, D, E at B = 32, the depthwise forward against
   cuDNN and the weight gradient against cuDNN's backward at 512 images),
   one JSON line a table row; variants B and G within 2e-2 of A; the
   launches of the chunked-attention and both depthwise kernels counted;
   ``dw_conv_wgrad`` bitwise equal on reruns.

The line before the last holds ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import time

try:
    # the profiler's machinery (padded windows opened by spin kernels, launches
    # tied to their kernel records) is the port's own, shared with its profiler
    from mintime_torch.utils.profiling import _profile, device_ms
except ImportError as e:
    sys.exit(f"chip_smoke: run from the root of a checkout of the repo ({e})")

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


#: the conv model's whole-slice attentions at tap blocks 4-13 (6 x 64 heads,
#: batch 8, no masks): (G, L, axis, launches per forward and per train step).
#: Tap block 10 (192 channel tokens) runs both axes, four layers each; 80, 112
#: and 256 are the other long axes the kernels take (tap blocks 4-6, 7-9, and
#: the limit), held against their plain versions only
CONV_LONG_AXES = ((192, 8, "time", 4), (8, 80, "space", 0), (8, 112, "space", 0),
                  (8, 192, "space", 4), (8, 256, "space", 0))


def _divided_cases(gen):
    """The whole-slice attention's shapes: the flagship's two axes (launched 8
    times a forward and 9 a train step each) and ``CONV_LONG_AXES``, as
    (shape, (qkv, qkv_cls, seq_bias, row_bias), heads, launches per forward,
    launches per train step)."""
    import torch

    cases = []
    for axis in ("time", "space"):
        args = _attention_inputs(axis, gen)
        B, G, L, _ = args[0].shape
        cases.append((f"{axis} B={B} G={G} L={L} H=8 dh=64", args, 8, 8, 9))
    B, H, dh = 8, 6, 64
    for G, L, axis, calls in CONV_LONG_AXES:
        if axis == "time":  # the (B, F, C, ·) layout seen as its transpose, as the model passes it
            qkv = torch.randn(B, L, G, 3 * H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
        else:
            qkv = torch.randn(B, G, L, 3 * H * dh, generator=gen).cuda().bfloat16()
        qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
        cases.append((f"conv {axis} B={B} G={G} L={L} H={H} dh={dh}", (qkv, qkvc, None, None), H,
                      calls, calls))
    # the flagship's axes as a TP=2 model rank runs them (phase parallel):
    # half the heads, inputs from a generator of their own
    tp_gen = torch.Generator().manual_seed(TP_SEED)
    for axis in ("time", "space"):
        args = _attention_inputs(axis, tp_gen, H=TP_HEADS)
        B, G, L, _ = args[0].shape
        cases.append((f"tp2 {axis} B={B} G={G} L={L} H={TP_HEADS} dh=64", args, TP_HEADS, 8, 9))
    return cases


def _numel(*tensors) -> int:
    return sum(0 if t is None else t.numel() for t in tensors)


def _dense_row_bias(rbias, B, G):
    """The CLS-row bias for the one-call yardstick, which needs one."""
    import torch

    return torch.zeros(B, G, 1, device="cuda") if rbias is None else rbias


#: the FFN's shapes on the main paths: (model width, hidden width, [(M, calls per
#: forward, calls per train step)]) for the flagship (the token and CLS rows of
#: 8 videos, 9 layers) and the Convolutional TimeSformer (4 layers)
FFN_SHAPES = ((512, 2048, ((8 * 16 * 49, 9, 8), (8, 9, 9))),
              (256, 1024, ((8 * 8 * 1280, 4, 3), (8, 4, 4))))
#: the flagship's FFN and attention as a TP=2 model rank runs them (phase
#: ``parallel``): half the hidden units and heads, inputs from their own seed
FFN_TP_SHAPES = ((512, 1024, ((8 * 16 * 49, 9, 8), (8, 9, 9))),)
TP_HEADS, TP_SEED = 4, 18


#: the FFN forward's row counts off its plans' tiles, at both widths (no
#: main path launches them): one row, a row short of a 128-row tile, a row
#: past it, a row past the flagship's token rows
FFN_FWD_EDGE_ROWS = (1, 127, 129, 6273)
#: the (width, rows) whose forward is rerun for bits and profiled by launch:
#: the flagship's token rows (two launches) and CLS rows (three)
FFN_FWD_PROFILED = ((512, 8 * 16 * 49), (512, 8))


def _ffn_weights(r, dim, hidden):
    """W0, b0, W1, b1 at unit fan-in scale."""
    return (r(2 * hidden, dim, sc=dim ** -0.5), r(2 * hidden, sc=0.02),
            r(dim, hidden, sc=hidden ** -0.5), r(dim, sc=0.02))


def phase_kernels(smi):
    """Each kernel vs its plain version at the main paths' shapes."""
    import torch

    from mintime_torch.ops import geglu_ffn as ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    rows = {"geglu_ffn": [], "divided_attention": []}

    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dim, hidden, shapes in FFN_SHAPES:
        w0, b0, w1, b1 = _ffn_weights(r, dim, hidden)
        # the plan's edges (row counts off its 128-row tiles), no calls
        for m, calls in [(m, c) for m, c, _ in shapes] + [(m, 0) for m in FFN_FWD_EDGE_ROWS]:
            args = (r(m, dim), w0, b0, w1, b1)
            plan = ffn.fwd_plan(m, dim, hidden, sms)
            rows["geglu_ffn"].append({**_ffn_fwd_row(args, calls, "" if calls else "edge ",
                                                     plan["launches"]), "plan": plan})
            if (dim, m) in FFN_FWD_PROFILED:
                _ffn_fwd_rerun_and_launches(smi, args, plan["launches"])
            del args
    tp_gen = torch.Generator().manual_seed(TP_SEED)
    r_tp = lambda *s, sc=1.0: (torch.randn(*s, generator=tp_gen) * sc).cuda().bfloat16()  # noqa: E731
    for dim, hidden, shapes in FFN_TP_SHAPES:
        w0, b0, w1, b1 = _ffn_weights(r_tp, dim, hidden)
        for m, calls, _ in shapes:
            plan = ffn.fwd_plan(m, dim, hidden, sms)
            rows["geglu_ffn"].append({**_ffn_fwd_row((r_tp(m, dim), w0, b0, w1, b1), calls,
                                                     "tp2 ", plan["launches"]), "plan": plan})

    for shape, args, H, calls, _ in _divided_cases(gen):
        rows["divided_attention"].append(_divided_fwd_row(shape, args, H, calls))
        del args
    _divided_fwd_rerun_and_launches(smi)

    rows["token_rows_attention"] = _token_rows_rows(smi, gen)
    rows["conv3x3"] = _xc_dw_rows()
    rows.update(_probe_kernel_rows(gen))
    for name, shapes in rows.items():
        for s in shapes:
            emit({"phase": "kernel", "name": name, "card": smi, **s})
            limit = s.get("limit", TOL)
            if not s["max_abs_err"] <= limit:
                raise AssertionError(f"{name} {s['shape']}: max abs error {s['max_abs_err']} > {limit}")
    rows.update(_backward_kernels(smi, gen))
    return rows


def _divided_fwd_row(shape, args, H, calls):
    """The whole-slice attention forward against its plain version, its
    device time (``ms``: the call's four launches finish quicker than Python
    issues them, so a host clock over back-to-back calls, ``host_ms``,
    reads the host), the plain version's, the bound and one dense masked
    ``scaled_dot_product_attention`` call by device time."""
    import torch.nn.functional as F

    from mintime_torch.experiments.attn_kernel_variants import dense_inputs, split_dense
    from mintime_torch.ops import divided_attention as da

    qkv, qkvc, sb, rbias = args
    B, G, L, _ = qkv.shape
    dh = 64
    kw = dict(heads=H, dim_head=dh)
    err = max_err(da.divided_attention_cuda(qkv, qkvc, sb, rbias, **kw),
                  da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw))
    inner = H * dh
    nbytes = (2 * (qkv.numel() + qkvc.numel() + B * G * L * inner + B * inner)
              + 4 * _numel(sb, rbias))
    flops = 4 * B * H * dh * (G * L * (1 + L) + G * L + 1)
    b_ms, b_by = bound(nbytes, flops)
    lq, lk, lv, lmask = dense_inputs(qkv, qkvc, sb, _dense_row_bias(rbias, B, G), H, dh)
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)  # noqa: E731
    lib_err = max_err(split_dense(sdpa(), G, L),
                      da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw))
    if not lib_err <= TOL:
        raise AssertionError(f"the one-call attention yardstick differs by {lib_err}")
    kernel = lambda: da.divided_attention_cuda(qkv, qkvc, sb, rbias, **kw)  # noqa: E731
    return {
        "shape": shape, "calls": calls, "max_abs_err": err,
        "ms": device_ms(kernel), "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: da.divided_attention_plain(qkv, qkvc, sb, rbias, **kw)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa),
        "library": "scaled_dot_product_attention, one dense masked call",
        "library_max_abs_err": lib_err,
    }


def _geglu_plain_ops(x, w0, b0, w1, b1):
    """The FFN forward as PyTorch's own calls in bf16: ``F.linear``, the
    GEGLU gate (``F.gelu`` and a product), ``F.linear``; a yardstick the port
    never calls."""
    import torch.nn.functional as F

    val, gate = F.linear(x, w0, b0).chunk(2, dim=-1)
    return F.linear(val * F.gelu(gate), w1, b1)


def _ffn_fwd_row(args, calls, tag="", launches=None):
    """The FFN forward vs its plain version, its device time (``ms``: the
    kernels' durations under ``torch.profiler``, ``launches`` kernels a call
    where that is given), the host's ms per call by CUDA events over
    back-to-back calls, the plain version's device time, the bound and the
    same function as PyTorch's three calls (cuBLAS products around the gate),
    by device time."""
    from mintime_torch.ops import geglu_ffn as ffn

    x, w0, b0, w1, b1 = args
    m, dim = x.shape
    hidden = w1.shape[1]
    plain = ffn.geglu_ffn_plain(*args)
    err = max_err(ffn.geglu_ffn_cuda(*args), plain)
    ops_err = max_err(_geglu_plain_ops(*args), plain)
    nbytes = 2 * (2 * m * dim + w0.numel() + b0.numel() + w1.numel() + b1.numel())
    flops = 2 * m * 3 * dim * hidden
    b_ms, b_by = bound(nbytes, flops)
    call = lambda: ffn.geglu_ffn_cuda(*args)  # noqa: E731
    dev = device_ms(call, launches=launches)
    return {
        "shape": f"{tag}D={dim} H={hidden} M={m}", "calls": calls, "max_abs_err": err,
        "ms": dev, "device_ms": dev, "host_ms": time_ms(call),
        "plain_ms": device_ms(lambda: ffn.geglu_ffn_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "cublas_products_ms": device_ms(lambda: _geglu_plain_ops(*args)),
        "cublas_products": "three calls: F.linear, the GEGLU gate (F.gelu and a product),"
                           " F.linear, in bf16", "cublas_products_max_abs_err": ops_err,
    }


def _ffn_fwd_rerun_and_launches(smi, args, launches):
    """Two reruns of the FFN forward must give the same bits, and three
    calls' device time by CUDA launch under ``torch.profiler``, exactly
    ``launches`` kernels a call (launch A, launch B and, with split slices,
    the reduce)."""
    import torch

    from mintime_torch.ops import geglu_ffn as ffn

    call = lambda: ffn.geglu_ffn_cuda(*args)  # noqa: E731
    first = call()
    bitwise = all(torch.equal(call(), first) for _ in range(2))
    x, w1 = args[0], args[3]
    shape = f"D={x.shape[1]} H={w1.shape[1]} M={x.shape[0]}"
    emit({"phase": "kernel_bitwise", "name": "geglu_ffn", "shape": shape, "card": smi,
          "reruns": 2, "out_bitwise_equal": bitwise})
    if not bitwise:
        raise AssertionError(f"geglu_ffn gave other bits on a rerun at {shape}")
    # each launch's time is its total over the three calls in the window
    emit({"phase": "kernel_launches", "name": "geglu_ffn", "shape": shape, "card": smi,
          "calls_in_window": 3, "launches_per_call": launches,
          **_profile(lambda: [call() for _ in range(3)], launches=3 * launches, calls=3)})


def _token_rows_inputs(gen, G, masked, B=8, F=8, H=6, dh=64):
    """The Convolutional TimeSformer's time axis: qkv (B, F, G, 3*H*dh) seen
    as its (B, G, F, ·) transpose, the CLS qkv, and with ``masked`` a
    seq_bias that masks frames (column 0 the CLS key, always kept)."""
    import torch

    from mintime_torch.ops.attention import build_frame_mask
    from mintime_torch.ops.divided_attention import mask_to_bias

    qkv = torch.randn(B, F, G, 3 * H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    sb = None
    if masked:
        mask = torch.ones(B, F, dtype=torch.bool)
        mask[1, 5:] = False
        mask[6, 2:] = False
        sb = mask_to_bias(build_frame_mask(mask, None).cuda())
    return qkv, qkvc, sb


def _token_rows_as_sdpa(qkv, qkvc, sb, H, dh):
    """The same token rows as one ``scaled_dot_product_attention`` call over
    (B*G, H, L, 1+L): q of each group's L rows, k and v with the CLS row's
    prepended, and with ``sb`` a boolean mask. Built outside the timed call;
    the port never calls it."""
    import torch

    from mintime_torch.ops.divided_attention import NEG

    B, G, L, _ = qkv.shape
    t = qkv.unflatten(-1, (3, H, dh)).reshape(B * G, L, 3, H, dh).permute(2, 0, 3, 1, 4)
    c = qkvc[:, 0].unflatten(-1, (3, H, dh)).repeat_interleave(G, dim=0)[:, :, :, None]
    q = t[0].contiguous()
    k, v = (torch.cat([c[:, i], t[i]], dim=2).contiguous() for i in (1, 2))
    mask = None if sb is None else (sb > NEG / 2).repeat_interleave(G, dim=0)[:, None]
    return q, k, v, mask


#: (G, L, seq mask, launches a forward or a train step) of the token-row
#: kernels' rows: the conv time axis (four layers), and with no calls
#: masked G = 96 and the long axes the kernels take (no main path)
TOKEN_ROWS_CASES = ((1280, 8, False, 4), (96, 8, True, 0)) + tuple(
    (96, L, masked, 0) for L in (33, 49, 64) for masked in (False, True))


def _token_rows_shape(G, L, masked, calls, B=8, H=6, dh=64) -> str:
    return (f"{'' if calls or L == 8 else 'edge '}time B={B} G={G} L={L} H={H} dh={dh}"
            + (" seq_bias" if masked else ""))


def _token_rows_row(case, gen, launches=None):
    """The token-row forward kernel at one of ``TOKEN_ROWS_CASES`` against
    its plain version, its device time (``ms``: the kernels' durations under
    ``torch.profiler``, ``launches`` kernels a call where that is given;
    ``host_ms`` by CUDA events over back-to-back calls), the plain version's,
    the bound and one ``scaled_dot_product_attention`` call over the same
    groups, by device time too (``library_host_ms`` beside it)."""
    import torch.nn.functional as F

    from mintime_torch.ops import token_rows as tr

    G, L, masked, calls = case
    H, dh = 6, 64
    qkv, qkvc, sb = _token_rows_inputs(gen, G, masked, F=L)
    B = qkv.shape[0]
    kw = dict(heads=H, dim_head=dh)
    plain = tr.token_rows_attention_plain(qkv, qkvc, sb, **kw)
    err = max_err(tr.token_rows_attention_cuda(qkv, qkvc, sb, **kw), plain)
    nbytes = (2 * (qkv.numel() + qkvc.numel() + plain.numel())
              + 4 * (0 if sb is None else sb.numel()))
    flops = 4 * B * G * H * L * (1 + L) * dh  # logits and PV over 1 + L keys
    b_ms, b_by = bound(nbytes, flops)
    lq, lk, lv, lmask = _token_rows_as_sdpa(qkv, qkvc, sb, H, dh)
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)  # noqa: E731
    lib_err = max_err(sdpa().transpose(1, 2).reshape(plain.shape), plain)
    if not lib_err <= TOL:
        raise AssertionError(f"the one-call token-row yardstick differs by {lib_err}")
    kernel = lambda: tr.token_rows_attention_cuda(qkv, qkvc, sb, **kw)  # noqa: E731
    dev = device_ms(kernel, launches=launches)
    return {
        "shape": _token_rows_shape(G, L, masked, calls), "calls": calls, "max_abs_err": err,
        "ms": dev, "device_ms": dev, "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: tr.token_rows_attention_plain(qkv, qkvc, sb, **kw)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa),
        "library_host_ms": time_ms(sdpa),
        "library": "scaled_dot_product_attention over (B*G, H, L, 1+L)",
        "library_max_abs_err": lib_err,
    }


def _token_rows_launches(smi, name, call, shape, launches):
    """Two reruns must give the same bits, and one call's device time by CUDA
    launch under ``torch.profiler``, exactly ``launches`` kernels."""
    import torch

    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)  # noqa: E731
    first = as_tuple(call())
    bitwise = all(all(torch.equal(a, b) for a, b in zip(as_tuple(call()), first))
                  for _ in range(2))
    emit({"phase": "kernel_bitwise", "name": name, "shape": shape, "card": smi, "reruns": 2,
          "outputs_bitwise_equal": bitwise})
    if not bitwise:
        raise AssertionError(f"{name} gave other bits on a rerun at {shape}")
    emit({"phase": "kernel_launches", "name": name, "shape": shape, "card": smi,
          "launches_per_call": launches, **_profile(call, launches=launches)})


def _token_rows_rows(smi, gen):
    """The token-row forward kernel at ``TOKEN_ROWS_CASES``, and at each
    shape its reruns and launches profiled on inputs from a generator of
    their own, so the rows keep theirs."""
    import torch

    from mintime_torch.ops import token_rows as tr

    out, own = [], torch.Generator().manual_seed(12)
    for case in TOKEN_ROWS_CASES:
        G, L, masked, calls = case
        launches = tr.plan(8, G, L, 6)["fwd_launches"]
        out.append(_token_rows_row(case, gen, launches))
        qkv, qkvc, sb = _token_rows_inputs(own, G, masked, F=L)
        _token_rows_launches(
            smi, "token_rows_attention",
            lambda: tr.token_rows_attention_cuda(qkv, qkvc, sb, heads=6, dim_head=64),
            _token_rows_shape(G, L, masked, calls), launches)
        del qkv, qkvc, sb
    return out


def _grouped_inputs(gen, G, L, masked, B=8, H=8, D=64):
    """Flagship-width q (pre-scaled), k, v (B, H, G, L, D; v at scale 0.5,
    so outputs stay below 2 and one bf16 step below 2e-2), the CLS k and v
    in bf16, and with ``masked`` the mask of ``tests/test_pallas_attention.py:
    22-26`` (keys dropped at random, the CLS column and each row's own key
    kept) as (bool mask, fp32 bias)."""
    import torch

    from mintime_torch.ops.divided_attention import mask_to_bias

    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    q, k, v = r(B, H, G, L, D, sc=D ** -0.5), r(B, H, G, L, D), r(B, H, G, L, D, sc=0.5)
    kc, vc = r(B, H, 1, D), r(B, H, 1, D)
    mask = None
    if masked:
        mask = torch.rand(B, L, 1 + L, generator=gen) > 0.3
        mask[..., 0] = True
        mask[:, torch.arange(L), 1 + torch.arange(L)] = True
        mask = mask.cuda()
    return (q, k, v, kc, vc, None if mask is None else mask_to_bias(mask)), mask


def _grouped_row(args, mask, H, calls, tag=""):
    """The grouped-attention kernel vs its plain version on ``args``, its
    time, the plain version's, the bound and one SDPA call over the groups
    with the CLS key prepended."""
    import torch
    import torch.nn.functional as F

    from mintime_torch.ops import grouped_attention as ga

    q, k, v, kc, vc, bias = args
    B, _, G, L, D = q.shape
    plain = ga.fused_grouped_attention_plain(*args, heads=H)
    err = max_err(ga.fused_grouped_attention_cuda(*args, heads=H), plain)
    # read q, k, v, k_cls, v_cls and the bias, write out
    nbytes = 2 * (4 * q.numel() + 2 * kc.numel()) + 4 * _numel(bias)
    b_ms, b_by = bound(nbytes, 4 * B * H * G * L * (1 + L) * D)
    lq = q.reshape(B, H * G, L, D)
    lk, lv = (torch.cat([c[:, :, None].expand(B, H, G, 1, D), t], dim=3)
              .reshape(B, H * G, 1 + L, D) for c, t in ((kc, k), (vc, v)))
    lmask = None if mask is None else mask[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask, scale=1.0)  # noqa: E731
    kernel = lambda: ga.fused_grouped_attention_cuda(*args, heads=H)  # noqa: E731
    return {  # device times, as for the divided attention
        "shape": f"{tag}B={B} H={H} G={G} L={L} D={D}" + (" masked" if mask is not None else ""),
        "calls": calls, "max_abs_err": err, "ms": device_ms(kernel), "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: ga.fused_grouped_attention_plain(*args, heads=H)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa),
        "library": "scaled_dot_product_attention over (B, H*G, L, 1+L), CLS prepended",
        "library_max_abs_err": max_err(sdpa().reshape(plain.shape), plain),
    }


def _grouped_reruns():
    """At flagship width on both axes, masked, two reruns of the grouped
    kernel must give the same bits."""
    import torch

    from mintime_torch.ops import grouped_attention as ga

    gen = torch.Generator().manual_seed(13)
    for G, L in ((49, 16), (16, 49)):
        args, _ = _grouped_inputs(gen, G, L, True)
        first = ga.fused_grouped_attention_cuda(*args, heads=8)
        bitwise = all(torch.equal(ga.fused_grouped_attention_cuda(*args, heads=8), first)
                      for _ in range(2))
        shape = f"B=8 H=8 G={G} L={L} D=64 masked"
        emit({"phase": "kernel_bitwise", "name": "grouped_attention", "shape": shape,
              "reruns": 2, "out_bitwise_equal": bitwise})
        if not bitwise:
            raise AssertionError(f"grouped_attention gave other bits on a rerun at {shape}")


#: (G, L, D, masked) of the grouped kernel's edges: one key, one past a
#: 16-row tile, the longest group, and a head width that is no multiple of 8;
#: masked ones also mask every token key of some rows
GROUPED_EDGES = ((8, 1, 64, False), (8, 17, 64, True), (8, 33, 64, False), (4, 64, 64, True),
                 (16, 49, 30, True))


def _grouped_edge_inputs(gen, G, L, D, masked, B=2, H=8):
    """As :func:`_grouped_inputs` at the edge shapes; a masked case drops
    every token key of every third row of the first video (the CLS key
    kept)."""
    import torch

    from mintime_torch.ops.divided_attention import mask_to_bias

    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    q, k, v = r(B, H, G, L, D, sc=D ** -0.5), r(B, H, G, L, D), r(B, H, G, L, D, sc=0.5)
    kc, vc = r(B, H, 1, D), r(B, H, 1, D)
    mask = None
    if masked:
        mask = torch.rand(B, L, 1 + L, generator=gen) > 0.3
        mask[..., 0] = True
        mask[0, ::3, 1:] = False
        mask = mask.cuda()
    return (q, k, v, kc, vc, None if mask is None else mask_to_bias(mask)), mask


#: (G, L, P, B, masked row, calls) of the chunked attention's rows: the
#: attention probe's two axes at its packing (B = 32, each launched once by
#: the probe's row), then its edges with no calls: G no multiple of P, an odd
#: L padded to Lp > L, a tile of 128 rows, more CLS-row keys (G*L) than one
#: block's shared memory holds, and a video whose token keys are all masked
#: but the CLS key (its CLS row sees only itself)
CHUNKED_CASES = (("time", 49, 16, 4, 32, False, 1), ("space", 16, 49, 2, 32, False, 1))
CHUNKED_EDGES = (("edge", 13, 16, 4, 2, False, 0), ("edge", 10, 13, 3, 2, False, 0),
                 ("edge", 49, 16, 8, 2, False, 0), ("edge", 112, 128, 1, 2, False, 0),
                 ("edge", 16, 49, 2, 2, True, 0))
CHUNKED_CASES += CHUNKED_EDGES


def _chunked_inputs(case):
    """The attention probe's inputs (``make_inputs``, numpy seed 0: about a
    tenth of the keys masked) at a case's shape, and the call's keywords;
    a masked row masks every token key of video 0, token rows and CLS row,
    and keeps the CLS key of its token rows."""
    from mintime_torch.experiments import attn_kernel_variants as attn_probe
    from mintime_torch.ops.divided_attention import NEG

    _, G, L, P, B, masked_row, _ = case
    qkv, qkvc, sb, rb = attn_probe.make_inputs(G, L, batch=B)
    if masked_row:
        sb[0, :, 0], sb[0, :, 1:] = 0.0, NEG
        rb[0] = NEG
    return (qkv, qkvc, sb, rb), dict(heads=attn_probe.H, dim_head=attn_probe.DH, P=P)


def _chunked_row(case):
    """The chunked attention against its plain version (limit 2e-2 at the
    probe's axes, 2e-2 * max(1, max |plain|) at the edges), two reruns
    bitwise equal or not, its device time
    (``ms``; ``host_ms`` by CUDA events beside it), the plain version's, the
    bound and one dense masked ``scaled_dot_product_attention`` call (the
    probe's variant D) by device time."""
    import torch
    import torch.nn.functional as F

    from mintime_torch.experiments import attn_kernel_variants as attn_probe
    from mintime_torch.ops import chunked_attention as ca
    from mintime_torch.ops import divided_attention as da

    tag, G, L, P, B, masked_row, calls = case
    args, kw = _chunked_inputs(case)
    qkv, qkvc, sb, rb = args
    H, dh = kw["heads"], kw["dim_head"]
    kernel = lambda: ca.chunked_attention_cuda(*args, **kw)  # noqa: E731
    plain = ca.chunked_attention_plain(*args, **kw)
    got = kernel()
    top = max(float(p.float().abs().max()) for p in plain)
    bitwise = all(all(torch.equal(a, b) for a, b in zip(kernel(), got)) for _ in range(2))
    # read qkv, the CLS row's qkv and both biases once, write both outputs;
    # the work of the divided attention (the dense tiles' masked products
    # are no part of the function)
    nbytes = (2 * (qkv.numel() + qkvc.numel() + plain[0].numel() + plain[1].numel())
              + 4 * (sb.numel() + rb.numel()))
    b_ms, b_by = bound(nbytes, 4 * B * H * dh * (G * L * (1 + L) + G * L + 1))
    lq, lk, lv, lmask = attn_probe.dense_inputs(qkv, qkvc, sb, rb)
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)  # noqa: E731
    row = {
        "shape": f"{tag} B={B} G={G} L={L} H={H} dh={dh} P={P} Lp={ca.padded_sizes(G, L, P)[1]}"
                 + (" masked row" if masked_row else ""),
        "calls": calls, "max_abs_err": max_err(got, plain), "max_plain": top,
        "limit": TOL if calls else TOL * max(1.0, top), "bitwise_reruns": bitwise,
        "ms": device_ms(kernel), "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: ca.chunked_attention_plain(*args, **kw), iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(sdpa, iters=5),
        "library": "scaled_dot_product_attention, one dense masked call",
        "library_max_abs_err": max_err(attn_probe.split_dense(sdpa(), G, L), plain),
        "kernel_vs_divided_plain": max_err(
            got, da.divided_attention_plain(qkv, qkvc, sb, rb, heads=H, dim_head=dh)),
    }
    del args, qkv, qkvc, sb, rb, plain, got, lq, lk, lv, lmask
    torch.cuda.empty_cache()
    return row


#: images a row of Xception's depthwise kernel takes (the predict phase's
#: forward holds about as many faces; the probe times 1,536)
XC_DW_IMAGES = 256


def _xc_dw_rows():
    """Xception's depthwise 3 x 3 kernel against its plain version at each
    depthwise shape of Xception at 224 px (the probe's ``GEOMS``), ReLU on
    and off, at ``XC_DW_IMAGES`` images: within one bf16 rounding of the
    largest output (the kernel and the plain version each round one fp32
    sum), reruns bitwise equal, with its time, its bound and cuDNN's (after
    the ReLU's pass where the layer has one). ``calls`` is the shape's count
    in one Xception forward for the ReLU the layer has, 0 for the other."""
    import torch

    from mintime_torch.experiments import dw_conv3x3_cuda_vs_cudnn as xc_probe
    from mintime_torch.ops import dw_conv

    rows = []
    for H_, W_, C, count, has_relu in xc_probe.GEOMS:
        x, w = xc_probe.make_inputs(H_, W_, C, n=XC_DW_IMAGES)
        b_ms, b_by = xc_probe.bound(x)
        for relu in (has_relu, not has_relu):
            got = dw_conv.dw_conv3x3_cuda(x, w, relu=relu)
            plain = dw_conv.dw_conv3x3_plain(x, w, relu=relu)
            top = float(plain.float().abs().max())
            rows.append({
                "shape": f"N={XC_DW_IMAGES} {H_}x{W_} C={C} relu={int(relu)}",
                "calls": count if relu == has_relu else 0,
                "plan": dw_conv.plan(H_, W_, C, 3),
                "max_abs_err": max_err(got, plain), "max_plain": top, "limit": 2 ** -7 * top,
                "bitwise_reruns": all(torch.equal(dw_conv.dw_conv3x3_cuda(x, w, relu=relu), got)
                                      for _ in range(2)),
                "ms": time_ms(lambda: dw_conv.dw_conv3x3_cuda(x, w, relu=relu)),
                "plain_ms": time_ms(lambda: dw_conv.dw_conv3x3_plain(x, w, relu=relu), iters=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lambda: xc_probe.cudnn_dwconv(x, w, relu)),
                "library": "cuDNN F.conv2d(groups=C), channels-last, after F.relu where relu",
                "library_max_abs_err": max_err(xc_probe.cudnn_dwconv(x, w, relu), plain),
            })
            if not rows[-1]["bitwise_reruns"]:
                raise AssertionError(f"conv3x3 gave other bits on a rerun at {rows[-1]['shape']}")
            del got, plain
        del x, w
        torch.cuda.empty_cache()
    return rows


def _probe_kernel_rows(gen):
    """The probes' kernels against their plain versions, with their times,
    bounds and library calls: the grouped attention at flagship width, the
    chunked attention at the attention probe's size and packing and at its
    edges (``CHUNKED_CASES``; reruns bitwise equal, one call at each probe
    axis profiled by launch), the depthwise forward and weight gradient at
    the dw probes' 512 images and geometries (limits 2e-2 * max(1, max
    |plain|) and 2e-2 * max |plain|)."""
    import torch

    from mintime_torch.experiments import dw_conv_bwd_cuda_vs_cudnn as dwb_probe
    from mintime_torch.experiments import dw_conv_cuda_vs_cudnn as dwf_probe
    from mintime_torch.ops import chunked_attention as ca
    from mintime_torch.ops import dw_conv

    rows = {"grouped_attention": [], "chunked_attention": [], "dw_conv": [], "dw_conv_wgrad": []}
    H = 8
    for (G, L) in ((49, 16), (16, 49)):
        for masked in (True, False):
            args, mask = _grouped_inputs(gen, G, L, masked)
            rows["grouped_attention"].append(_grouped_row(args, mask, H, 1))
            del args, mask
    # the kernel's edges, held against the plain version only: no path
    # launches these shapes
    edge_gen = torch.Generator().manual_seed(12)
    for G, L, D, masked in GROUPED_EDGES:
        args, mask = _grouped_edge_inputs(edge_gen, G, L, D, masked)
        rows["grouped_attention"].append(_grouped_row(args, mask, 8, 0, "edge "))
        del args, mask
    _grouped_reruns()

    for case in CHUNKED_CASES:
        row = _chunked_row(case)
        rows["chunked_attention"].append(row)
        if not row["bitwise_reruns"]:
            raise AssertionError(f"chunked_attention gave other bits on a rerun at {row['shape']}")
        if row["calls"]:
            args, kw = _chunked_inputs(case)
            emit({"phase": "kernel_launches", "name": "chunked_attention", "shape": row["shape"],
                  **_profile(lambda: ca.chunked_attention_cuda(*args, **kw))})
            del args
    torch.cuda.empty_cache()

    for H_, W_, C, K, _ in dwf_probe.GEOMS:
        x, w, b = dwf_probe.make_inputs(H_, W_, C, K)
        plain = dw_conv.dw_conv_bias_silu_plain(x, w, b, K=K)
        top = float(plain.float().abs().max())
        w_lib = w.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous()
        b_lib = b.to(torch.bfloat16)
        b_ms, b_by = dwf_probe.bound(x, K)
        rows["dw_conv"].append({
            "shape": f"N={x.shape[0]} {H_}x{W_} C={C} K={K}", "calls": 1,
            "max_abs_err": max_err(dw_conv.dw_conv_bias_silu_cuda(x, w, b, K=K), plain),
            "max_plain": top, "limit": TOL * max(1.0, top),
            "ms": time_ms(lambda: dw_conv.dw_conv_bias_silu_cuda(x, w, b, K=K)),
            "plain_ms": time_ms(lambda: dw_conv.dw_conv_bias_silu_plain(x, w, b, K=K), iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: dwf_probe.cudnn_dwconv(x, w_lib, b_lib, K)),
            "library": "cuDNN F.conv2d(groups=C) with bias, channels-last, then F.silu",
            "library_max_abs_err": max_err(dwf_probe.cudnn_dwconv(x, w_lib, b_lib, K), plain),
        })
        del x, w, b, plain, w_lib, b_lib
        torch.cuda.empty_cache()

    for tag, H_, C, K, stride in dwb_probe.GEOMS:
        if stride != 1:
            continue
        x, dy, w = dwb_probe.make_inputs(H_, C, K, stride)
        plain = dw_conv.dw_conv_wgrad_plain(x, dy, K=K)
        top = float(plain.abs().max())
        b_ms, b_by = dwb_probe.bound(x, dy, K)
        lib = lambda: dwb_probe.cudnn_backward(x, dy, w, 1, (False, True))  # noqa: E731
        rows["dw_conv_wgrad"].append({
            "shape": f"{tag.split()[0]} N={x.shape[0]} {H_}x{H_} C={C} K={K}", "calls": 1,
            "max_abs_err": max_err(dw_conv.dw_conv_wgrad_cuda(x, dy, K=K), plain),
            "max_plain": top, "limit": TOL * top,
            "ms": time_ms(lambda: dw_conv.dw_conv_wgrad_cuda(x, dy, K=K)),
            "plain_ms": time_ms(lambda: dw_conv.dw_conv_wgrad_plain(x, dy, K=K), iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(lib),
            "library": "cuDNN weight gradient, aten.convolution_backward, bf16, channels-last",
            "library_max_abs_err": max_err(lib()[1].permute(2, 3, 1, 0), plain),
        })
        del x, dy, w, plain
        torch.cuda.empty_cache()
    return rows


def _grad_err(names, got, want) -> list[dict]:
    """Per gradient: its max abs error, the plain version's max |value| and
    the limit 2e-2 * max(1, max |plain|)."""
    rows = []
    for n, g, w in zip(names, got, want):
        top = float(w.float().abs().max())
        rows.append({"grad": n, "max_abs_err": float((g.float() - w.float()).abs().max()),
                     "max_plain": top, "limit": TOL * max(1.0, top)})
    return rows


def _divided_bwd_row(shape, args, H, calls, gen, launches=None):
    """The backward kernel vs its plain version (per gradient, unit-scale
    cotangents), its device time (``ms``: the kernels' durations under
    ``torch.profiler``, ``launches`` kernels a call where that is given;
    ``host_ms`` by CUDA events over back-to-back calls, which reads the host
    where the kernels finish sooner than the wrapper issues them), the plain
    version's, the bound and the backward of one dense masked SDPA call, by
    device time too (``library_host_ms`` beside it)."""
    import torch
    import torch.nn.functional as F

    from mintime_torch.experiments.attn_kernel_variants import dense_inputs
    from mintime_torch.ops import divided_attention as da

    qkv, qkvc, sb, rbias = args
    B, G, L, _ = qkv.shape
    dh = 64
    inner = H * dh
    r = lambda *s: torch.randn(*s, generator=gen).cuda().bfloat16()  # noqa: E731
    d_tok, d_cls = r(B, G, L, inner), r(B, 1, inner)
    kw = dict(heads=H, dim_head=dh)
    fwd_args = (qkv, qkvc, sb, rbias, d_tok, d_cls)
    got = da.divided_attention_bwd_cuda(*fwd_args, **kw)
    want = da.divided_attention_bwd_plain(*fwd_args, **kw)
    grads = _grad_err(("d_qkv", "d_qkvc"), got, want)
    differing = float((got[0] != want[0]).float().mean())
    del got, want
    nbytes = (2 * (2 * qkv.numel() + 2 * qkvc.numel() + d_tok.numel() + d_cls.numel())
              + 4 * _numel(sb, rbias))
    T = 1 + L  # token rows: logits, dP, dq over T keys; dk, dv over L; CLS row over G*L keys
    flops = 2 * B * H * dh * (G * L * (3 * T + 2 * L) + 4 * G * L)
    b_ms, b_by = bound(nbytes, flops)
    lq, lk, lv, lmask = (t.requires_grad_() if t.dtype != torch.bool else t
                         for t in dense_inputs(qkv, qkvc, sb, _dense_row_bias(rbias, B, G), H, dh))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)
    lgrad = r(*lout.shape)
    sdpa_bwd = lambda: torch.autograd.grad(lout, (lq, lk, lv), lgrad, retain_graph=True)  # noqa: E731
    kernel = lambda: da.divided_attention_bwd_cuda(*fwd_args, **kw)  # noqa: E731
    dev = device_ms(kernel, launches=launches)
    return {
        "shape": shape, "calls": calls,
        "max_abs_err": max(g["max_abs_err"] for g in grads), "grads": grads,
        "ms": dev, "device_ms": dev, "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: da.divided_attention_bwd_plain(*fwd_args, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(sdpa_bwd), "library_host_ms": time_ms(sdpa_bwd),
        "library": "backward of one dense masked scaled_dot_product_attention call",
        # P and dS enter the tensor-core products as bf16 hi/lo pairs: few
        # bf16 values of d_qkv differ from the fp32 plain version's (about
        # 40% would if P and dS were rounded once to bf16)
        "d_qkv_differing": differing, "differing_limit": DIFFERING_LIMIT,
    }


#: largest share of the backward's bf16 d_qkv values that may differ from
#: the fp32 plain version's
DIFFERING_LIMIT = 0.05
#: CUDA kernels a backward call launches: the CLS row's logits, chunk sums
#: and finish, the token rows' row and column launches, the reduce
DIVIDED_BWD_LAUNCHES = 6

#: (L, seq mask) of the backward's edge rows: one key (four groups a
#: block), one past a 16-row tile (17: two groups a block; 33: one group on
#: three warps), masked one short of a full 64-row tile (63), one past a
#: 64-row chunk (65, 129) and, masked, a ragged last tile (200)
BWD_EDGE_AXES = ((1, False), (17, False), (33, False), (63, True), (65, False), (129, False),
                 (200, True))


def _edge_inputs(gen, L, masked, B=8, G=8, H=6, dh=64):
    """The conv space axis at L tokens; if ``masked``, a random seq mask (the
    CLS key kept) and a CLS-row bias masking the last 3 frames of every
    other video."""
    import torch

    from mintime_torch.ops.divided_attention import NEG, mask_to_bias

    qkv = torch.randn(B, G, L, 3 * H * dh, generator=gen).cuda().bfloat16()
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    if not masked:
        return qkv, qkvc, None, None
    keep = torch.rand(B, L, 1 + L, generator=gen) > 0.1
    keep[..., 0] = True
    rb = torch.zeros(B, G, 1, device="cuda")
    rb[::2, G - 3:] = NEG
    return qkv, qkvc, mask_to_bias(keep.cuda()), rb


def _divided_bwd_rerun_and_launches(smi, gen):
    """At the tap-10 space axis (G = 8 groups of L = 192) and the flagship
    space axis (B = 8, G = 16 groups of L = 49, 8 heads, masked frames): two
    reruns of the backward must give the same bits, and one call's device
    time by CUDA launch (the CLS row's three launches, the token rows' row
    and column launches, the reduce) under ``torch.profiler``."""
    import torch

    from mintime_torch.ops import divided_attention as da

    for args in (_edge_inputs(gen, 192, False), _attention_inputs("space", gen)):
        qkv, qkvc, sb, rb = args
        B, G, L, c3 = qkv.shape
        H = c3 // (3 * 64)
        d_tok = torch.randn(B, G, L, H * 64, generator=gen).cuda().bfloat16()
        d_cls = torch.randn(B, 1, H * 64, generator=gen).cuda().bfloat16()
        call = lambda: da.divided_attention_bwd_cuda(qkv, qkvc, sb, rb, d_tok, d_cls,  # noqa: E731
                                                     heads=H, dim_head=64)
        first = call()
        bitwise = all(all(torch.equal(a, b) for a, b in zip(call(), first)) for _ in range(2))
        shape = f"B={B} G={G} L={L} H={H} dh=64"
        emit({"phase": "kernel_bitwise", "name": "divided_attention_bwd", "shape": shape,
              "card": smi, "reruns": 2, "d_qkv_and_d_qkvc_bitwise_equal": bitwise})
        if not bitwise:
            raise AssertionError(f"divided_attention_bwd gave other bits on a rerun at {shape}")
        emit({"phase": "kernel_launches", "name": "divided_attention_bwd", "shape": shape,
              "card": smi, **_profile(call, launches=DIVIDED_BWD_LAUNCHES)})


def _divided_fwd_rerun_and_launches(smi, L=192):
    """At the tap-10 space axis (G = 8 groups of L = 192, 6 x 64 heads): two
    reruns of the forward must give the same bits, and one call's device
    time by CUDA launch (the token rows and the CLS row's launches) under
    ``torch.profiler``. Its inputs come from a generator of their own, so
    the rows after it keep theirs."""
    import torch

    from mintime_torch.ops import divided_attention as da

    qkv, qkvc, sb, rb = _edge_inputs(torch.Generator().manual_seed(8), L, False)
    B, G, _, c3 = qkv.shape
    H = c3 // (3 * 64)
    call = lambda: da.divided_attention_cuda(qkv, qkvc, sb, rb, heads=H, dim_head=64)  # noqa: E731
    first = call()
    bitwise = all(all(torch.equal(a, b) for a, b in zip(call(), first)) for _ in range(2))
    shape = f"B={B} G={G} L={L} H={H} dh=64"
    emit({"phase": "kernel_bitwise", "name": "divided_attention", "shape": shape,
          "card": smi, "reruns": 2, "out_and_out_cls_bitwise_equal": bitwise})
    if not bitwise:
        raise AssertionError(f"divided_attention gave other bits on a rerun at {shape}")
    emit({"phase": "kernel_launches", "name": "divided_attention", "shape": shape,
          "card": smi, **_profile(call)})


#: the FFN backward's row counts off its 128-row tiles, by model width
#: (no main path launches them): one row, a ragged tile with split
#: weight-gradient products, and one tile past the flagship's token rows
FFN_BWD_EDGE_ROWS = {512: (1, 100, 6272 + 8), 256: (1, 100)}
#: the row counts whose backward is rerun for bits and profiled by launch:
#: the flagship's and the conv model's token rows
FFN_BWD_PROFILED = (8 * 16 * 49, 8 * 8 * 1280)
#: CUDA kernels a backward call launches: dh, the three products, the reduce
FFN_BWD_LAUNCHES = 3


def _ffn_bwd_row(args, calls, tag="", launches=FFN_BWD_LAUNCHES):
    """The FFN backward vs its plain version (per gradient), its device time
    (``ms``: the kernels' durations under ``torch.profiler``, ``launches``
    kernels a call; ``host_ms``, by CUDA events over back-to-back calls,
    reads the host where the kernels finish sooner than the wrapper issues
    them), the plain version's and the bound."""
    from mintime_torch.ops import geglu_ffn as ffn

    x, w0, b0, w1, dout = args
    m, dim = x.shape
    grads = _grad_err(("dx", "dw0", "db0", "dw1", "db1"), ffn.geglu_ffn_bwd_cuda(*args),
                      ffn.geglu_ffn_bwd_plain(*args))
    # read x, W0, b0, W1, dout; write dx (bf16) and the fp32 weight and bias gradients
    nbytes = (2 * (2 * m * dim + w0.numel() + b0.numel() + w1.numel() + m * dim)
              + 4 * (w0.numel() + b0.numel() + w1.numel() + dim))
    flops = 2 * m * dim * 8 * w1.shape[1]  # h, dprod, dx, dW0 (2H wide) and dW1 (H wide)
    b_ms, b_by = bound(nbytes, flops)
    call = lambda: ffn.geglu_ffn_bwd_cuda(*args)  # noqa: E731
    dev = device_ms(call, launches=launches)
    return {
        "shape": f"{tag}D={dim} H={w1.shape[1]} M={m}", "calls": calls,
        "max_abs_err": max(g["max_abs_err"] for g in grads), "grads": grads,
        "ms": dev, "device_ms": dev, "host_ms": time_ms(call),
        "plain_ms": device_ms(lambda: ffn.geglu_ffn_bwd_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def _ffn_bwd_rerun_and_launches(smi, args):
    """Two reruns of the FFN backward must give the same bits of every
    gradient, and three calls' device time by CUDA launch (the dh kernel,
    the products, the reduce) under ``torch.profiler``."""
    import torch

    from mintime_torch.ops import geglu_ffn as ffn

    call = lambda: ffn.geglu_ffn_bwd_cuda(*args)  # noqa: E731
    first = call()
    bitwise = all(all(torch.equal(a, b) for a, b in zip(call(), first)) for _ in range(2))
    x, w1 = args[0], args[3]
    shape = f"D={x.shape[1]} H={w1.shape[1]} M={x.shape[0]}"
    emit({"phase": "kernel_bitwise", "name": "geglu_ffn_bwd", "shape": shape, "card": smi,
          "reruns": 2, "dx_dw0_db0_dw1_db1_bitwise_equal": bitwise})
    if not bitwise:
        raise AssertionError(f"geglu_ffn_bwd gave other bits on a rerun at {shape}")
    # each launch's time is its total over the three calls in the window
    emit({"phase": "kernel_launches", "name": "geglu_ffn_bwd", "shape": shape, "card": smi,
          "calls_in_window": 3,
          **_profile(lambda: [call() for _ in range(3)], launches=3 * FFN_BWD_LAUNCHES, calls=3)})


def _backward_kernels(smi, gen):
    """Each backward kernel vs its plain version at the flagship shapes of a
    train step at batch 8, with seeded unit-scale cotangents, so that every
    gradient's largest value exceeds 1 and the limit is 2e-2 of it."""
    import torch

    from mintime_torch.ops import geglu_ffn as ffn

    rows = {"geglu_ffn_bwd": [], "divided_attention_bwd": []}
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # launches per train step: the last layer's token FFN gets no gradient
    for dim, hidden, shapes in FFN_SHAPES:
        w0, b0, w1, _ = _ffn_weights(r, dim, hidden)
        # the split-K edges (row counts off the 128-row tiles), no calls
        edges = [(m, 0) for m in FFN_BWD_EDGE_ROWS[dim]]
        for m, calls in [(m, c) for m, _, c in shapes] + edges:
            x, dout = r(m, dim), r(m, dim)
            args = (x, w0, b0, w1, dout)
            rows["geglu_ffn_bwd"].append({**_ffn_bwd_row(args, calls, "" if calls else "edge "),
                                          "splits": ffn.product_splits(m, dim, hidden, sms)})
            if m in FFN_BWD_PROFILED:
                _ffn_bwd_rerun_and_launches(smi, args)
            del x, dout, args
    tp_gen = torch.Generator().manual_seed(TP_SEED)
    r_tp = lambda *s, sc=1.0: (torch.randn(*s, generator=tp_gen) * sc).cuda().bfloat16()  # noqa: E731
    for dim, hidden, shapes in FFN_TP_SHAPES:
        w0, b0, w1, _ = _ffn_weights(r_tp, dim, hidden)
        for m, _, calls in shapes:
            args = (r_tp(m, dim), w0, b0, w1, r_tp(m, dim))
            rows["geglu_ffn_bwd"].append({**_ffn_bwd_row(args, calls, "tp2 "),
                                          "splits": ffn.product_splits(m, dim, hidden, sms)})

    for shape, args, H, _, calls in _divided_cases(gen):
        rows["divided_attention_bwd"].append(_divided_bwd_row(shape, args, H, calls, gen,
                                                              DIVIDED_BWD_LAUNCHES))
        del args
    # the token-row launches' tile edges (group packs, 16-row tiles, 64-row
    # chunks), held against the plain version only: no main path launches
    # these shapes
    for L, masked in BWD_EDGE_AXES:
        args = _edge_inputs(gen, L, masked)
        rows["divided_attention_bwd"].append(_divided_bwd_row(
            f"edge B=8 G=8 L={L} H=6 dh=64 seq_bias={masked}", args, 6, 0, gen,
            DIVIDED_BWD_LAUNCHES))
        del args
    _divided_bwd_rerun_and_launches(smi, gen)

    rows["token_rows_attention_bwd"] = _token_rows_bwd_rows(smi, gen)
    for name, shapes in rows.items():
        for s in shapes:
            emit({"phase": "kernel", "name": name, "card": smi, **s})
            off = [g for g in s["grads"] if not g["max_abs_err"] <= g["limit"]]
            if off:
                raise AssertionError(f"{name} {s['shape']}: gradients off by more than"
                                     f" {TOL} * max(1, max |plain|): {off}")
            if s.get("differing_limit") and not s["d_qkv_differing"] <= s["differing_limit"]:
                raise AssertionError(f"{name} {s['shape']}: {s['d_qkv_differing']:.1%} of d_qkv"
                                     " differs from the plain version in bf16")
    return rows


def _token_rows_bwd_inputs(gen, case):
    """qkv, qkv_cls and seq_bias of ``_token_rows_inputs`` at one of
    ``TOKEN_ROWS_CASES`` and a unit-scale cotangent, which arrives as the
    transposed view of the natural layout, as in the model."""
    import torch

    G, L, masked, _ = case
    qkv, qkvc, sb = _token_rows_inputs(gen, G, masked, F=L)
    B = qkv.shape[0]
    d_tok = torch.randn(B, L, G, 6 * 64, generator=gen).cuda().bfloat16().transpose(1, 2)
    return qkv, qkvc, sb, d_tok


def _token_rows_bwd_row(case, gen, launches=None):
    """The token-row backward kernel at one of ``TOKEN_ROWS_CASES`` against
    its plain version per gradient (unit-scale cotangents), its device time
    (``ms``, ``launches`` kernels a call where that is given; ``host_ms``
    beside it), the plain version's, the bound and the backward of one
    ``scaled_dot_product_attention`` call over the same groups by device
    time (``library_host_ms`` beside it)."""
    import torch

    from mintime_torch.ops import token_rows as tr

    G, L, masked, calls = case
    H, dh = 6, 64
    args = _token_rows_bwd_inputs(gen, case)
    qkv, qkvc, sb, d_tok = args
    B = qkv.shape[0]
    kw = dict(heads=H, dim_head=dh)
    got = tr.token_rows_attention_bwd_cuda(*args, **kw)
    if got[1][..., :H * dh].any():
        raise AssertionError("token_rows_attention_bwd: the CLS query got a gradient")
    grads = _grad_err(("d_qkv", "d_qkvc"), got, tr.token_rows_attention_bwd_plain(*args, **kw))
    del got
    nbytes = (2 * (2 * qkv.numel() + 2 * qkvc.numel() + d_tok.numel())
              + 4 * (0 if sb is None else sb.numel()))
    T = 1 + L  # logits, dP and dq over T keys; dK and dV over L rows; dk_cls, dv_cls
    flops = 2 * B * G * H * dh * (3 * L * T + 2 * L * L + 2 * L)
    b_ms, b_by = bound(nbytes, flops)
    lq, lk, lv, lmask = _token_rows_as_sdpa(qkv, qkvc, sb, H, dh)
    lq, lk, lv = (t.requires_grad_() for t in (lq, lk, lv))
    lout = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask)
    lgrad = torch.randn(lout.shape, generator=gen).cuda().bfloat16()
    sdpa_bwd = lambda: torch.autograd.grad(lout, (lq, lk, lv), lgrad, retain_graph=True)  # noqa: E731
    kernel = lambda: tr.token_rows_attention_bwd_cuda(*args, **kw)  # noqa: E731
    dev = device_ms(kernel, launches=launches)
    return {
        "shape": _token_rows_shape(G, L, masked, calls), "calls": calls,
        "max_abs_err": max(g["max_abs_err"] for g in grads), "grads": grads,
        "ms": dev, "device_ms": dev, "host_ms": time_ms(kernel),
        "plain_ms": device_ms(lambda: tr.token_rows_attention_bwd_plain(*args, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(sdpa_bwd), "library_host_ms": time_ms(sdpa_bwd),
        "library": "backward of scaled_dot_product_attention over (B*G, H, L, 1+L)",
    }


def _token_rows_bwd_rows(smi, gen):
    """The token-row backward kernel at ``TOKEN_ROWS_CASES``, and at each
    shape its reruns and launches profiled on inputs from a generator of
    their own, so the rows keep theirs."""
    import torch

    from mintime_torch.ops import token_rows as tr

    out, own = [], torch.Generator().manual_seed(13)
    for case in TOKEN_ROWS_CASES:
        G, L, masked, calls = case
        launches = tr.plan(8, G, L, 6)["bwd_launches"]
        out.append(_token_rows_bwd_row(case, gen, launches))
        args = _token_rows_bwd_inputs(own, case)
        _token_rows_launches(
            smi, "token_rows_attention_bwd",
            lambda: tr.token_rows_attention_bwd_cuda(*args, heads=6, dim_head=64),
            _token_rows_shape(G, L, masked, calls), launches)
        del args
    return out


def _synthetic_videos(n_videos, seed):
    """In-memory videos with up to two faces and boxes sized so every square
    crop is exactly 224 px (the val transform then only uploads it). Face A
    sits in the top-left corner, face B in the bottom-right; each is tinted
    so the stand-in embedder tells them apart."""
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
    t0 = time.perf_counter()
    results, counts = _step_launches(lambda: predict.predict_assembled(staged, model, None, cfg))
    first_s = time.perf_counter() - t0
    want = {"divided_attention": 16, "geglu_ffn": 18, "token_rows_attention": 0,
            **NO_OTHER_LAUNCHES}
    launches = {k: counts[k] for k in want}
    if launches != want:
        raise AssertionError(f"launches per forward {launches}, want 16 attention (whole-slice),"
                             " 18 FFN, 0 token rows and none of the probes' kernels")

    # what came out: probabilities, per-identity attention, aggregated maps
    assert len(results) == 8
    for res, k in zip(results, n_ids):
        assert 0.0 <= res.probability <= 1.0 and np.isfinite(res.probability)
        assert len(res.identity_attentions) == k
        for a in res.aggregated_attentions:
            assert a.shape == (16,) and abs(float(a.sum()) - 1.0) < 1e-6

    # kernel mode vs plain mode on the same batch and weights
    stacked = predict.stack_inputs(staged)
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


# 3b. detect: the port's face detector and embedder at DFDC's frame size
DETECT_VIDEOS = 8
DETECT_FRAMES = 150  # 5 s at 30 fps
DETECT_FPS = 30
DETECT_SIZE = (1080, 1920)  # DFDC's frame size, BGR
DETECT_SEED = 1
#: with the x75 score layers at seed 1, these leave about 150 stage-1
#: candidates and 0-10 faces (3.5 on average) a frame of the synthetic
#: videos, and no P-Net level near the 512-cell cap
DETECT_THRESHOLDS = (0.03, 0.75, 0.94)
#: videos of the check that copies every stage-1 tail under the lookahead
TAIL_VIDEOS = 3


def _detect_weights(seed: int) -> dict:
    """Random-init P/R/O-Nets from ``seed``, their score layers x75 (as
    ``tests/test_mtcnn_oracle.py``), so no threshold decision sits within
    backend noise of a cut."""
    from mintime_torch.preprocessing.mtcnn import MTCNNDetector

    sds = MTCNNDetector.init_state_dicts(seed)
    for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
        for k in ("weight", "bias"):
            sds[net][f"{layer}.{k}"] = sds[net][f"{layer}.{k}"] * 75.0
    return sds


def _detect_video(v: int, seed: int) -> list:
    """One synthetic BGR video: 8-px blocks of seeded noise drifting 4 px a
    frame to the right."""
    import numpy as np

    H, W = DETECT_SIZE
    rng = np.random.default_rng([seed, v])
    base = np.kron(rng.integers(0, 256, (H // 8, W // 8, 3), dtype=np.uint8),
                   np.ones((8, 8, 1), np.uint8))
    return [np.roll(base, 4 * t, axis=1) for t in range(DETECT_FRAMES)]


def _instrument(det, mtcnn_mod, stats):
    """Time the detector's stages: CUDA events around stage 1 and the
    stage-2/3 crops and nets, host clocks around NMS, the wait for stage 1's
    head and the whole host finish; count each stage's candidates. Returns a
    function that takes the module's NMS wrappers off again."""
    import torch

    def host_timed(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stats[key + "_host_s"] += time.perf_counter() - t
        return run

    def device_timed(fn, key):
        def run(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = host_timed(fn, key)(*a, **k)
            end.record()
            stats["events"].append((key, start, end))
            return out
        return run

    def counted(fn):
        def run(frames, cand, size, name, *rest):
            stats[name + "_candidates"] += sum(len(b) for b in cand)
            return fn(frames, cand, size, name, *rest)
        return run

    det._pnet_pyramid = device_timed(det._pnet_pyramid, "stage1")
    det._stage_net_device = device_timed(det._stage_net_device, "stages23")
    det._head = host_timed(det._head, "head_wait")
    det._finish_detect = host_timed(det._finish_detect, "finish")
    det._run_stage = counted(det._run_stage)
    saved = {name: getattr(mtcnn_mod, name) for name in ("nms_tv", "nms")}
    for name, fn in saved.items():
        setattr(mtcnn_mod, name, host_timed(fn, "nms"))
    restore_tail = _count_tail_copies(mtcnn_mod, stats)

    def restore():
        restore_tail()
        for n, f in saved.items():
            setattr(mtcnn_mod, n, f)
    return restore


def _count_tail_copies(mtcnn_mod, stats):
    """Count in ``stats["tail_copies"]`` the videos whose stage-1 tail is
    copied from the card (``mtcnn._copy_after`` with an event: the side
    stream that waits on the video's own stage 1). Returns a function that
    takes the count off again."""
    copy_after = mtcnn_mod._copy_after

    def counted(t, after):
        stats["tail_copies"] += after is not None
        return copy_after(t, after)

    mtcnn_mod._copy_after = counted
    return lambda: setattr(mtcnn_mod, "_copy_after", copy_after)


def _device_ms(stats, key) -> float:
    return sum(s.elapsed_time(e) for k, s, e in stats["events"] if k == key)


def phase_detect(smi):
    """Find and cluster faces on the card: 8 videos of 150 frames at
    1920 x 1080 through ``MTCNNDetector.detect_videos`` (one video of
    lookahead), a crop a second, then ``predict.cluster_crops`` with the
    FaceEmbedder's full InceptionResnetV1 at 128 px. No hand-written kernel
    runs here. Returns the launch counts of that path (all 0) and its
    seconds."""
    import warnings

    import numpy as np
    import torch

    from mintime_torch import native, predict
    from mintime_torch.preprocessing import mtcnn
    from mintime_torch.preprocessing.cluster_faces import FaceEmbedder, connected_components

    sds = _detect_weights(DETECT_SEED)
    kw = dict(thresholds=DETECT_THRESHOLDS, input_scale=2, channel_order="bgr")
    det = mtcnn.MTCNNDetector(sds, device_crops=True, device="cuda", **kw)
    emb_sd = FaceEmbedder.init_state_dict(DETECT_SEED)
    emb = FaceEmbedder(emb_sd, device="cuda")
    devices = {p.device.type for n in det.nets.values() for p in n.parameters()}
    devices |= {p.device.type for p in emb.net.parameters()}
    if devices != {"cuda"}:
        raise AssertionError(f"detector and embedder parameters on {devices}, want cuda only")

    stats = collections.defaultdict(float)
    stats["events"] = []
    restore = _instrument(det, mtcnn, stats)
    kept, two, gen_s = {}, [], [0.0]

    def videos():
        for v in range(DETECT_VIDEOS):
            t = time.perf_counter()
            frames = _detect_video(v, DETECT_SEED)
            kept[v] = {i: frames[i] for i in range(0, DETECT_FRAMES, DETECT_FPS)}
            if v == 0:
                two.extend([frames[0], frames[DETECT_FRAMES // 2]])
            gen_s[0] += time.perf_counter() - t
            yield frames

    def embed(crops):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        out = emb(crops)
        end.record()
        torch.cuda.synchronize()
        stats["embed_host_s"] += time.perf_counter() - t
        stats["embed_crops"] += len(crops)
        stats["events"].append(("embed", start, end))
        return out

    def main_path():
        t0 = time.perf_counter()
        per_video = det.detect_videos(videos())
        torch.cuda.synchronize()
        stats["detect_host_s"] = time.perf_counter() - t0 - gen_s[0]
        out = []
        for v, boxes_v in enumerate(per_video):
            boxes = {str(i): b[:, :4].tolist() if len(b) else None for i, b in enumerate(boxes_v)}
            crops = predict.crops_from_frames(kept[v], boxes, DETECT_FPS)
            t = time.perf_counter()
            identities, _ = predict.cluster_crops(crops, embed)
            stats["cluster_host_s"] += time.perf_counter() - t
            out.append((boxes_v, crops, identities))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            results, launches = _step_launches(main_path)
        finally:
            restore()
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if any(launches.values()):
        raise AssertionError(f"the detect path launched hand-written kernels: {launches}")
    truncation = [str(w.message) for w in caught if "P-Net" in str(w.message)]

    frames_total = DETECT_VIDEOS * DETECT_FRAMES
    faces = [[len(b) for b in r[0]] for r in results]
    n_faces = sum(map(sum, faces))
    n_crops = [len(r[1]) for r in results]
    finish_s = stats["finish_host_s"]
    bookkeeping_s = (finish_s - stats["nms_host_s"] - stats["stages23_host_s"]
                     - stats["head_wait_host_s"])
    emit({"phase": "detect", "card": smi, "videos": DETECT_VIDEOS,
          "frames_per_video": DETECT_FRAMES, "frame_hw": list(DETECT_SIZE),
          "thresholds": list(DETECT_THRESHOLDS), "input_scale": 2, "device_crops": True,
          "seconds": seconds, "launches": launches,
          "detect_host_s": stats["detect_host_s"],
          "detect_frames_per_s": frames_total / stats["detect_host_s"],
          "frame_generation_s": gen_s[0],
          "stage1_device_ms": _device_ms(stats, "stage1"),
          "stages23_device_ms": _device_ms(stats, "stages23"),
          "stage1_head_wait_host_ms": 1e3 * stats["head_wait_host_s"],
          "stages23_host_ms": 1e3 * stats["stages23_host_s"],
          "nms_host_ms": 1e3 * stats["nms_host_s"],
          "bookkeeping_host_ms": 1e3 * bookkeeping_s,
          "finish_host_ms": 1e3 * finish_s,
          "candidates_per_frame": {"rnet": stats["rnet_candidates"] / frames_total,
                                   "onet": stats["onet_candidates"] / frames_total},
          "faces_per_frame": n_faces / frames_total,
          "faces_per_frame_min_max": [min(map(min, faces)), max(map(max, faces))],
          "crops_per_video": n_crops,
          "identities_per_video": [len(r[2]) for r in results],
          "embed_crops_per_s": stats["embed_crops"] / stats["embed_host_s"],
          "embed_device_ms": _device_ms(stats, "embed"),
          "cluster_ms": 1e3 * (stats["cluster_host_s"] - stats["embed_host_s"]),
          "tail_copies": stats["tail_copies"],
          "peak_mem_gib": peak_gib, "truncation_warnings": truncation})
    if truncation:
        raise AssertionError(f"P-Net truncation warnings: {truncation}")
    if not n_faces:
        raise AssertionError("the detector found no face")

    # checks, off the main path
    lib = native._lib
    native_ok = lib is not None and lib._name == str(native.library_path())
    card = det.detect_batch(two)
    cpu = mtcnn.MTCNNDetector(sds, device_crops=True, device="cpu", **kw).detect_batch(two)
    host_crops = mtcnn.MTCNNDetector(sds, device_crops=False, device="cuda", **kw).detect_batch(two)

    def box_err(a, b):
        if [len(x) for x in a] != [len(x) for x in b]:
            return None
        return max([float(np.abs(x - y).max()) for x, y in zip(a, b) if len(x)], default=0.0)

    cpu_err, host_crops_err = box_err(card, cpu), box_err(card, host_crops)
    # the stage-1 tail's copy under the lookahead: with a head of 0 cells
    # every video copies its tail, after the next video's stage 1 is
    # enqueued; its boxes against those the main path's head gave
    tail_stats = collections.defaultdict(int)
    restore_tail = _count_tail_copies(mtcnn, tail_stats)
    try:
        no_head = mtcnn.MTCNNDetector(sds, device_crops=True, device="cuda", pnet_head_k=0, **kw)
        tail_runs = no_head.detect_videos(_detect_video(v, DETECT_SEED) for v in range(TAIL_VIDEOS))
    finally:
        restore_tail()
    tail_errs = [box_err(t, r[0]) for t, r in zip(tail_runs, results)]
    crops = results[0][1]
    e_card = emb([c[2] for c in crops])
    e_cpu = FaceEmbedder(emb_sd, device="cpu")([c[2] for c in crops])
    emb_err = float(np.abs(e_card - e_cpu).max())
    same_members = (connected_components(e_card @ e_card.T)
                    == connected_components(e_cpu @ e_cpu.T))
    sims = e_card @ e_card.T
    warm_ms = time_ms(lambda: emb([c[2] for c in crops]), iters=3, warmup=1)
    emit({"phase": "detect_check", "card": smi, "native_nms_loaded": native_ok,
          "native_nms_library": str(native.library_path().name),
          "boxes_per_frame_card": [len(b) for b in card],
          "boxes_per_frame_cpu": [len(b) for b in cpu],
          "boxes_per_frame_host_crops": [len(b) for b in host_crops],
          "card_vs_cpu_box_err": cpu_err, "device_vs_host_crops_box_err": host_crops_err,
          "embed_crops": len(crops), "embed_warm_ms_per_call": warm_ms,
          "card_vs_cpu_embedding_err": emb_err,
          "memberships_equal": same_members,
          "similarity_min_max": [float(sims.min()), float(sims.max())],
          "tail_check_videos": TAIL_VIDEOS, "tail_check_copies": tail_stats["tail_copies"],
          "tail_vs_head_box_err": tail_errs})
    if not native_ok:
        raise AssertionError("the native NMS library is not the one loaded")
    if cpu_err is None or cpu_err > TOL:
        raise AssertionError(f"card vs CPU boxes: {cpu_err} (None: other box counts) > {TOL}")
    if host_crops_err is None or host_crops_err > TOL:
        raise AssertionError(f"device vs host crops boxes: {host_crops_err} > {TOL}")
    if not emb_err <= 1e-4:
        raise AssertionError(f"card vs CPU embeddings differ by {emb_err} > 1e-4")
    if not same_members:
        raise AssertionError("card and CPU cluster memberships differ")
    if tail_stats["tail_copies"] != TAIL_VIDEOS:
        raise AssertionError(f"{tail_stats['tail_copies']} tail copies, want {TAIL_VIDEOS}")
    if not all(e is not None and e <= TOL for e in tail_errs):
        raise AssertionError(f"boxes through the tail copy vs the head: {tail_errs} (None: other"
                             f" box counts) > {TOL}")
    return {"seconds": seconds, **launches}, [_members(r[2]) for r in results]


def _members(identities) -> dict:
    """Each identity's key and its crops' (frame, face) indices."""
    return {str(k): sorted((i, j) for i, j, *_ in items) for k, items in identities.items()}


# 3c. predict: the CLI's loading code and the whole pipeline from decoded frames
PREDICT_MODELS = (("predict_ef", 0, "efficientnet-b0", 1280), ("predict_xc", 1, "xception", 2048))


def _predict_config(channels: int):
    """The published Size-Invariant TimeSformer (``configs/
    size_invariant_timesformer.yaml``), built in code: the card's machine
    has no yaml. Channels 1280 for EfficientNet-B0 (MINTIME-EF), 2048 for
    Xception (MINTIME-XC)."""
    from mintime_torch.config import MintimeConfig, ModelConfig

    return MintimeConfig(model=ModelConfig(
        image_size=224, num_frames=16, num_patches=49, channels=channels, dim=512, depth=9,
        heads=8, dim_head=64, max_identities=2))


def _write_model_files(d: str, model_id: int, backbone: str, channels: int) -> tuple:
    """Reference-format weight files of the classifier drawn from seed
    ``model_id``: the TimeSformer head's ``Model_checkpoint`` (its position
    and size tables padded to the reference's ``num_frames * channels + 1``
    rows) and the extractor's ``Extractor_checkpoint``; returns their paths."""
    import os

    import torch

    from mintime_torch.models.classifier import MintimeVideoClassifier

    mcfg = _predict_config(channels).model
    sd = MintimeVideoClassifier(mcfg, backbone=backbone, device="cpu", seed=model_id).state_dict()
    rows = mcfg.num_frames * channels + 1
    head = {}
    for k, v in sd.items():
        if k.startswith("head."):
            if k in ("head.pos_emb.weight", "head.size_emb.weight"):
                v = torch.cat([v, v.new_zeros(rows - v.shape[0], v.shape[1])])
            head[k[len("head."):]] = v
    ext = {k[len("extractor."):]: v for k, v in sd.items() if k.startswith("extractor.")}
    paths = (os.path.join(d, f"Model_checkpoint_{backbone}"),
             os.path.join(d, f"Extractor_checkpoint_{backbone}"))
    torch.save(head, paths[0])
    torch.save(ext, paths[1])
    return paths


def _write_weight_files(d: str) -> dict:
    """The classifiers' weight files for each model of ``PREDICT_MODELS``
    (:func:`_write_model_files`), the three MTCNN nets of phase ``detect``
    and its FaceNet."""
    import os

    import torch

    from mintime_torch.preprocessing.cluster_faces import FaceEmbedder

    files = {"mtcnn": os.path.join(d, "mtcnn"), "facenet": os.path.join(d, "facenet.pt")}
    os.makedirs(files["mtcnn"])
    for name, sd in _detect_weights(DETECT_SEED).items():
        torch.save(sd, os.path.join(files["mtcnn"], f"{name}.pt"))
    torch.save(FaceEmbedder.init_state_dict(DETECT_SEED), files["facenet"])
    for path, model_id, backbone, channels in PREDICT_MODELS:
        files[path] = _write_model_files(d, model_id, backbone, channels)
    return files


def _stage_timers(predict, augment, stats):
    """Host clocks, each ending in a synchronise, around the pipeline's
    stages: detection, crops, clustering (embedder included), the
    evaluation transform and the forward. Returns a function that takes them
    off again."""
    import torch

    def timed(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stats[key] += time.perf_counter() - t
            return out
        return run

    saved = {n: getattr(predict, n) for n in ("detect_on_frames", "crops_from_frames",
                                               "cluster_crops", "forward_batch")}
    keys = {"detect_on_frames": "detect_s", "crops_from_frames": "crops_s",
            "cluster_crops": "cluster_s", "forward_batch": "forward_s"}
    for n, fn in saved.items():
        setattr(predict, n, timed(fn, keys[n]))
    chain = augment.resize_chain
    augment.resize_chain = timed(chain, "transform_s")

    def restore():
        for n, fn in saved.items():
            setattr(predict, n, fn)
        augment.resize_chain = chain
    return restore


def phase_predict(smi, detect_members):
    """The predict CLI's loading code and the whole pipeline on the card, for
    MINTIME-EF and MINTIME-XC at full width: weight files written and read
    back through ``predict.load_predict_models``; phase ``detect``'s 8 videos
    of 150 frames at 1920 x 1080 from decoded frames through
    ``predict.stage_decoded`` (detect → crops → identities → the evaluation
    transform on the card → assembly) and ``predict.predict_assembled`` at
    batch 8. Returns each path's launch counts."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mintime_torch import predict
    from mintime_torch.data import augment
    from mintime_torch.models.classifier import MintimeVideoClassifier

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    videos = []
    for v in range(DETECT_VIDEOS):
        frames = _detect_video(v, DETECT_SEED)
        videos.append((frames, {i: frames[i] for i in range(0, DETECT_FRAMES, DETECT_FPS)}))
    gen_s = time.perf_counter() - t0
    options = dict(thresholds=DETECT_THRESHOLDS, input_scale=2, device_crops=True)
    paths = {}
    with tempfile.TemporaryDirectory(prefix=".predict_weights_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        t0 = time.perf_counter()
        files = _write_weight_files(d)
        write_s = time.perf_counter() - t0
        for path, model_id, backbone, channels in PREDICT_MODELS:
            cfg = _predict_config(channels)
            t0 = time.perf_counter()
            model, det, emb = predict.load_predict_models(
                cfg, files[path][0], files["mtcnn"], files["facenet"],
                extractor_weights=files[path][1], extractor_model=model_id, device="cuda",
                detector_options=options)
            load_s = time.perf_counter() - t0

            def pipeline():
                staged = [predict.stage_decoded(half, full, DETECT_FPS, det, emb, cfg,
                                                device="cuda") for half, full in videos]
                return staged, predict.predict_assembled(staged, model, None, cfg)

            # the main path: counters at 0 just before, read just after
            t0 = time.perf_counter()
            (staged, results), launches = _step_launches(pipeline)
            first_s = time.perf_counter() - t0
            paths[path] = launches
            want = {"divided_attention": 16, "geglu_ffn": 18, "token_rows_attention": 0,
                    **NO_OTHER_LAUNCHES,
                    "conv3x3": XC_DW_LAUNCHES if backbone == "xception" else 0}
            got = {k: launches[k] for k in want}
            if got != want:
                raise AssertionError(f"{path}: launches per forward {got}, want {want}")

            # the same run again, warm, timed by stage
            stats = collections.defaultdict(float)
            restore = _stage_timers(predict, augment, stats)
            torch.cuda.reset_peak_memory_stats()
            try:
                t0 = time.perf_counter()
                pipeline()
                torch.cuda.synchronize()
                warm_s = time.perf_counter() - t0
            finally:
                restore()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30

            # what came out, against plain mode, the CPU and phase detect
            members = [_members(s[2]) for s in staged]
            stacked = predict.stack_inputs(staged)
            logits_k, maps_k = predict.forward_batch(model, None, stacked)
            set_use_kernels(model, False)
            (logits_p, _), plain_launches = _step_launches(
                lambda: predict.forward_batch(model, None, stacked))
            set_use_kernels(model, True)
            if any(plain_launches.values()):
                raise AssertionError(f"{path}: plain mode launched kernels {plain_launches}")
            fwd_ms = time_ms(lambda: predict.forward_batch(model, None, stacked), iters=5,
                             warmup=1)
            cpu = MintimeVideoClassifier(cfg.model, backbone=backbone, require_attention=True,
                                         device="cpu")
            cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
            logits_cpu, _ = predict.forward_batch(cpu, None, {k: v[:1] for k, v in stacked.items()})
            del cpu
            crops = [c for s in staged for items in s[2].values() for _, _, c, _ in items]
            # the run's faces are all under 224 px: crops of a frame at the
            # sides of larger faces take the INTER_AREA path too
            frame = videos[0][1][0]
            crops += [frame[:h, :w] for h, w in ((225, 225), (300, 448), (448, 448), (700, 365),
                                                 (1080, 1080))]
            vt = augment.create_val_transform(224)
            levels = (vt(crops, "cuda").cpu().to(torch.int16)
                      - vt(crops, "cpu").to(torch.int16)).abs()
            sides = [max(c.shape[:2]) for c in crops]
            check = {
                "kernel_vs_plain_logit_err": float(np.abs(logits_k - logits_p).max()),
                "card_vs_cpu_fp32_logit_err": float(abs(logits_cpu[0] - logits_k[0])),
                "cpu_fp32_logit": float(logits_cpu[0]),
                "transform_max_level_diff": int(levels.max()),
                "transform_differing_share": float((levels > 0).float().mean()),
                "transform_crops": len(crops), "crop_sides_min_max": [min(sides), max(sides)],
                "crops_down_up_same": [sum(x > 224 for x in sides), sum(x < 224 for x in sides),
                                       sum(x == 224 for x in sides)],
                "finite": bool(np.isfinite(logits_k).all()
                               and all(np.isfinite(a).all() for r in results
                                       for a in r.aggregated_attentions)
                               and all(np.isfinite(m).all() for m in maps_k)),
                "identities_as_detect": members == detect_members,
            }
            n = len(videos)
            emit({"phase": "predict", "path": path, "backbone": backbone, "channels": channels,
                  "card": smi, "videos": n, "batch": 8, "launches": got,
                  "frame_generation_s": gen_s, "weight_files_write_s": write_s, "load_s": load_s,
                  "first_pipeline_s": first_s, "pipeline_s": warm_s,
                  "videos_per_s": n / warm_s,
                  "stage_s": {k: stats[k] for k in ("detect_s", "crops_s", "cluster_s",
                                                    "transform_s", "forward_s")},
                  "assemble_rest_s": warm_s - sum(stats.values()),
                  "forward_batch8_device_ms": fwd_ms, "peak_mem_gib": peak_gib,
                  "identities_per_video": [len(m) for m in members],
                  "probabilities": [r.probability for r in results],
                  "identity_attentions": [r.identity_attentions for r in results]})
            emit({"phase": "predict_check", "path": path, "card": smi, **check})
            if not check["kernel_vs_plain_logit_err"] <= TOL:
                raise AssertionError(f"{path}: kernel vs plain logits differ by "
                                     f"{check['kernel_vs_plain_logit_err']} > {TOL}")
            if not check["card_vs_cpu_fp32_logit_err"] <= 5e-2:
                raise AssertionError(f"{path}: bf16 card vs fp32 CPU logit differs by "
                                     f"{check['card_vs_cpu_fp32_logit_err']} > 5e-2")
            if not (check["transform_max_level_diff"] <= 1
                    and check["transform_differing_share"] <= 1e-3):
                raise AssertionError(f"{path}: the card's val transform differs from the CPU's: "
                                     f"{check}")
            if not check["finite"]:
                raise AssertionError(f"{path}: a probability or attention map is not finite")
            if not check["identities_as_detect"]:
                raise AssertionError(f"{path}: identities {members} differ from phase detect's "
                                     f"{detect_members}")
            del staged, stacked
            torch.cuda.empty_cache()
            paths[path + "_pipelined"] = _predict_pipelined(smi, path, model, det, emb, cfg,
                                                            videos, results)
            del model, det, emb, results
            torch.cuda.empty_cache()
    return paths


def _predict_pipelined(smi, path, model, det, emb, cfg, videos, sequential_results) -> dict:
    """Phase ``predict``'s served path with its pipelining: the videos through
    ``predict.stage_decoded_pipelined`` and ``predict.predict_staged`` (the
    batch logic of ``predict_videos``) at batch 8, counted, and held to the
    sequential run's results (probabilities within 1e-6, identities equal).
    Then the sequential and the pipelined staging in turns (sequential,
    pipelined, pipelined, sequential), each by host clock ending in a
    synchronise, with its host ms in ``_dispatch_stage1`` split into the
    frames' upload (``stage_frames``) and the pyramid's launches
    (``_pnet_pyramid`` on the host), stage 1's device ms (CUDA events), the
    videos that copied their stage-1 tail (``mtcnn._copy_after`` on the
    card) and peak memory; and the device's idle share over a profiled
    pipelined run (``_profile``). Returns the pipelined run's launch
    counts."""
    import torch

    from mintime_torch import predict
    from mintime_torch.preprocessing import mtcnn

    n = len(videos)

    def decoded():
        return ((frames, full, DETECT_FPS) for frames, full in videos)

    def pipelined():
        return predict.predict_staged(
            predict.stage_decoded_pipelined(decoded(), det, emb, cfg, device="cuda"), n, model,
            None, cfg, batch_size=8)

    def sequential():
        return predict.predict_staged(
            (predict.stage_decoded(half, full, fps, det, emb, cfg, device="cuda")
             for half, full, fps in decoded()), n, model, None, cfg, batch_size=8)

    # the main path: counters at 0 just before, read just after
    results, launches = _step_launches(pipelined)
    want = {"divided_attention": 16, "geglu_ffn": 18, "token_rows_attention": 0,
            **NO_OTHER_LAUNCHES,
            "conv3x3": XC_DW_LAUNCHES if model.backbone == "xception" else 0}
    got = {k: launches[k] for k in want}
    prob_err = max(abs(r.probability - s.probability)
                   for r, s in zip(results, sequential_results))
    same_identities = ([_members(r.identities) for r in results]
                       == [_members(s.identities) for s in sequential_results])

    stats = collections.defaultdict(float)
    stats["events"] = []
    dispatch, upload, pyramid = det._dispatch_stage1, det.stage_frames, det._pnet_pyramid

    def host_timed(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stats[key] += time.perf_counter() - t
        return run

    def device_timed(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = host_timed(pyramid, "pyramid_host_s")(*a, **k)
        end.record()
        stats["events"].append(("stage1", start, end))
        return out

    turns = []
    det._dispatch_stage1 = host_timed(dispatch, "dispatch_host_s")
    det.stage_frames = host_timed(upload, "upload_host_s")
    det._pnet_pyramid = device_timed
    restore_tail = _count_tail_copies(mtcnn, stats)
    try:
        for name, fn in (("sequential", sequential), ("pipelined", pipelined),
                         ("pipelined", pipelined), ("sequential", sequential)):
            for key in ("dispatch_host_s", "upload_host_s", "pyramid_host_s", "tail_copies"):
                stats[key] = 0
            stats["events"] = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_gib = torch.cuda.memory_allocated() / 2**30
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            turns.append({"staging": name, "s": s, "videos_per_s": n / s,
                          "dispatch_host_ms_per_video": 1e3 * stats["dispatch_host_s"] / n,
                          "upload_host_ms_per_video": 1e3 * stats["upload_host_s"] / n,
                          "pyramid_launch_host_ms_per_video": 1e3 * stats["pyramid_host_s"] / n,
                          "stage1_device_ms_per_video": _device_ms(stats, "stage1") / n,
                          "tail_copies": stats["tail_copies"],
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "resident_before_gib": base_gib})
    finally:
        restore_tail()
        del det._dispatch_stage1, det.stage_frames, det._pnet_pyramid  # the class's again
    prof = _profile(pipelined)
    emit({"phase": "predict_pipelined", "path": path, "card": smi, "videos": n, "batch": 8,
          "launches": got, "max_prob_err_vs_sequential": prob_err,
          "identities_as_sequential": same_identities, "turns": turns,
          "videos_per_s": {k: [t["videos_per_s"] for t in turns if t["staging"] == k]
                           for k in ("sequential", "pipelined")},
          "profile": prof,
          "probabilities": [r.probability for r in results]})
    if got != want:
        raise AssertionError(f"{path}: pipelined launches per forward {got}, want {want}")
    if not prob_err <= 1e-6:
        raise AssertionError(f"{path}: pipelined vs sequential probabilities differ by {prob_err}")
    if not same_identities:
        raise AssertionError(f"{path}: the pipelined run's identities differ from the sequential's")
    return launches


# 3d. evaluate: a test split from disk through the evaluation CLI's function
EVAL_VIDEOS = 48
#: identities a video: 16 with one, 24 with two, 8 with three (cut to two)
EVAL_IDENTITIES = (1,) * 16 + (2,) * 24 + (3,) * 8
EVAL_SECONDS = 10  # one crop a second an identity
EVAL_FPS = 30
EVAL_SEED = 2
EVAL_SIDES = (64, 320)  # face sides in DFDC's 1920 x 1080 frames
EVAL_DIMS = {"width": 1920, "height": 1080, "fps": EVAL_FPS}
#: levels of a video's band of block values; the band's floor is drawn a video
EVAL_BAND = 64
#: standard deviation of the logits of the fitted output layer over the split
EVAL_LOGIT_STD = 0.15


def _block_crop(rng, side: int, lo: int = 0, band: int = 256):
    """A square crop of 8-pixel block noise with values in ``[lo, lo +
    band)``, BGR uint8."""
    import numpy as np

    n = -(-side // 8)
    blocks = rng.integers(lo, lo + band, (n, n, 3)).astype(np.uint8)
    return np.kron(blocks, np.ones((8, 8, 1), np.uint8))[:side, :side]


def _write_test_split(root: str) -> tuple:
    """``EVAL_VIDEOS`` videos as ``crops.pack`` shards under ``root/faces``,
    written by ``crop_store.write_pack`` from seeded crops (block noise in
    a band of ``EVAL_BAND`` levels a video, so that videos differ in more
    than their noise), and a ``test.csv``
    of ``video label 8_cls`` rows (odd videos fake with method 1-4, even
    pristine with no method). Every sixth video also holds three loose crops
    (identity None) that merge into identity 0; every eighth keeps its frame
    size in a ``video_dims.json`` sidecar, the rest in the pack header.
    Returns the faces root, the split file and the number of crops."""
    import json
    import os

    import numpy as np

    from mintime_torch.data.crop_store import PACK_NAME, write_pack

    rng = np.random.default_rng(EVAL_SEED)
    identities = rng.permutation(EVAL_IDENTITIES)
    faces = os.path.join(root, "faces")
    rows, n_crops = [], 0
    for v in range(EVAL_VIDEOS):
        name = f"{'fake' if v % 2 else 'real'}/video_{v:02d}"
        vdir = os.path.join(faces, name)
        os.makedirs(vdir)
        entries = []
        band = (int(rng.integers(0, 256 - EVAL_BAND + 1)), EVAL_BAND)
        for ident in range(int(identities[v])):
            side = int(rng.integers(EVAL_SIDES[0], EVAL_SIDES[1] + 1))
            for sec in range(EVAL_SECONDS):
                s = int(np.clip(side + rng.integers(-8, 9), *EVAL_SIDES))
                entries.append((str(ident), sec * EVAL_FPS, ident, _block_crop(rng, s, *band)))
        if v % 6 == 5:
            entries += [(None, f, 3, _block_crop(rng, 96, *band))
                        for f in (15, 105, EVAL_SECONDS * EVAL_FPS)]
        sidecar = v % 8 == 3
        write_pack(os.path.join(vdir, PACK_NAME), entries, dims=None if sidecar else EVAL_DIMS)
        if sidecar:
            with open(os.path.join(vdir, "video_dims.json"), "w") as f:
                json.dump(EVAL_DIMS, f)
        n_crops += len(entries)
        rows.append(f"{name} 1 {1 + (v // 2) % 4}" if v % 2 else f"{name} 0")
    split = os.path.join(root, "test.csv")
    with open(split, "w") as f:
        f.write("\n".join(rows) + "\n")
    return faces, split, n_crops


def _fit_output_layer(cfg, head: str, ext: str, man, faces: str) -> dict:
    """Refit the head file's output layer (``to_out.1``) to the split, so
    that its logits read the videos' crops. A plain fp32 run on the card
    gives each video's normalised CLS embedding. The layer projects onto
    their covariance with the video's mean crop level (the band its block
    noise was drawn from), made orthogonal to the difference between the
    mean embeddings of one identity and of more, which would otherwise part
    the logits by identity count. It is scaled to logits of standard
    deviation ``EVAL_LOGIT_STD`` around their median. Returns the fit's
    numbers."""
    import os

    import numpy as np
    import torch

    from mintime_torch import evaluate
    from mintime_torch.data.crop_store import CropPack, find_pack

    model = evaluate.build_model(cfg, head, ext, use_kernels=False, device="cuda",
                                 dtype=torch.float32)
    rows = []
    hook = model.head.to_out[0].register_forward_hook(
        lambda mod, args, out: rows.append(out.float().cpu().numpy()))
    with evaluate.split_loader(cfg, man.videos, man.labels, man.multiclass, faces, 8,
                               workers=4, device="cuda") as loader:
        evaluate.evaluate(model, None, loader)
    hook.remove()
    del model
    z = np.concatenate(rows).astype(np.float64)
    mu = z.mean(0)
    packs = [CropPack(find_pack(os.path.join(faces, v))) for v in man.videos]
    level = np.array([np.mean([p.read(i).mean() for i in range(len(p.entries))]) for p in packs])
    multi = np.isin(np.arange(len(z)), evaluate.filter_multi_identity(man.videos, faces))
    gap = z[multi].mean(0) - z[~multi].mean(0)
    gap /= np.linalg.norm(gap)
    w = (z - mu).T @ (level - level.mean())
    w -= (w @ gap) * gap
    proj = (z - mu) @ w
    scale = EVAL_LOGIT_STD / proj.std()
    w *= scale
    b = -(mu @ w) - np.median(proj) * scale
    sd = torch.load(head, map_location="cpu")
    sd["to_out.1.weight"] = torch.tensor(w[None], dtype=torch.float32)
    sd["to_out.1.bias"] = torch.tensor([b], dtype=torch.float32)
    torch.save(sd, head)
    return {"corr_with_level": float(np.corrcoef(proj, level)[0, 1]),
            "direction_std": float(proj.std() / np.linalg.norm(w / scale)),
            "embedding_norm": float(np.linalg.norm(z, axis=1).mean())}


def _eval_timers(evaluate, loader_mod, stats, logits, embeddings=None):
    """Host clocks around an evaluation's stages, each ending in a
    synchronise: waiting on the loader's workers, the transform on the card,
    the forward with its copies; the forward's logits recorded by video, and
    into ``embeddings`` the normalised CLS embedding the output layer reads.
    Returns a function that takes them off again."""
    import torch

    forward = evaluate._forward

    def timed_forward(model, state, batch):
        rows = []  # kept on the device until the synchronise below
        hook = None if embeddings is None else model.head.to_out[0].register_forward_hook(
            lambda mod, args, out: rows.append(out.float()))
        t = time.perf_counter()
        try:
            out = forward(model, state, batch)
            torch.cuda.synchronize()
        finally:
            if hook is not None:
                hook.remove()
        stats["forward_s"] += time.perf_counter() - t
        logits.update(zip(batch["video_id"], out[0].tolist()))
        if embeddings is not None:
            embeddings.update(zip(batch["video_id"], rows[0].cpu().numpy()))
        return out

    evaluate._forward = timed_forward
    untime = _time_loader(loader_mod, stats)

    def restore():
        evaluate._forward = forward
        untime()
    return restore


def _time_loader(loader_mod, stats, extra=()):
    """Host clocks around the loader's stages, into ``stats``: the main
    process's wait on the workers (``loader_wait_s``), the transform on the
    card (``transform_s``, ending in a synchronise) and each ``(owner, name,
    key)`` of ``extra`` the same way. Returns a function that takes them off
    again."""
    loader = loader_mod.DataLoader
    raw = loader._iter_process

    def timed_raw(self, batches):
        it = raw(self, batches)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                stats["loader_wait_s"] += time.perf_counter() - t
            yield item

    def timed(fn, key):
        def wrapper(*a, **kw):
            out, s = _cuda_s(lambda: fn(*a, **kw))
            stats[key] += s
            return out
        return wrapper

    patches = [(loader, "_finish", "transform_s"), *extra]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, key in patches:
        setattr(owner, name, timed(getattr(owner, name), key))
    loader._iter_process = timed_raw

    def restore():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        loader._iter_process = raw
    return restore


def _finite_report(report: dict) -> bool:
    import math

    return (all(math.isfinite(report[k]) for k in ("loss", "accuracy", "f1", "auc"))
            and all(math.isfinite(x) for x in report["per_method_errors"].values()))


def phase_evaluate(smi):
    """The evaluation CLI's function (``evaluate.evaluate_split``, what
    ``python -m mintime_torch.evaluate`` calls after reading its yaml) on a
    test split written to disk: MINTIME-EF from reference-format weight
    files at full width, 4 spawned workers, batch 8 and the yaml's test
    batch of 1. Returns the launches of the batch-8 run."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mintime_torch import evaluate
    from mintime_torch.data import loader as loader_mod
    from mintime_torch.data.manifest import load_manifest
    from mintime_torch.device import resolve_device

    _, model_id, backbone, channels = PREDICT_MODELS[0]
    cfg = _predict_config(channels)
    want_forward = {"divided_attention": 18, "geglu_ffn": 18, "token_rows_attention": 0,
                    **NO_OTHER_LAUNCHES}
    with tempfile.TemporaryDirectory(prefix=".evaluate_split_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        t0 = time.perf_counter()
        faces, split, n_crops = _write_test_split(d)
        head, ext = _write_model_files(d, model_id, backbone, channels)
        write_s = time.perf_counter() - t0
        man = load_manifest(split, faces)
        t0 = time.perf_counter()
        fit = _fit_output_layer(cfg, head, ext, man, faces)
        fit["fit_s"] = time.perf_counter() - t0
        run = dict(extractor_weights=ext, workers=4, device="cuda")
        logits, emb = {}, {}
        stats = collections.defaultdict(float)
        restore = _eval_timers(evaluate, loader_mod, stats, logits, emb)
        try:
            # the main path: counters at 0 just before, read just after
            t0 = time.perf_counter()
            report, launches = _step_launches(
                lambda: evaluate.evaluate_split(cfg, head, split, faces, batch_size=8, **run))
            split_s = time.perf_counter() - t0
            split_stage_s = dict(stats)
            kernel, kernel_emb = dict(logits), dict(emb)
            forwards = -(-EVAL_VIDEOS // 8)
            got = {k: launches[k] for k in want_forward}
            if got != {k: forwards * n for k, n in want_forward.items()}:
                raise AssertionError(f"evaluate: launches {got} for {forwards} forwards, want "
                                     f"{want_forward} a forward")

            logits.clear()
            emb.clear()
            plain = evaluate.evaluate_split(cfg, head, split, faces, batch_size=8,
                                            fused_attention=0, **run)
            plain_logits, plain_emb = dict(logits), dict(emb)
            multi = evaluate.evaluate_split(cfg, head, split, faces, batch_size=8,
                                            only_multiidentity=True, **run)

            # warm passes by stage: the loader's workers kept from a first pass; the
            # model and the loader built as evaluate_split builds them
            dev = resolve_device("cuda")
            t0 = time.perf_counter()
            model = evaluate.build_model(cfg, head, ext, device=dev)
            build_s = time.perf_counter() - t0
            passes = {}
            for batch in (8, cfg.test.bs):
                with evaluate.split_loader(cfg, man.videos, man.labels, man.multiclass, faces,
                                           batch, 4, None, 0, 42, dev) as loader:
                    t0 = time.perf_counter()
                    evaluate.evaluate(model, None, loader)
                    torch.cuda.synchronize()
                    cold_s = time.perf_counter() - t0
                    stats.clear()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    warm, counts = _step_launches(lambda: evaluate.evaluate(model, None, loader))
                    warm_s = time.perf_counter() - t0
                n_fwd = -(-EVAL_VIDEOS // batch)
                per_forward = {k: counts[k] / n_fwd for k in want_forward}
                if per_forward != want_forward:
                    raise AssertionError(f"evaluate batch {batch}: launches a forward "
                                         f"{per_forward}, want {want_forward}")
                passes[batch] = {
                    "first_pass_s": cold_s, "pass_s": warm_s, "videos_per_s": EVAL_VIDEOS / warm_s,
                    "stage_s": {k: stats[k] for k in ("loader_wait_s", "transform_s",
                                                      "forward_s")},
                    "rest_s": warm_s - sum(stats.values()), "forwards": n_fwd,
                    "launches_per_forward": per_forward,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "report": warm}
        finally:
            restore()
        del model
        torch.cuda.empty_cache()

        # the same files in fp32 on the CPU, the split's first two videos
        cpu = evaluate.build_model(cfg, head, ext, device="cpu", dtype=torch.float32)
        logits_cpu, emb_cpu = {}, {}
        restore = _eval_timers(evaluate, loader_mod, collections.defaultdict(float), logits_cpu,
                               emb_cpu)
        try:
            with evaluate.split_loader(cfg, man.videos[:2], man.labels[:2], man.multiclass[:2],
                                       faces, 2, workers=1, device="cpu") as loader:
                evaluate.evaluate(cpu, None, loader)
        finally:
            restore()
        del cpu

    ids = sorted(kernel)
    k_arr = np.array([kernel[i] for i in ids])
    p_arr = np.array([plain_logits[i] for i in ids])
    near_zero = bool((np.abs(k_arr) <= TOL).any())
    # the CLS embeddings' differences against their spread over the split
    zp = np.stack([plain_emb[i] for i in ids]).astype(np.float64)
    spread = float(np.sqrt(((zp - zp.mean(0)) ** 2).sum(1).mean()))
    cls_rel = lambda a, b: float(np.linalg.norm(a - b) / spread)  # noqa: E731
    decided = np.abs(p_arr) > TOL
    check = {
        "kernel_vs_plain_logit_err": float(np.abs(k_arr - p_arr).max()),
        "plain_logit_std": float(p_arr.std()),
        "plain_logit_range": [float(p_arr.min()), float(p_arr.max())],
        "signs_decided": [int((p_arr[decided] < 0).sum()), int((p_arr[decided] > 0).sum())],
        "signs_agree": bool(((k_arr > 0) == (p_arr > 0))[decided].all()),
        "card_vs_cpu_fp32_logit_err": max(abs(kernel[i] - v) for i, v in logits_cpu.items()),
        "cls_spread": spread,
        "cls_kernel_vs_plain_rel": max(cls_rel(kernel_emb[i], plain_emb[i]) for i in ids),
        "cls_card_vs_cpu_rel": max(cls_rel(kernel_emb[i], z) for i, z in emb_cpu.items()),
        "cpu_fp32_logits": logits_cpu,
        "n_videos": report["n_videos"], "n_videos_plain": plain["n_videos"],
        "n_videos_multiidentity": multi["n_videos"],
        "accuracy_kernel_plain": [report["accuracy"], plain["accuracy"]],
        "logit_within_tol_of_zero": near_zero,
        "finite": all(_finite_report(r) for r in (report, plain, multi,
                                                  *(p["report"] for p in passes.values()))),
        "warm_reports_as_split": all(p["report"]["n_videos"] == report["n_videos"]
                                     and abs(p["report"]["loss"] - report["loss"]) <= TOL
                                     for p in passes.values()),
    }
    emit({"phase": "evaluate", "card": smi, "videos": EVAL_VIDEOS, "crops": n_crops,
          "workers": 4, "files_write_s": write_s, "output_layer_fit": fit,
          "evaluate_split_s": split_s, "evaluate_split_stage_s": split_stage_s,
          "model_build_s": build_s,
          "launches": got, "passes": {f"batch{b}": p for b, p in passes.items()},
          "report": report, "report_plain": plain, "report_multiidentity": multi})
    emit({"phase": "evaluate_check", "card": smi, **check})
    if not check["kernel_vs_plain_logit_err"] <= min(TOL, check["plain_logit_std"] / 4):
        raise AssertionError(f"evaluate: kernel vs plain logits differ by "
                             f"{check['kernel_vs_plain_logit_err']} > min({TOL}, a quarter of "
                             f"the plain logits' std {check['plain_logit_std']})")
    if not (check["signs_agree"] and min(check["signs_decided"]) >= EVAL_VIDEOS // 4):
        raise AssertionError(f"evaluate: kernel and plain logits differ in sign, or too few "
                             f"lie clear of 0 on each side: {check}")
    if not (len(logits_cpu) == 2 and check["card_vs_cpu_fp32_logit_err"] <= 5e-2):
        raise AssertionError(f"evaluate: bf16 card vs fp32 CPU logits differ by "
                             f"{check['card_vs_cpu_fp32_logit_err']} > 5e-2")
    if not (report["n_videos"] == plain["n_videos"] == EVAL_VIDEOS
            and multi["n_videos"] == sum(n > 1 for n in EVAL_IDENTITIES)):
        raise AssertionError(f"evaluate: n_videos {check}")
    if not near_zero and report["accuracy"] != plain["accuracy"]:
        raise AssertionError(f"evaluate: kernel and plain accuracy differ: {check}")
    if not (check["finite"] and check["warm_reports_as_split"]):
        raise AssertionError(f"evaluate: a report is not finite or differs between runs: "
                             f"{check}")
    return got


def phase_profile(smi, model, stacked):
    """Where the device time of one forward goes, at batch 8 and batch 1."""
    from mintime_torch import predict

    for batch in (8, 1):
        rows = {k: v[:batch] for k, v in stacked.items()}
        emit({"phase": "profile", "card": smi, "batch": batch,
              **_profile(lambda: predict.forward_batch(model, None, rows))})


#: the kernels that only the probes' paths launch: none of them in a model phase
PROBE_KERNELS = ("grouped_attention", "chunked_attention", "dw_conv", "dw_conv_wgrad")
#: Xception's depthwise 3 x 3 kernel (``conv3x3``): one launch a depthwise
#: layer, 34 an Xception forward in inference (every shape passes the rule)
XC_DW_LAUNCHES = 34
#: a path's launches of the probes' kernels and, unless it is an Xception
#: forward in inference, of Xception's depthwise kernel: none
NO_OTHER_LAUNCHES = {k: 0 for k in PROBE_KERNELS} | {"conv3x3": 0}


def _launch_counts() -> dict:
    """The wrappers' eleven launch counters as they stand."""
    from mintime_torch.ops import chunked_attention as ca
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import dw_conv
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.ops import grouped_attention as ga
    from mintime_torch.ops import token_rows as tr

    return {"divided_attention": da.launches, "geglu_ffn": ffn.launches,
            "token_rows_attention": tr.launches,
            "divided_attention_bwd": da.bwd_launches, "geglu_ffn_bwd": ffn.bwd_launches,
            "token_rows_attention_bwd": tr.bwd_launches,
            "grouped_attention": ga.launches, "chunked_attention": ca.launches,
            "dw_conv": dw_conv.launches, "dw_conv_wgrad": dw_conv.wgrad_launches,
            "conv3x3": dw_conv.conv3x3_launches}


def _step_launches(fn) -> tuple:
    """Kernel launches of the wrappers during ``fn()``, counted from 0."""
    import torch

    from mintime_torch.ops import chunked_attention as ca
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import dw_conv
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.ops import grouped_attention as ga
    from mintime_torch.ops import token_rows as tr

    torch.cuda.synchronize()
    for mod in (ffn, da, tr, ga, ca, dw_conv):
        mod.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _launch_counts()


def _one_step_grads(model, batch, pos_weight, use_kernels: bool, kernel_free: bool = False,
                    mesh=None, net=None, with_logits: bool = False):
    """Loss and parameter gradients of one train-mode forward and backward
    with drop-connect seeded as step 0; BatchNorm statistics restored after.
    ``kernel_free`` keeps the kernel path's autograd Functions but has them
    run their plain versions on the card: the kernels' rounding points
    without the kernels. With a data-parallel ``mesh``, ``batch`` is this
    rank's rows, ``net`` the model's ``DistributedDataParallel`` wrapper, the
    loss the rank's share and the gradients the global batch's. The logits
    (fp32) come third with ``with_logits``."""
    import contextlib
    from unittest import mock

    import torch

    from mintime_torch import train
    from mintime_torch.models.efficientnet import BatchRows
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.ops import token_rows as tr
    from mintime_torch.parallel.mesh import axis_size

    stats = {k: v.clone() for k, v in model.named_buffers()}
    set_use_kernels(model, use_kernels)
    model.zero_grad(set_to_none=True)
    generator = train.step_generator(0, 0)
    if axis_size(mesh) > 1:
        generator = BatchRows(generator, *train._local_rows(batch, mesh, model.device))
    with contextlib.ExitStack() as stack:
        if kernel_free:
            for mod, names in ((ffn, ("geglu_ffn", "geglu_ffn_bwd")),
                               (da, ("divided_attention", "divided_attention_bwd")),
                               (tr, ("token_rows_attention", "token_rows_attention_bwd"))):
                for n in names:
                    stack.enter_context(mock.patch.object(mod, f"{n}_cuda", getattr(mod, f"{n}_plain")))
        loss, logits = train.forward_loss(model, batch, pos_weight, train=True,
                                          generator=generator, mesh=mesh, net=net)
        loss.backward()
    grads = {n: None if p.grad is None else p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(stats[k])
    set_use_kernels(model, True)
    model.zero_grad(set_to_none=True)
    if with_logits:
        return float(loss.detach()), grads, logits.detach().float()
    return float(loss.detach()), grads


def _grad_check(smi, phase, model, ref, batch, pos_weight, trained, mesh=None, report=emit,
                check_logits: bool = False):
    """One step's gradients with kernels against the plain path on the same
    weights, batch and masks. ``trained`` names the parameters that must get
    a finite, non-zero gradient; every other parameter must get none.
    ``ref`` is a plain fp32 copy of the model, loaded here and freed after.
    With a data-parallel ``mesh`` every run is the mesh's (``batch`` this
    rank's rows). ``check_logits`` holds the step's logits to the gradients'
    rule too. The record goes to ``report``."""
    import numpy as np
    import torch

    from mintime_torch.parallel.mesh import axis_size, data_parallel

    dp = axis_size(mesh) > 1
    kw = dict(mesh=mesh, net=data_parallel(model, mesh) if dp else None, with_logits=True)
    loss_k, gk, lk = _one_step_grads(model, batch, pos_weight, True, **kw)
    loss_p, gp, lp = _one_step_grads(model, batch, pos_weight, False, **kw)
    bad = [n for n in trained if gk[n] is None or not torch.isfinite(gk[n]).all()
           or not gk[n].abs().max() > 0]
    if bad:
        raise AssertionError(f"parameters without a finite non-zero gradient: {bad[:8]}")
    frozen = [n for n, g in gk.items() if n not in trained and g is not None and g.any()]
    if frozen:
        raise AssertionError(f"frozen parameters with a gradient: {frozen[:8]}")
    # Two readings beside the kernel-vs-plain gap. An fp32 run of the same
    # step (same weights, plain path) tells which tensors have a zero
    # gradient in exact arithmetic: the biases of the _bn2 layers whose
    # output a train-mode BatchNorm re-centres. There the bf16 paths hold
    # nothing but round-off, at least 2^8 times the fp32 value. A kernel-free
    # twin (the kernel path with its plain versions on the card) shows how far
    # two correct bf16 runs that round at different places already drift
    # apart at random init: a few percent of a tensor's largest gradient, up
    # to about 1e-1 on some tensors. Each tensor's kernel-vs-plain gap must
    # stay within 5e-2 of its largest plain gradient beyond the twin's gap.
    _, gt, lt = _one_step_grads(model, batch, pos_weight, True, kernel_free=True, **kw)
    ref.load_state_dict(model.state_dict())
    loss_32, g32 = _one_step_grads(ref, batch, pos_weight, False, mesh=mesh,
                                   net=data_parallel(ref, mesh) if dp else None)
    del ref
    torch.cuda.empty_cache()
    rows = {}
    for n in trained:
        top = float(gp[n].abs().max())
        rows[n] = {"gap": float((gk[n] - gp[n]).abs().max()) / top,
                   "twin_gap": float((gt[n] - gp[n]).abs().max()) / top,
                   "kernel_vs_twin": float((gk[n] - gt[n]).abs().max()) / top,
                   "fp32_over_plain": float(g32[n].abs().max()) / top}
    zero = sorted(n for n, r in rows.items() if r["fp32_over_plain"] <= 2**-8)
    over = sorted((n for n in rows if n not in zero and rows[n]["gap"] > 5e-2),
                  key=lambda n: -rows[n]["gap"])
    failed = [n for n in over if not rows[n]["gap"] <= 5e-2 + rows[n]["twin_gap"]]
    checked = [n for n in rows if n not in zero]
    worst = max(checked, key=lambda n: rows[n]["gap"])
    med = lambda key: float(np.median([rows[n][key] for n in checked]))  # noqa: E731
    top = float(lp.abs().max())
    logits = {"gap": float((lk - lp).abs().max()) / top,
              "twin_gap": float((lt - lp).abs().max()) / top, "max_plain": top}
    report({"phase": phase, "card": smi, "loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_fp32": loss_32, "parameters": len(gk), "with_gradient": len(trained),
            "logits": logits, "zero_in_fp32": zero, "worst_grad_tensor": worst, **rows[worst],
            "largest_gap_beyond_twin": max(rows[n]["gap"] - rows[n]["twin_gap"]
                                           for n in checked),
            "median_gap": med("gap"), "median_twin_gap": med("twin_gap"),
            "median_kernel_vs_twin": med("kernel_vs_twin"),
            "over_5e-2": {n: rows[n] for n in over}})
    if not abs(loss_k - loss_p) <= TOL:
        raise AssertionError(f"{phase}: kernel vs plain loss {loss_k} vs {loss_p}")
    if failed:
        raise AssertionError(f"{phase}: kernel vs plain gradients off: "
                             f"{[(n, rows[n]) for n in failed[:4]]}")
    if check_logits and not logits["gap"] <= 5e-2 + logits["twin_gap"]:
        raise AssertionError(f"{phase}: kernel vs plain logits off: {logits}")


def _flagship_train_batch():
    """Phase ``train``'s config (the flagship at full width, SGD lr 0.01,
    weight decay 1e-4, cosine, batch 8), its batch of 8 synthetic videos
    assembled as in phase ``slice`` (half labelled fake, frames on the card)
    and its ``pos_weight``."""
    import numpy as np

    from mintime_torch import predict, train
    from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig

    mcfg = ModelConfig(image_size=224, num_frames=16, num_patches=49, channels=1280, dim=512,
                       depth=9, heads=8, dim_head=64, max_identities=2)
    cfg = MintimeConfig(model=mcfg, training=TrainingConfig(
        lr=0.01, weight_decay=1e-4, optimizer="SGD", scheduler="cosinelr", bs=8))
    staged = []
    for full, boxes, fps, dims in _synthetic_videos(8, seed=2):
        crops = predict.crops_from_frames(full, boxes, fps)
        identities, _ = predict.cluster_crops(crops, stand_in_embedder)
        staged.append(predict.assemble_inputs(identities, dims, cfg))
    batch = predict.stack_inputs(staged)
    batch["labels"] = np.array([0.0, 1.0] * 4, np.float32)
    return cfg, batch, train.pos_weight_from_labels(batch["labels"])


def phase_train(smi):
    """The flagship classifier trained for 5 steps at full width, batch 8."""
    import numpy as np
    import torch

    from mintime_torch import train
    from mintime_torch.models.classifier import MintimeVideoClassifier

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, batch, pos_weight = _flagship_train_batch()
    mcfg = cfg.model

    t0 = time.perf_counter()
    model = train.training_model(mcfg, device="cuda", seed=0)
    build_model_s = time.perf_counter() - t0
    assert model.dtype == torch.float32 and model.compute_dtype == torch.bfloat16

    ref = MintimeVideoClassifier(mcfg, use_kernels=False, device="cuda", dtype=torch.float32,
                                 param_dtype=torch.float32, seed=0)
    _grad_check(smi, "train_check", model, ref, batch, pos_weight,
                [n for n, _ in model.named_parameters()])

    # the main path: 5 steps through make_train_step, counters read per step
    state = train.create_train_state(model, cfg, steps_per_epoch=5, num_epochs=1, seed=0)
    step = train.make_train_step(model, pos_weight)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    losses, launches, step_s = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        metrics, counts = _step_launches(lambda: step(state, batch))
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        launches.append(counts)
    # 9 layers x 2 attentions and 2 FFNs (tokens, CLS) forward; backward the
    # same, but for the last layer's token FFN: only the CLS stream reaches
    # the logits, so that output gets no gradient and autograd skips it
    want = {"divided_attention": 18, "geglu_ffn": 18, "token_rows_attention": 0,
            "divided_attention_bwd": 18, "geglu_ffn_bwd": 17, "token_rows_attention_bwd": 0,
            **NO_OTHER_LAUNCHES}
    if any(c != want for c in launches):
        raise AssertionError(f"launches per train step {launches}, want {want}")
    with torch.no_grad():  # the loss of step 0's forward (same drop-connect masks), now
        after, _ = train.forward_loss(model, batch, pos_weight, train=True,
                                      generator=train.step_generator(0, 0))
    after = float(after)
    if not (np.isfinite(after) and after < losses[0]):
        raise AssertionError(f"loss after 5 steps {after} is not below the first {losses[0]}")
    moved = [k for k, v in model.named_buffers() if not torch.equal(v, stats0[k])]
    if len(moved) != len(stats0):
        raise AssertionError(f"BatchNorm statistics unmoved: {sorted(set(stats0) - set(moved))[:8]}")

    device_ms = time_ms(lambda: step(state, batch), iters=5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    steady = sorted(step_s[1:])
    emit({"phase": "train", "card": smi, "batch": 8, "steps": 5, "launches_per_step": launches[0],
          "losses": losses, "loss_after": after, "pos_weight": pos_weight,
          "build_model_s": build_model_s, "first_step_s": step_s[0], "step_s": step_s,
          "steps_per_s": 1 / steady[len(steady) // 2],
          "videos_per_s_batch8": 8 / steady[len(steady) // 2],
          "device_ms_per_step": device_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "profile", "card": smi, "what": "train step", "batch": 8,
          **_profile(lambda: step(state, batch))})
    return launches[0], 1e3 * steady[len(steady) // 2]


#: videos of phase ``augment``, and the seed of its forced draws
AUG_VIDEOS = 8
AUG_SEED = 16
#: the transforms held bitwise between the card and the CPU (the rest within one level)
AUG_BITWISE = ("HorizontalFlip", "InvertImg", "CoarseDropout", "RandomBrightnessContrast",
               "RandomGamma", "RGBShift", "GaussNoise", "MultiplicativeNoise", "MedianBlur")
#: the flagship's train-mode loader in phase ``train_disk``
DISK_BATCH, DISK_EPOCHS, DISK_WORKERS = 8, 2, 4


def _flagship_train_config():
    from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig

    mcfg = ModelConfig(image_size=224, num_frames=16, num_patches=49, channels=1280, dim=512,
                       depth=9, heads=8, dim_head=64, max_identities=2)
    return MintimeConfig(model=mcfg, training=TrainingConfig(
        lr=0.01, weight_decay=1e-4, optimizer="SGD", scheduler="cosinelr", bs=DISK_BATCH))


def _train_dataset(cfg, man, faces, augmentation, device="cuda"):
    from mintime_torch.data.dataset import DeepfakesDataset

    m = cfg.model
    return DeepfakesDataset(man.videos, man.labels, data_path=faces, image_size=m.image_size,
                            num_frames=m.num_frames, num_patches=m.num_patches,
                            max_identities=m.max_identities, mode="train",
                            augmentation=augmentation, device=device)


def _cuda_s(fn):
    """``fn()`` and its seconds by the host's clock, ending in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_augment(smi, cfg, man, faces, step_ms):
    """The train-mode augmentations on the card: ``AUG_VIDEOS`` videos of the
    train split (16 slots, dummy slots included) through the resize chain of
    their natural ``max`` draws, then each transform forced once a video (a
    one-member ``OneOf(p=1.0)``), held against the port on the CPU on the
    same stack and draws; then the natural ``max`` and ``min`` presets, timed
    by stage against a flagship train step of ``step_ms``."""
    import numpy as np
    import torch

    from mintime_torch.data import augment, augment_plan

    size = cfg.model.image_size
    ds = _train_dataset(cfg, man, faces, "max")
    raws = [ds.load(i) for i in range(AUG_VIDEOS)]
    stacks = [augment.resize_chain(r["crops"], r["steps"], "cuda")[0] for r in raws]
    chain_differ = sum(int((st.cpu() != augment.resize_chain(r["crops"], r["steps"], "cpu")[0])
                           .sum()) for st, r in zip(stacks, raws))
    rows = {}
    for k, name in enumerate(sorted(augment.STACK_STEPS)):
        one = augment_plan.OneOf([getattr(augment_plan, name)()], p=1.0)
        steps = []
        for v in range(AUG_VIDEOS):
            drawn = []
            one.draw(drawn, (size, size, 3), np.random.default_rng((AUG_SEED, k, v)))
            steps.append(drawn[0])
        for stack, step in zip(stacks, steps):  # warm-up: allocations, tables
            augment.apply_step(stack, step)
        outs, card_s = _cuda_s(lambda: [augment.apply_step(st, sp)
                                        for st, sp in zip(stacks, steps)])
        worst, differ, total = 0, 0, 0
        for stack, step, out in zip(stacks, steps, outs):
            cpu = augment.apply_step(stack.cpu(), step)
            diff = (out.cpu().to(torch.int16) - cpu.to(torch.int16)).abs()
            worst = max(worst, int(diff.max()))
            differ += int((diff > 0).sum())
            total += diff.numel()
        rows[name] = {"ms_per_video": 1e3 * card_s / AUG_VIDEOS, "max_diff_levels": worst,
                      "share_differing": differ / total,
                      "bound": "bitwise" if name in AUG_BITWISE else "one level"}
    presets = {}
    for aug in ("max", "min"):
        ds = _train_dataset(cfg, man, faces, aug)
        raws = [ds.load(i) for i in range(AUG_VIDEOS)]
        for r in raws[:2]:  # warm-up
            augment.train_transform(r["crops"], r["steps"], "cuda")
        chain_s = aug_s = 0.0
        fired = collections.Counter()
        for r in raws:
            (stack, rest), s1 = _cuda_s(
                lambda: augment.resize_chain(r["crops"], r["steps"], "cuda"))
            _, s2 = _cuda_s(lambda: augment.apply_steps(stack, rest))
            chain_s += s1
            aug_s += s2
            fired.update(t.name for t, _ in rest)
        slots = AUG_VIDEOS * cfg.model.num_frames
        batch_ms = 1e3 * (chain_s + aug_s) / AUG_VIDEOS * DISK_BATCH
        presets[aug] = {"resize_chain_ms_per_slot": 1e3 * chain_s / slots,
                        "augment_ms_per_slot": 1e3 * aug_s / slots,
                        "ms_per_video": 1e3 * (chain_s + aug_s) / AUG_VIDEOS,
                        "ms_per_batch8": batch_ms, "train_step_ms": step_ms,
                        "share_of_train_step": batch_ms / step_ms, "fired": dict(fired)}
    emit({"phase": "augment", "card": smi, "videos": AUG_VIDEOS, "slots": cfg.model.num_frames,
          "resize_chain_values_differing_card_vs_cpu": chain_differ,
          "transforms": rows, "presets": presets})
    bad = {n: r for n, r in rows.items()
           if r["max_diff_levels"] > (0 if r["bound"] == "bitwise" else 1)}
    if bad:
        raise AssertionError(f"augment: card vs CPU beyond the bound: {bad}")
    if chain_differ:
        raise AssertionError(f"augment: the resize chain differs card vs CPU on {chain_differ}")


def phase_train_disk(smi, cfg, man, faces):
    """The flagship trained from a train split on disk: ``DeepfakesDataset(
    mode="train", augmentation="max")`` through the port's ``DataLoader``
    (batch 8, shuffled, 4 spawned workers), ``DISK_EPOCHS`` epochs through
    ``train.make_train_step``. Returns one step's launches."""
    import numpy as np
    import torch

    from mintime_torch import train
    from mintime_torch.data import augment
    from mintime_torch.data import loader as loader_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = _train_dataset(cfg, man, faces, "max")
    n = len(ds)
    steps_per_epoch = -(-n // DISK_BATCH)
    pos_weight = train.pos_weight_from_labels(np.asarray(man.labels, np.float32))
    model = train.training_model(cfg.model, device="cuda", seed=0)
    state = train.create_train_state(model, cfg, steps_per_epoch=steps_per_epoch,
                                     num_epochs=DISK_EPOCHS, seed=0)
    step = train.make_train_step(model, pos_weight)
    want = {"divided_attention": 18, "geglu_ffn": 18, "token_rows_attention": 0,
            "divided_attention_bwd": 18, "geglu_ffn_bwd": 17, "token_rows_attention_bwd": 0,
            **NO_OTHER_LAUNCHES}

    stats = collections.defaultdict(float)
    untime = _time_loader(loader_mod, stats, [(augment, "resize_chain", "resize_chain_s"),
                                              (augment, "apply_steps", "augment_s")])
    epochs, frames, launches, losses = [], [], [], []
    last = None
    try:
        with loader_mod.DataLoader(ds, DISK_BATCH, shuffle=True, num_workers=DISK_WORKERS, seed=0,
                                   worker_mode="process") as loader:
            for epoch in range(DISK_EPOCHS):
                order = loader._batches()
                stats.clear()
                torch.cuda.reset_peak_memory_stats()
                seen = {}
                t0 = time.perf_counter()
                for b, batch in enumerate(loader):
                    for i, v in enumerate(order[b]):
                        seen[v] = batch["frames"][i].cpu()
                    (metrics, counts), s = _cuda_s(
                        lambda: _step_launches(lambda: step(state, batch)))
                    stats["step_s"] += s
                    launches.append(counts)
                    losses.append(float(metrics["loss"]))
                    last = batch
                epoch_s = time.perf_counter() - t0
                frames.append(seen)
                epochs.append({"epoch_s": epoch_s, "steps": len(order),
                               "steps_per_s": len(order) / epoch_s, "videos_per_s": n / epoch_s,
                               "stage_s": {k: stats[k] for k in (
                                   "loader_wait_s", "transform_s", "resize_chain_s",
                                   "augment_s", "step_s")},
                               "rest_s": epoch_s - stats["loader_wait_s"] - stats["transform_s"]
                               - stats["step_s"],
                               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    finally:
        untime()
    loss_k, _ = _one_step_grads(model, last, pos_weight, True)
    loss_p, _ = _one_step_grads(model, last, pos_weight, False)
    same = [v for v in frames[0] if torch.equal(frames[0][v], frames[1][v])]
    emit({"phase": "train_disk", "card": smi, "videos": n, "batch": DISK_BATCH,
          "workers": DISK_WORKERS, "epochs": epochs, "launches_per_step": launches[0],
          "losses": losses, "loss_kernel": loss_k, "loss_plain": loss_p,
          "videos_same_frames_both_epochs": len(same), "pos_weight": pos_weight})
    if any(c != want for c in launches):
        raise AssertionError(f"train_disk: launches per step {launches}, want {want}")
    if not all(np.isfinite(losses)) or len(losses) != DISK_EPOCHS * steps_per_epoch:
        raise AssertionError(f"train_disk: losses {losses}")
    if not abs(loss_k - loss_p) <= TOL:
        raise AssertionError(f"train_disk: kernel vs plain loss {loss_k} vs {loss_p}")
    if len(same) != n or len(frames[1]) != n:
        raise AssertionError(f"train_disk: {n - len(same)} videos' frames differ between epochs")
    del model, state
    return launches[0]


def phase_train_from_disk(smi, step_ms):
    """Phases ``augment``, ``train_disk`` and ``train_main`` on one train
    split written to a temporary directory in the checkout (phase
    ``evaluate``'s writer: 48 videos as packs, faces of 64-320 px, 1-3
    identities, 24 of each label, DFDC's 1920 x 1080). Returns the launches
    of ``train_disk``'s step and of ``train_main``'s runs."""
    import os
    import tempfile

    from mintime_torch.data.manifest import load_manifest

    cfg = _flagship_train_config()
    with tempfile.TemporaryDirectory(prefix=".train_split_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        faces, split, _ = _write_test_split(d)
        man = load_manifest(split, faces)
        phase_augment(smi, cfg, man, faces, step_ms)
        disk = phase_train_disk(smi, cfg, man, faces)
        return disk, phase_train_main(smi, d, faces, split)


#: phase ``train_main``: epochs of the first run (``--num_epochs 1``), the
#: validation list (every third video of the split), spawned workers
MAIN_EPOCHS, MAIN_VAL_EVERY, MAIN_WORKERS = 2, 3, 4


def train_main_config():
    """``configs/size_invariant_timesformer.yaml`` built in code (the card's
    machine has no yaml; a CPU test holds the two equal)."""
    from mintime_torch.config import MintimeConfig, TestConfig, TrainingConfig

    return MintimeConfig(model=_predict_config(2048).model, training=TrainingConfig(
        lr=0.01, weight_decay=1e-4, bs=8, val_bs=8, optimizer="SGD", scheduler="cosinelr",
        gamma=0.1, step_size=5, augmentation="max"), test=TestConfig(bs=1))


def slowfast_config():
    """``configs/slowfast.yaml`` built in code (a CPU test holds the two equal)."""
    from mintime_torch.config import MintimeConfig, ModelConfig, TestConfig, TrainingConfig

    return MintimeConfig(
        model=ModelConfig(image_size=256, num_classes=1, num_frames=16, max_identities=1,
                          enable_size_emb=False, enable_pos_emb=False,
                          enable_identity_attention=False),
        training=TrainingConfig(lr=0.001, weight_decay=1e-4, bs=32, val_bs=32, optimizer="SGD",
                                scheduler="cosinelr", gamma=0.1, step_size=5,
                                augmentation="max"),
        test=TestConfig(bs=32))


def _val_list(d, split) -> tuple:
    """The split's rows and a validation list of every ``MAIN_VAL_EVERY``-th
    of them written beside it."""
    import os

    with open(split) as f:
        rows = f.read().split("\n")[:-1]
    val = os.path.join(d, "val.csv")
    with open(val, "w") as f:
        f.write("\n".join(rows[::MAIN_VAL_EVERY]) + "\n")
    return rows, val


def _main_argv(d, split, val, *extra):
    import os

    return ["--train_list_file", split, "--validation_list_file", val,
            "--data_path", os.path.join(d, "faces"), "--workers", str(MAIN_WORKERS),
            "--models_output_path", os.path.join(d, "models"),
            "--logger_name", os.path.join(d, "runs"), "--device", "cuda", *extra]


def _watch_main():
    """Hooks on what ``train_loop.main`` runs, read into the returned dict:
    each train and validation step's launches (the counters' growth over the
    step, never reset) and host time ending in a synchronise, the step count
    each train step starts from, the losses, the scalars logged, and each
    epoch's times (from its first step to its scalars: the steps, the
    validation pass after them, then the checkpoint write). ``rec["undo"]()``
    takes the hooks off."""
    import torch

    from mintime_torch import train, train_loop
    from mintime_torch.utils import checkpoint

    rec = {"train": [], "val": [], "epochs": [], "scalars": collections.defaultdict(dict),
           "start_steps": []}
    cur = {}
    saved = [(train, "make_train_step", train.make_train_step),
             (train, "make_eval_step", train.make_eval_step),
             (checkpoint, "save_train_state", checkpoint.save_train_state),
             (train_loop.ScalarLogger, "add_scalar", train_loop.ScalarLogger.add_scalar)]

    def counted(fn, into):
        def run(*a):
            torch.cuda.synchronize()
            before, t = _launch_counts(), time.perf_counter()
            cur.setdefault("first", t)
            out = fn(*a)
            torch.cuda.synchronize()
            after = time.perf_counter()
            counts = _launch_counts()
            rec[into].append({"launches": {k: counts[k] - before[k] for k in counts},
                              "t0": t, "s": after - t, "loss": float(out["loss"])})
            if into == "train":
                cur["last"] = after
                cur["steps"] = cur.get("steps", 0) + 1
            return out
        return run

    def make_train_step(model, pos_weight=1.0, **kw):
        step = counted(saved[0][2](model, pos_weight, **kw), "train")

        def train_step(state, batch):
            if "first" not in cur:
                rec["start_steps"].append(state.step)
            return step(state, batch)
        return train_step

    def make_eval_step(model, pos_weight=1.0, **kw):
        return counted(saved[1][2](model, pos_weight, **kw), "val")

    def save_train_state(*a, **k):
        path, s = _cuda_s(lambda: saved[2][2](*a, **k))
        if rec["epochs"]:  # pretraining logs no scalars, so it has no epoch records
            rec["epochs"][-1]["checkpoint_s"] = s
        return path

    def add_scalar(self, tag, value, step):
        rec["scalars"][step][tag] = float(value)
        if tag == "Training/Loss":
            now = time.perf_counter()
            rec["epochs"].append({"epoch": step, "steps": cur["steps"],
                                  "epoch_s": now - cur["first"],
                                  "train_s": cur["last"] - cur["first"],
                                  "val_s": now - cur["last"], "checkpoint_s": 0.0})
            cur.clear()
        return saved[3][2](self, tag, value, step)

    for (owner, name, _), fn in zip(saved, (make_train_step, make_eval_step, save_train_state,
                                            add_scalar)):
        setattr(owner, name, fn)

    def undo():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    rec["undo"] = undo
    return rec


def phase_train_main(smi, d, faces, split):
    """The training CLI through its function on phase ``train_disk``'s split
    (see 5d in the module's docstring). Returns the launches of both runs."""
    import os

    import numpy as np
    import torch

    from mintime_torch import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, val = _val_list(d, split)
    cfg = train_main_config()
    argv = _main_argv(d, split, val, "--extractor_model", "1", "--patience", "5")
    step = {"divided_attention": 18, "geglu_ffn": 18, "token_rows_attention": 0,
            "divided_attention_bwd": 18, "geglu_ffn_bwd": 17, "token_rows_attention_bwd": 0,
            **NO_OTHER_LAUNCHES}
    # a validation forward runs Xception without gradients: its depthwise kernel
    forward = {**{k: 0 for k in step}, "divided_attention": 18, "geglu_ffn": 18,
               "conv3x3": XC_DW_LAUNCHES}
    runs, launches = [], {}
    for name, epochs in (("first", MAIN_EPOCHS - 1), ("resumed", MAIN_EPOCHS)):
        rec = _watch_main()
        try:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            # the main path: counters at 0 just before, read just after
            result, counts = _step_launches(lambda: train_loop.main(
                argv + ["--num_epochs", str(epochs)], config=cfg))
            run_s = time.perf_counter() - t0
        finally:
            rec["undo"]()
        launches[name] = counts
        n_train = len(rows)
        epochs_out = [{**e, "steps_per_s": e["steps"] / e["train_s"],
                       "videos_per_s": n_train / e["train_s"]} for e in rec["epochs"]]
        runs.append({"run": name, "run_s": run_s, "launches": counts,
                     "epochs": epochs_out, "start_step": rec["start_steps"][0],
                     "checkpoints": [os.path.basename(p) for p in result.checkpoints],
                     "losses": [r["loss"] for r in rec["train"]],
                     "val_losses": [r["loss"] for r in rec["val"]],
                     "val_forward_s": [r["s"] for r in rec["val"]],
                     "train_step_s": [r["s"] for r in rec["train"]],
                     "scalars": dict(rec["scalars"]),
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "_train": rec["train"], "_val": rec["val"], "_result": result})
    emit({"phase": "train_main", "card": smi, "videos": len(rows),
          "val_videos": len(rows[::MAIN_VAL_EVERY]), "batch": cfg.training.bs,
          "workers": MAIN_WORKERS, "extractor": "xception",
          "runs": [{k: v for k, v in r.items() if not k.startswith("_")} for r in runs]})
    steps_per_epoch = -(-len(rows) // cfg.training.bs)
    first, resumed = runs
    last = max(int(p.split("_")[1]) for p in first["checkpoints"])
    for r in runs:
        bad = [x["launches"] for x in r["_train"] if x["launches"] != step]
        bad += [x["launches"] for x in r["_val"] if x["launches"] != forward]
        if bad:
            raise AssertionError(f"train_main: launches {bad[:2]}, want {step} a train step "
                                 f"and {forward} a validation forward")
        if not all(np.isfinite(r["losses"] + r["val_losses"])):
            raise AssertionError(f"train_main: losses {r['losses']} {r['val_losses']}")
        if any("Validation/Loss" not in row for row in r["scalars"].values()):
            raise AssertionError(f"train_main: scalars {r['scalars']}")
    if [e["epoch"] for e in first["epochs"]] != list(range(MAIN_EPOCHS)) or not \
            first["checkpoints"] or first["start_step"] != 0:
        raise AssertionError(f"train_main: first run {first['epochs']} {first['checkpoints']}")
    if [e["epoch"] for e in resumed["epochs"]] != list(range(last + 1, MAIN_EPOCHS + 1)) or \
            resumed["start_step"] != (last + 1) * steps_per_epoch:
        raise AssertionError(f"train_main: the resumed run starts at epoch "
                             f"{resumed['epochs'][:1]} step {resumed['start_step']}, want epoch "
                             f"{last + 1} step {(last + 1) * steps_per_epoch}")
    torch.cuda.empty_cache()
    return {k: launches["first"][k] + launches["resumed"][k] for k in launches["first"]}


#: phase ``slowfast``: timed steps after the checked one; the head's weight scale
SF_TIMED_STEPS, SF_PROJ_STD = 3, 0.002


def slowfast_state_dict(model, seed: int) -> dict:
    """A state_dict for ``model`` (SlowFast, pytorchvideo's keys) drawn from
    ``seed`` on the CPU: convolutions He-normal, BatchNorm scales from [0.5,
    1.5] but each residual branch's last from [0.05, 0.15] (pytorchvideo
    initialises it at 0), shifts and running means N(0, 0.1), running
    variances from [0.5, 1.5], the head N(0, ``SF_PROJ_STD``) with no bias."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("proj.weight"):
            t = torch.randn(v.shape, generator=gen) * SF_PROJ_STD
        elif k.endswith("proj.bias"):
            t = torch.zeros(v.shape)
        elif v.dim() == 5:
            t = torch.randn(v.shape, generator=gen) * math.sqrt(2.0 / v[0].numel())
        elif k.endswith("norm_c.weight"):
            t = torch.rand(v.shape, generator=gen) * 0.1 + 0.05
        elif k.endswith((".running_var", ".weight")):
            t = torch.rand(v.shape, generator=gen) + 0.5
        else:
            t = torch.randn(v.shape, generator=gen) * 0.1
        sd[k] = t
    return sd


def phase_slowfast(smi):
    """SlowFast R-50 at full width (see 5e in the module's docstring).
    Returns the launches of its three runs (all must be 0)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mintime_torch import evaluate, train, train_loop
    from mintime_torch.data import loader as loader_mod
    from mintime_torch.data.manifest import load_manifest
    from mintime_torch.models.slowfast import SlowFastClassifier
    from mintime_torch.utils.checkpoint import load_model_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = slowfast_config()
    zero = {k: 0 for k in _launch_counts()}
    out = {}
    with tempfile.TemporaryDirectory(prefix=".slowfast_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        faces, split, _ = _write_test_split(d)
        man = load_manifest(split, faces)
        weights = os.path.join(d, "slowfast_r50.pth")
        sd = slowfast_state_dict(SlowFastClassifier(device="cpu"), seed=5)
        torch.save({**sd, **{k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
                             for k in sd if k.endswith("running_var")}}, weights)

        # (i) the evaluation function at the yaml's batch, then one video on the CPU in fp32
        logits, stats = {}, collections.defaultdict(float)
        restore = _eval_timers(evaluate, loader_mod, stats, logits)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            report, counts = _step_launches(lambda: evaluate.evaluate_split(
                cfg, weights, split, faces, model=2, workers=4, device="cuda"))
            eval_s = time.perf_counter() - t0
        finally:
            restore()
        eval_stats, eval_mem = dict(stats), torch.cuda.max_memory_allocated() / 2**30
        out["evaluate"] = counts
        cpu_logits = {}
        restore = _eval_timers(evaluate, loader_mod, collections.defaultdict(float), cpu_logits)
        try:
            cpu = evaluate.build_model(cfg, weights, model=2, device="cpu", dtype=torch.float32)
            with evaluate.split_loader(cfg, man.videos[:1], man.labels[:1], man.multiclass[:1],
                                       faces, 1, workers=1, device="cpu") as loader:
                evaluate.evaluate(cpu, None, loader)
            del cpu
        finally:
            restore()
        (first, cpu_logit), = cpu_logits.items()
        card_vs_cpu = abs(logits[first] - cpu_logit)

        # (ii) SGD steps at the yaml's batch through the train step
        model = train.slowfast_training_model(cfg.model, device="cuda", seed=0)
        model.load_state_dict(load_model_state(model, cfg, weights))
        stats0 = {k: v.clone() for k, v in model.named_buffers()}
        ds = _train_dataset(cfg, man, faces, cfg.training.augmentation)
        with loader_mod.DataLoader(ds, cfg.training.bs, shuffle=True, num_workers=4, seed=0,
                                   worker_mode="process") as loader:
            batch = next(iter(loader))
        n = len(batch["labels"])
        pos_weight = train.pos_weight_from_labels(np.asarray(man.labels, np.float32))
        state = train.create_train_state(model, cfg, steps_per_epoch=2, num_epochs=1)
        step = train.make_train_step(model, pos_weight)
        torch.cuda.reset_peak_memory_stats()
        (metrics, counts), first_s = _cuda_s(lambda: _step_launches(lambda: step(state, batch)))
        out["train_step"] = counts
        no_grad = [k for k, p in model.named_parameters() if p.grad is None
                   or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
        still = [k for k, v in model.named_buffers() if torch.equal(v, stats0[k])]
        losses = [float(metrics["loss"])]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(SF_TIMED_STEPS):
            losses.append(float(step(state, batch)["loss"]))
        end.record()
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        step_ms = start.elapsed_time(end) / SF_TIMED_STEPS
        train_mem = torch.cuda.max_memory_allocated() / 2**30
        del model, state, step
        torch.cuda.empty_cache()

        # (iii) one epoch of the training CLI
        rows, val = _val_list(d, split)
        rec = _watch_main()
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result, counts = _step_launches(lambda: train_loop.main(
                _main_argv(d, split, val, "--model", "2", "--num_epochs", "0"), config=cfg))
            main_s = time.perf_counter() - t0
        finally:
            rec["undo"]()
        out["train_main"] = counts
        epoch = rec["epochs"][0]
        main_mem = torch.cuda.max_memory_allocated() / 2**30

    emit({"phase": "slowfast", "card": smi, "videos": len(man), "batch": cfg.training.bs,
          "frames": {"fast": 32, "slow": 8, "side": 256},
          "evaluate": {"s": eval_s, "videos_per_s": report["n_videos"] / eval_s,
                       "stage_s": eval_stats, "peak_mem_gib": eval_mem, "report": report,
                       "first_video_logit_card_bf16": logits[first],
                       "first_video_logit_cpu_fp32": cpu_logit,
                       "card_vs_cpu": card_vs_cpu},
          "train_steps": {"batch": n, "first_step_s": first_s, "device_ms_per_step": step_ms,
                          "steps_per_s": SF_TIMED_STEPS / steps_s,
                          "videos_per_s": SF_TIMED_STEPS * n / steps_s, "losses": losses,
                          "params_without_finite_nonzero_grad": no_grad,
                          "buffers_unmoved": still, "peak_mem_gib": train_mem},
          "train_main": {"s": main_s, "epoch": {**epoch,
                                                "steps_per_s": epoch["steps"] / epoch["train_s"],
                                                "videos_per_s": len(rows) / epoch["train_s"]},
                         "losses": [r["loss"] for r in rec["train"]],
                         "val_losses": [r["loss"] for r in rec["val"]],
                         "checkpoints": [os.path.basename(p) for p in result.checkpoints],
                         "peak_mem_gib": main_mem},
          "launches": out})
    if any(c != zero for c in out.values()):
        raise AssertionError(f"slowfast: hand-written kernels launched: {out}")
    if not (report["n_videos"] == len(man) and _finite_report(report)):
        raise AssertionError(f"slowfast: report {report}")
    if not card_vs_cpu <= 5e-2:
        raise AssertionError(f"slowfast: bf16 card vs fp32 CPU logit {logits[first]} vs "
                             f"{cpu_logit}")
    if no_grad or still or not np.isfinite(losses).all():
        raise AssertionError(f"slowfast: gradients {no_grad[:4]}, unmoved statistics "
                             f"{still[:4]}, losses {losses}")
    main_losses = [r["loss"] for r in rec["train"] + rec["val"]]
    if not (result.checkpoints and np.isfinite(main_losses).all() and main_losses):
        raise AssertionError(f"slowfast: train_loop.main {result} {main_losses}")
    return {k: sum(c[k] for c in out.values()) for k in zero}


# ---------------------------------------------------------------------------
# The tooling: the profiler CLI, feature extraction, the weight check,
# extractor pretraining, data and tensor parallelism
# ---------------------------------------------------------------------------

#: phase ``profiling``: traced calls a run of ``profiling.main``, tries for a
#: trace that lost no kernel
PROF_ITERS, PROF_TRIES = 3, 3


def _table_launches(rows, kind: str) -> int:
    """The most launched kernel of a table layer, its template variants
    summed (the FFN forward's differ between token and CLS rows)."""
    by_kernel = collections.Counter()
    for r in rows:
        if r["type"] == kind:
            by_kernel[re.search(r"(\w+_kernel)", r["name"]).group(1)] += r["launches"]
    return max(by_kernel.values(), default=0)


def _profiling_run(argv, cfg, kinds: dict) -> dict:
    """``profiling.main(argv)`` on the card, its launches read from 0: each of
    ``kinds`` (a table layer → a wrapper's counter) must name kernels whose
    launches in the trace match the counter over the traced calls. A trace
    that misses one is taken again, up to ``PROF_TRIES`` runs. Records of
    other kernels that the trace lost (``kernels_lost``: in this script's
    process the same few of PyTorch's copies, convolutions and BatchNorm
    every time) make the table's totals lower bounds; phase ``profile``'s
    windows (``_profile``) give the device time."""
    from mintime_torch.utils import profiling

    tries = []
    for _ in range(PROF_TRIES):
        out, counts = _step_launches(lambda: profiling.main(argv, config=cfg))
        table = {kind: _table_launches(out["rows"], kind) for kind in kinds}
        tries.append({"table": table, "kernels_lost": out["kernels_lost"]})
        if all(table[k] == out["launches"][w] for k, w in kinds.items()):
            break
    else:
        raise AssertionError(f"profiling: the table's launches against the counters "
                             f"{out['launches']} in {PROF_TRIES} runs: {tries}")
    return {"videos_per_s": out["videos_per_s"], "what": out["what"], "launches": counts,
            "traced_launches": out["launches"], "table_launches": table,
            "kernels_lost": out["kernels_lost"], "tries": len(tries),
            "top": [{k: r[k] for k in ("name", "type", "section", "self_ms", "launches")}
                    for r in out["rows"][:8]]}


def phase_profiling(smi):
    """The profiler CLI (``profiling.main``) at flagship width, batch 8, a
    forward and ``--train``, each traced ``PROF_ITERS`` times. Returns the
    launches of both runs."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix=".trace_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        argv = ["--model", "1", "--batch", "8", "--iters", str(PROF_ITERS), "--device", "cuda",
                "--fused_attention", "1", "--trace_dir", d]
        cfg = _predict_config(1280)
        fwd = {"divided_attention kernel": "divided_attention", "geglu_ffn kernel": "geglu_ffn"}
        runs = {"forward": _profiling_run(argv, cfg, fwd),
                "train": _profiling_run(argv + ["--train"], cfg, {
                    **fwd, "divided_attention backward kernel": "divided_attention_bwd",
                    "geglu_ffn backward kernel": "geglu_ffn_bwd"})}
    # the classifier without attention maps: every layer on the kernels
    want = {"forward": {"divided_attention": 18, "geglu_ffn": 18},
            "train": {"divided_attention": 18, "geglu_ffn": 18, "divided_attention_bwd": 18,
                      "geglu_ffn_bwd": 17}}
    for name, run in runs.items():
        per_call = {k: v / PROF_ITERS for k, v in run["traced_launches"].items() if v}
        if per_call != want[name]:
            raise AssertionError(f"profiling {name}: launches a call {per_call}, want {want[name]}")
        emit({"phase": "profiling", "card": smi, "run": name, "batch": 8, "iters": PROF_ITERS,
              **run})
    return {k: runs["forward"]["launches"][k] + runs["train"]["launches"][k]
            for k in runs["forward"]["launches"]}


#: phase ``extract_features``: batch, the crops held card vs CPU, the batches profiled
FEAT_BATCH, FEAT_CHECKED, FEAT_PROFILED = 64, 8, 4


def phase_extract_features(smi, d, faces):
    """B0 features of every crop of a split of packs (phase ``evaluate``'s
    writer) through ``extract_features.extract_features`` on the card at
    batch 64, from an ``Extractor_checkpoint`` file of seeded weights; the
    first crops' maps against the CPU in fp32."""
    import os

    import numpy as np
    import torch

    from mintime_torch.data.crop_store import CropPack, find_pack
    from mintime_torch.data.frames import pack_crop_names
    from mintime_torch.preprocessing import extract_features as ef

    paths, crops = [], []
    for root, _, files in sorted(os.walk(faces)):
        if find_pack(root):
            pack = CropPack(find_pack(root))
            for i, name in enumerate(pack_crop_names(pack)):
                paths.append(os.path.join(root, name))
                crops.append(pack.read(i))
    _, ext = _write_model_files(d, 0, "efficientnet-b0", 1280)
    model = ef.build_extractor(ext, device="cuda")
    out = os.path.join(d, "features")
    ef.extract_features(paths[:FEAT_BATCH], model, os.path.join(d, "warm"), faces,
                        crops=crops[:FEAT_BATCH], batch_size=FEAT_BATCH)  # cuDNN's first use
    torch.cuda.reset_peak_memory_stats()
    n, s = _cuda_s(lambda: ef.extract_features(paths, model, out, faces, crops=crops,
                                               batch_size=FEAT_BATCH))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # where the time goes: the card's busy and idle share over the first batches
    n_prof = FEAT_PROFILED * FEAT_BATCH
    prof = _profile(lambda: ef.extract_features(paths[:n_prof], model, os.path.join(d, "prof"),
                                                faces, crops=crops[:n_prof],
                                                batch_size=FEAT_BATCH))
    cpu = os.path.join(d, "features_cpu")
    ef.extract_features(paths[:FEAT_CHECKED], ef.build_extractor(ext, device="cpu"), cpu, faces,
                        crops=crops[:FEAT_CHECKED], batch_size=FEAT_CHECKED)
    errs = []
    for p in paths[:FEAT_CHECKED]:
        rel = os.path.splitext(os.path.relpath(p, faces))[0] + ".npy"
        got, want = np.load(os.path.join(out, rel)), np.load(os.path.join(cpu, rel))
        errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
    written = sum(len(f) for _, _, f in os.walk(out))
    emit({"phase": "extract_features", "card": smi, "crops": len(paths), "batch": FEAT_BATCH,
          "s": s, "crops_per_s": len(paths) / s, "written": written,
          "max_err_over_max_cpu": max(errs), "peak_mem_gib": peak_gib,
          "profiled_crops": n_prof, "profile": {k: prof[k] for k in (
              "host_window_ms", "device_busy_ms", "device_idle_share", "kernels",
              "kernels_lost", "ms_by_layer")}})
    if n != len(paths) or written != len(paths) or not max(errs) <= 5e-2:
        raise AssertionError(f"extract_features: {n} / {written} files of {len(paths)}, "
                             f"card vs CPU {errs}")


def phase_verify_weights(smi, d):
    """``verify_weights.main`` on seeded weight files in the published formats
    (phase ``predict``'s MTCNN, FaceNet and MINTIME-EF files, phase
    ``slowfast``'s ``slowfast_r50`` file, wrapped as the hub file is): rc 0 and
    every arm's ``[ OK ]`` lines. Returns the launches of the run."""
    import contextlib
    import io
    import os

    import torch

    from mintime_torch import verify_weights
    from mintime_torch.models.slowfast import SlowFastClassifier

    files = _write_weight_files(d)
    sf = os.path.join(d, "SLOWFAST_8x8_R50.pyth")
    torch.save({"model_state": slowfast_state_dict(SlowFastClassifier(device="cpu"), seed=5)}, sf)
    head, ext = files["predict_ef"]
    argv = ["--mtcnn_weights", files["mtcnn"], "--facenet_weights", files["facenet"],
            "--model_weights", head, "--extractor_weights", ext, "--extractor_model", "0",
            "--slowfast_weights", sf, "--device", "cuda"]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc, counts = _step_launches(lambda: verify_weights.main(argv, config=_predict_config(1280)))
    ok = [ln for ln in printed.getvalue().splitlines() if ln.startswith("[ OK ]")]
    emit({"phase": "verify_weights", "card": smi, "rc": rc, "s": time.perf_counter() - t0,
          "ok_lines": ok, "launches": counts})
    want = {**{k: 0 for k in counts}, "divided_attention": 16, "geglu_ffn": 18}
    if rc != 0 or len(ok) < 8 or counts != want:
        raise AssertionError(f"verify_weights: rc {rc}, {len(ok)} OK lines, launches {counts}")
    return counts


def pretrain_config():
    """``configs/extractor_pretraining.yaml`` built in code (a CPU test holds
    the two equal)."""
    from mintime_torch.config import MintimeConfig, ModelConfig, TrainingConfig

    return MintimeConfig(model=ModelConfig(image_size=224, num_classes=1), training=TrainingConfig(
        lr=0.01, weight_decay=1e-7, bs=16, optimizer="SGD", scheduler="steplr", gamma=0.1,
        step_size=15, rebalancing_fake=0.3, rebalancing_real=1.0, frames_per_video=30,
        augmentation="min"))


#: phase ``pretrain``: epochs (``--num_epochs 1``), spawned workers
PRE_EPOCHS, PRE_WORKERS = 2, 4


def phase_pretrain(smi, d, faces, split):
    """``pretrain_extractor.main`` with the yaml's config (224 px, batch 16,
    the ``min`` preset, SGD, StepLR) for 2 epochs on the split's videos of
    packs, every third as the validation list. The exported extractor must
    equal the checkpoint's bitwise and load into MINTIME-EF bitwise. Returns
    the run's launches (none: B0 has no hand-written kernel)."""
    import os

    import torch

    from mintime_torch import pretrain_extractor
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.utils.checkpoint import load_model_state

    _, val = _val_list(d, split)
    out = os.path.join(d, "pretrain")
    argv = ["--train_list_file", split, "--validation_list_file", val, "--data_path", faces,
            "--num_epochs", str(PRE_EPOCHS - 1), "--workers", str(PRE_WORKERS),
            "--models_output_path", out, "--device", "cuda"]
    rec = _watch_main()
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        best, counts = _step_launches(
            lambda: pretrain_extractor.main(argv, config=pretrain_config()))
        run_s = time.perf_counter() - t0
    finally:
        rec["undo"]()
    steps = rec["train"]
    per_epoch = len(steps) // PRE_EPOCHS
    warm = steps[per_epoch:]
    step_s = sum(r["s"] for r in warm)
    epoch_s = warm[-1]["t0"] + warm[-1]["s"] - warm[0]["t0"]  # its steps, the loader between
    ck = torch.load(os.path.join(out, f"checkpoint_{best.rsplit('checkpoint', 1)[1]}"),
                    weights_only=True)["params"]
    exported = torch.load(best, weights_only=True)
    same = all(torch.equal(exported[k[len("extractor."):]], v)
               for k, v in ck.items() if k.startswith("extractor."))
    ef = MintimeVideoClassifier(_predict_config(1280).model, device="cuda",
                                param_dtype=torch.float32)
    head = os.path.join(d, "Model_checkpoint_efficientnet-b0")
    ef.load_state_dict(load_model_state(ef, None, head, extractor_weights=best))
    loaded = all(torch.equal(ef.state_dict()[f"extractor.{k}"].cpu(), v)
                 for k, v in exported.items())
    emit({"phase": "pretrain", "card": smi, "batch": 16, "image_size": 224, "epochs": PRE_EPOCHS,
          "steps": len(steps), "run_s": run_s, "warm_epoch_s": epoch_s,
          "steps_per_s_warm": len(warm) / epoch_s, "images_per_s_warm": 16 * len(warm) / epoch_s,
          "warm_step_ms": 1e3 * step_s / len(warm), "step_share": step_s / epoch_s,
          "losses": [r["loss"] for r in steps], "val_losses": [r["loss"] for r in rec["val"]],
          "exported": os.path.basename(best), "export_equals_checkpoint": same,
          "loads_into_mintime_ef_bitwise": loaded, "launches": counts,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    import numpy as np

    if not (same and loaded and all(np.isfinite([r["loss"] for r in steps + rec["val"]]))
            and not any(counts.values())):
        raise AssertionError(f"pretrain: export {same} / {loaded}, launches {counts}")
    return counts


def phase_tooling(smi):
    """Phases ``extract_features``, ``verify_weights``, ``pretrain`` and the
    one-rank NCCL run of ``parallel`` on one split of packs written to a
    temporary directory in the checkout (phase ``evaluate``'s writer).
    Returns the launches of each path."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix=".tooling_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        faces, split, _ = _write_test_split(d)
        phase_extract_features(smi, d, faces)
        paths = {"verify_weights": phase_verify_weights(smi, d),
                 "pretrain": phase_pretrain(smi, d, faces, split)}
        paths["train_main_nccl"] = phase_parallel_nccl(smi, d, faces, split)
    return paths


#: phase ``parallel``: seconds a spawned rank may take; steps timed after the checked one
PAR_LIMIT_S, PAR_WARM_STEPS = 240, 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(target, world: int, args: tuple, d: str) -> list:
    """``target(rank, world, port, *args, out)`` in ``world`` spawned
    processes on the one card, each writing its result to ``out``; a rank
    past ``PAR_LIMIT_S`` is killed and fails the phase."""
    import multiprocessing as mp
    import os

    import torch

    ctx = mp.get_context("spawn")
    port = _free_port()
    outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, port, *args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_LIMIT_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    late = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if late or any(p.exitcode for p in procs):
        raise AssertionError(f"parallel: ranks {late} late, exit codes "
                             f"{[p.exitcode for p in procs]}")
    return [torch.load(o, weights_only=False) for o in outs]


def _rank_env(rank: int, world: int, port: int) -> None:
    import os

    # LOCAL_RANK 0 for every rank: the processes share the one card
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")


def _parallel_step(cfg, model, batch, pos_weight, mesh) -> dict:
    """One checked train step of ``model`` on ``batch`` through the mesh (its
    launches counted from 0, its gradients and the parameters after it),
    then ``PAR_WARM_STEPS`` more timed."""
    import torch

    from mintime_torch import train
    from mintime_torch.parallel.mesh import TensorParallelGEGLU

    state = train.create_train_state(model, cfg, steps_per_epoch=5, num_epochs=1, seed=0)
    step = train.make_train_step(model, pos_weight, mesh=mesh)
    t0 = time.perf_counter()
    metrics, counts = _step_launches(lambda: step(state, batch))
    step_s = time.perf_counter() - t0
    out = {"loss": float(metrics["loss"]), "launches": counts, "step_s": step_s,
           "rows": len(batch["labels"]),
           "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()},
           "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
           "heads": sorted({m.heads for m in model.modules() if hasattr(m, "heads")}),
           "hidden": [m.net["3"].weight.shape[1] for m in model.modules()
                      if isinstance(m, TensorParallelGEGLU)][:1]}
    out["warm_step_s"] = [_cuda_s(lambda: step(state, batch))[1] for _ in range(PAR_WARM_STEPS)]
    return out


def _plain_fp32(mcfg):
    """The flagship on the plain path in fp32 from seed 0 (TF32 off by the caller)."""
    import torch

    from mintime_torch.models.classifier import MintimeVideoClassifier

    return MintimeVideoClassifier(mcfg, use_kernels=False, device="cuda", dtype=torch.float32,
                                  param_dtype=torch.float32, seed=0)


def _tp_shard(name: str, full, rank: int, tp: int, heads: int):
    """Model rank ``rank``'s part of a whole tensor of the TimeSformer head
    by the Megatron rule: q, k and v each by heads, both GEGLU halves by
    hidden units, row-parallel weights by input features."""
    from mintime_torch.parallel import mesh as pm

    spec = pm._tp_spec(name)
    if spec == "replicated":
        return full
    if spec == "row":
        n = full.shape[1] // tp
        return full[:, rank * n:(rank + 1) * n]
    if "to_qkv" in name:
        return full[pm._heads_rows(heads, full.shape[0] // (3 * heads), tp, rank)]
    return full[pm._halves_rows(full.shape[0] // 2, tp, rank)]


def _tp_fp32_check(mcfg, batch, pos_weight, mesh) -> dict:
    """TP=2 on the plain path in fp32 against the same model in one piece on
    the whole batch: eval-mode logits within 1e-4 of their max, the step's
    loss within 1e-4 relative, and each head parameter's gradient (this
    rank's part of the whole one) within 1e-3 of its max. A wrong split or a
    missing all-reduce, forward or backward, moves these by far more."""
    import torch

    from mintime_torch import train
    from mintime_torch.parallel.mesh import MODEL_AXIS, axis_rank, axis_size, tensor_parallel

    model = _plain_fp32(mcfg)
    inputs = train.model_inputs(batch, model.head_kind, model.device)
    with torch.no_grad():
        logits_one = model(*inputs, train=False).float()
    loss_one, g_one = _one_step_grads(model, batch, pos_weight, False)
    set_use_kernels(model, False)
    tensor_parallel(model, mesh)
    with torch.no_grad():
        logits_tp = model(*inputs, train=False).float()
    loss_tp, g_tp = _one_step_grads(model, batch, pos_weight, False)
    rank, tp = axis_rank(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS)
    errs = {}
    for n, g in g_tp.items():
        if n.startswith("head.") and g is not None:
            want = _tp_shard(n, g_one[n], rank, tp, mcfg.heads)
            errs[n] = float((g - want).abs().max()) / float(want.abs().max())
    worst = max(errs, key=errs.get)
    out = {"loss_tp": loss_tp, "loss_one": loss_one,
           "logits_err_over_max": float((logits_tp - logits_one).abs().max())
           / float(logits_one.abs().max()),
           "head_tensors": len(errs), "worst_head_grad_tensor": worst,
           "worst_head_grad_err_over_max": errs[worst]}
    if not (out["logits_err_over_max"] <= 1e-4 and abs(loss_tp - loss_one) <= 1e-4 * abs(loss_one)
            and errs[worst] <= 1e-3):
        raise AssertionError(f"parallel tp2 fp32 against one process: {out}")
    del model
    torch.cuda.empty_cache()
    return out


def _parallel_rank(rank, world, port, smi, batch_path, out):
    """One rank of phase ``parallel`` over gloo on the card (NCCL refuses two
    ranks on one card). Data-parallel, on this rank's half of the batch: the
    plain path's step in fp32, then the kernels held to phase ``train``'s
    rule with every run data-parallel, then the flagship's bf16 step with
    the kernels. Tensor-parallel, on the whole batch with half the heads and
    hidden units: the plain path in fp32 against one process, the kernels
    held to phase ``train``'s rule (logits too), then the bf16 step."""
    _rank_env(rank, world, port)
    import torch
    import torch.distributed as dist

    from mintime_torch import train
    from mintime_torch.parallel.mesh import make_mesh, shard_batch, tensor_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    cfg, batch, pos_weight = torch.load(batch_path, weights_only=False)
    checks = []
    dp_mesh = make_mesh(device="cuda")
    rows = shard_batch(dp_mesh, batch)
    fp32 = _parallel_step(cfg, _plain_fp32(cfg.model), rows, pos_weight, dp_mesh)
    torch.cuda.empty_cache()
    model = train.training_model(cfg.model, device="cuda", seed=0)
    _grad_check(smi, "parallel_dp2_check", model, _plain_fp32(cfg.model), rows, pos_weight,
                [n for n, _ in model.named_parameters()], mesh=dp_mesh, report=checks.append,
                check_logits=True)
    del model
    dp = _parallel_step(cfg, train.training_model(cfg.model, device="cuda", seed=0), rows,
                        pos_weight, dp_mesh)
    torch.cuda.empty_cache()
    tp_mesh = make_mesh(model_parallel=2, device="cuda")
    tp32 = _tp_fp32_check(cfg.model, batch, pos_weight, tp_mesh)
    model = tensor_parallel(train.training_model(cfg.model, device="cuda", seed=0), tp_mesh)
    _grad_check(smi, "parallel_tp2_check", model,
                tensor_parallel(_plain_fp32(cfg.model), tp_mesh), batch, pos_weight,
                [n for n, _ in model.named_parameters()], report=checks.append,
                check_logits=True)
    del model
    torch.cuda.empty_cache()
    tp = _parallel_step(cfg, tensor_parallel(train.training_model(cfg.model, device="cuda",
                                                                  seed=0), tp_mesh),
                        batch, pos_weight, tp_mesh)
    torch.save({"fp32": fp32, "dp": dp, "tp": tp, "tp32": tp32, "checks": checks}, out)
    dist.destroy_process_group()


def _nccl_main_rank(rank, world, port, argv, out):
    """One rank of a ``torchrun``-like launch of ``train_loop.main``: the
    process group from the environment, NCCL on the card."""
    _rank_env(rank, world, port)
    import torch
    import torch.distributed as dist

    from mintime_torch import train_loop

    result, counts = _step_launches(
        lambda: train_loop.main(argv, config=_flagship_train_config()))
    torch.save({"backend": dist.get_backend(), "world": dist.get_world_size(),
                "epochs_run": result.epochs_run, "checkpoints": result.checkpoints,
                "best_val_loss": result.best_val_loss, "launches": counts}, out)
    dist.destroy_process_group()


def phase_parallel_nccl(smi, d, faces, split):
    """A one-rank NCCL group (the environment of ``torchrun --nproc_per_node
    1``) running ``train_loop.main`` for one step of 8 videos and their
    validation pass. Returns its launches."""
    import os

    _, val = _val_list(d, split)
    argv = ["--train_list_file", split, "--validation_list_file", val, "--data_path", faces,
            "--num_epochs", "0", "--max_videos", "8", "--workers", "2",
            "--models_output_path", os.path.join(d, "nccl_models"),
            "--logger_name", os.path.join(d, "nccl_runs"), "--device", "cuda"]
    t0 = time.perf_counter()
    (run,) = _spawn_ranks(_nccl_main_rank, 1, (argv,), d)
    emit({"phase": "parallel", "card": smi, "run": "nccl_train_main", "s": time.perf_counter() - t0,
          **{k: v for k, v in run.items() if k != "checkpoints"},
          "checkpoints": [os.path.basename(c) for c in run["checkpoints"]]})
    want = {**{k: 0 for k in run["launches"]}, "divided_attention": 36, "geglu_ffn": 36,
            "divided_attention_bwd": 18, "geglu_ffn_bwd": 17}
    if run["backend"] != "nccl" or run["world"] != 1 or run["epochs_run"] != 1 or \
            run["launches"] != want or len(run["checkpoints"]) != 1:
        raise AssertionError(f"parallel nccl_train_main: {run}")
    return run["launches"]


def phase_parallel(smi):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    card), against one process at batch 8. DP=2, batch 8 as 4 + 4: the plain
    path's step in fp32 (TF32 off), each gradient within 1e-3 of its
    tensor's max |value|, the tensors zero in exact arithmetic aside by phase
    ``train``'s rule (an fp32 max under 2^-8 of the bf16 one); the kernels
    against the plain path, every run data-parallel, by phase ``train``'s
    rule on each gradient and the logits (``_grad_check``); then the
    flagship's train step at full width in bf16 with the kernels, its loss
    within 2e-2 of one process's, its launches 18 / 18 / 18 / 17 a rank and
    the ranks' parameters bitwise equal after it. TP=2 (4 heads and 1024
    hidden units a rank): the plain path in fp32 against one process (logits
    and loss within 1e-4, head gradients within 1e-3), the kernels at those
    shapes by phase ``train``'s rule, then the bf16 step, its loss within
    2e-2 and its launches counted. Returns the launches of each rank's
    step."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mintime_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, batch, pos_weight = _flagship_train_batch()
    model = train.training_model(cfg.model, device="cuda", seed=0)
    loss_one, g_one = _one_step_grads(model, batch, pos_weight, True)
    ref = _plain_fp32(cfg.model)
    loss_32, g32 = _one_step_grads(ref, batch, pos_weight, False)
    del model, ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix=".parallel_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        batch_path = os.path.join(d, "batch.pt")
        cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
        torch.save((cfg, cpu, pos_weight), batch_path)
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_parallel_rank, 2, (smi, batch_path), d)
        run_s = time.perf_counter() - t0
    fp32, dp, tp, tp32 = ([r[k] for r in ranks] for k in ("fp32", "dp", "tp", "tp32"))
    for r, run in enumerate(ranks):
        for check in run["checks"]:
            emit({**check, "rank": r})

    fp32_err, zero = {}, []
    for n, g in g32.items():
        top = 0.0 if g_one[n] is None else float(g_one[n].abs().max())
        if not top:  # no gradient: the last layer's token FFN
            continue
        if float(g.abs().max()) <= 2**-8 * top:
            # zero in exact arithmetic (phase train's rule): the _bn2 biases
            # under a train-mode BatchNorm hold rounding noise on both sides
            zero.append(n)
            continue
        fp32_err[n] = float((fp32[0]["grads"][n].to(g.device) - g).abs().max()) / \
            float(g.abs().max())
    worst32 = max(fp32_err, key=fp32_err.get)
    same = [n for n in dp[0]["params"] if not torch.equal(dp[0]["params"][n], dp[1]["params"][n])]
    hidden = cfg.model.dim * 4 // 2
    emit({"phase": "parallel", "card": smi, "run": "dp2_gloo", "batch": 8, "ranks_s": run_s,
          "rows_per_rank": [r["rows"] for r in dp],
          "rank_first_step_s": [r["step_s"] for r in dp],
          "rank_warm_step_s": [r["warm_step_s"] for r in dp],
          "fp32_loss_dp": [r["loss"] for r in fp32], "fp32_loss_one": loss_32,
          "fp32_rank_warm_step_s": [r["warm_step_s"] for r in fp32],
          "zero_in_fp32": zero, "fp32_worst_grad_tensor": worst32,
          "fp32_worst_err_over_max": fp32_err[worst32],
          "fp32_median_err_over_max": float(np.median(list(fp32_err.values()))),
          "loss_dp": [r["loss"] for r in dp], "loss_one_process": loss_one,
          "params_differing_across_ranks": same, "launches": [r["launches"] for r in dp]})
    emit({"phase": "parallel", "card": smi, "run": "tp2_gloo", "batch": 8,
          "heads": [r["heads"] for r in tp], "hidden": [r["hidden"] for r in tp],
          "fp32_against_one_process": tp32,
          "rank_first_step_s": [r["step_s"] for r in tp],
          "rank_warm_step_s": [r["warm_step_s"] for r in tp], "loss_tp": [r["loss"] for r in tp],
          "loss_tp1": loss_one, "launches": [r["launches"] for r in tp]})
    step = {**{k: 0 for k in dp[0]["launches"]}, "divided_attention": 18, "geglu_ffn": 18,
            "divided_attention_bwd": 18, "geglu_ffn_bwd": 17}
    if any(not abs(r["loss"] - loss_one) <= TOL for r in dp + tp) or \
            any(not abs(r["loss"] - loss_32) <= 1e-4 * abs(loss_32) for r in fp32):
        raise AssertionError(f"parallel: losses {[r['loss'] for r in dp + tp]} vs {loss_one}, "
                             f"fp32 {[r['loss'] for r in fp32]} vs {loss_32}")
    if not fp32_err[worst32] <= 1e-3 or same:
        raise AssertionError(f"parallel dp2: fp32 gradient {worst32} off by {fp32_err[worst32]}"
                             f" of its max; parameters differing across ranks {same[:4]}")
    if any(r["launches"] != step for r in dp + tp) or \
            any(r["heads"] != [cfg.model.heads // 2] or r["hidden"] != [hidden] for r in tp):
        raise AssertionError(f"parallel: launches {[r['launches'] for r in dp + tp]}, "
                             f"TP shards {[(r['heads'], r['hidden']) for r in tp]}")
    return {f"parallel_{name}_rank{r}": run["launches"]
            for name, runs in (("dp2", dp), ("tp2", tp)) for r, run in enumerate(runs)}


def conv_model_config(tap: int = 20):
    """The Convolutional TimeSformer preset: the model section of
    ``configs/convolutional_timesformer.yaml`` (the card's machine has no
    yaml; a CPU test holds the two equal), its EfficientNet tapped at block
    ``tap`` (the yaml's 20 by default; at 10 the tokens are 192 channel maps
    of 7 x 7)."""
    from mintime_torch.config import ModelConfig

    return ModelConfig(image_size=224, num_classes=1, num_frames=8, num_patches=1280, dim=256,
                       depth=4, heads=6, dim_head=64, channels=1280, attn_dropout=0.0,
                       ff_dropout=0.0, shift_tokens=False, efficient_net_block=tap)


def _conv_batch(n=8):
    """``bench.py:429-435``'s inputs for the conv model: standard-normal
    frames from seed 0, an all-true mask, size bucket 1; half labelled fake."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {"frames": rng.standard_normal((n, 8, 224, 224, 3)).astype(np.float32),
            "mask": np.ones((n, 8), bool), "size_embedding": np.ones((n, 8), np.int32),
            "labels": np.array([0.0, 1.0] * (n // 2), np.float32)}


#: launches of the conv model by tap block, (per forward, per train step's
#: backward). At block 20: 4 layers x (one token-row time axis, two FFNs),
#: the space axis (L = 1280) plain. At block 10: both axes whole-slice (8 x
#: 192 x 1152 x 2 B = 3.5 MB a slice), so 4 x 2 divided-attention launches
#: and no token rows. Backward the same, but for the last layer's token FFN,
#: whose output reaches no logit
CONV_LAUNCHES = {
    20: ({"divided_attention": 0, "geglu_ffn": 8, "token_rows_attention": 4},
         {"divided_attention_bwd": 0, "geglu_ffn_bwd": 7, "token_rows_attention_bwd": 4}),
    10: ({"divided_attention": 8, "geglu_ffn": 8, "token_rows_attention": 0},
         {"divided_attention_bwd": 8, "geglu_ffn_bwd": 7, "token_rows_attention_bwd": 0}),
}


def _conv_phase(tap: int) -> str:
    return "conv" if tap == 20 else f"conv_tap{tap}"


def phase_conv(smi, tap: int = 20):
    """The Convolutional TimeSformer preset tapped at block ``tap`` at full
    width, bf16 weights from seed 0, through ``train.make_eval_step`` at
    batch 8."""
    import numpy as np
    import torch

    from mintime_torch import train
    from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = conv_model_config(tap)
    phase = _conv_phase(tap)
    fwd_want, bwd_want = CONV_LAUNCHES[tap]
    t0 = time.perf_counter()
    model = ConvolutionalTimeSformer(mcfg, use_kernels=True, device="cuda", seed=0)
    build_model_s = time.perf_counter() - t0
    batch = _conv_batch()
    eval_step = train.make_eval_step(model, 1.0)

    # the main path: counters at 0 just before, read just after
    t0 = time.perf_counter()
    out, counts = _step_launches(lambda: eval_step(None, batch))
    first_s = time.perf_counter() - t0
    want = {**fwd_want, **{k: 0 for k in bwd_want}, **NO_OTHER_LAUNCHES}
    if counts != want:
        raise AssertionError(f"{phase} launches per forward {counts}, want {want}")
    logits_k = out["logits"].float().cpu().numpy()
    assert logits_k.shape == (8,) and np.isfinite(logits_k).all()

    set_use_kernels(model, False)
    logits_p = eval_step(None, batch)["logits"].float().cpu().numpy()
    set_use_kernels(model, True)
    logit_err = float(np.abs(logits_k - logits_p).max())
    # the same weights in fp32 on the CPU (plain path) on the first video
    cpu = ConvolutionalTimeSformer(mcfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        logit_cpu = float(cpu(torch.from_numpy(batch["frames"][:1]), None,
                              torch.from_numpy(batch["size_embedding"][:1]))[0, 0])
    del cpu
    cpu_err = abs(logit_cpu - float(logits_k[0]))
    emit({"phase": f"{phase}_check", "logits_kernel": logits_k.tolist(),
          "logits_plain": logits_p.tolist(), "kernel_vs_plain_logit_err": logit_err,
          "cpu_fp32_logit": logit_cpu, "card_vs_cpu_fp32_logit_err": cpu_err})
    if not logit_err <= TOL:
        raise AssertionError(f"{phase} kernel vs plain logits differ by {logit_err} > {TOL}")
    if not cpu_err <= 5e-2:
        raise AssertionError(f"{phase} bf16 card vs fp32 CPU logit differs by {cpu_err} > 5e-2")

    def run():
        eval_step(None, batch)
        torch.cuda.synchronize()

    samples = []
    for _ in range(5):
        t = time.perf_counter()
        run()
        samples.append(time.perf_counter() - t)
    samples.sort()
    fwd_ms = time_ms(lambda: eval_step(None, batch), iters=5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    run()
    emit({"phase": phase, "card": smi, "tap_block": tap, "batch": 8, "launches": counts,
          "build_model_s": build_model_s, "first_forward_s": first_s,
          "videos_per_s_batch8": 8 / samples[len(samples) // 2], "batch8_s": samples,
          "forward_batch8_device_ms": fwd_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "profile", "card": smi, "what": f"{phase} forward", "batch": 8,
          **_profile(run)})
    return counts


def phase_conv_train(smi, tap: int = 20):
    """The Convolutional TimeSformer preset tapped at block ``tap`` with fp32
    master weights computing in bf16, kernels on, trained for 5 SGD steps at
    batch 8 through ``train.make_train_step``; its extractor stays frozen."""
    import numpy as np
    import torch

    from mintime_torch import train
    from mintime_torch.config import MintimeConfig, TrainingConfig
    from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = conv_model_config(tap)
    phase = f"{_conv_phase(tap)}_train"
    # the yaml's training section, but batch 8 (its bs is 1), as the flagship phase
    lr, wd = 0.01, 1e-4
    cfg = MintimeConfig(model=mcfg, training=TrainingConfig(
        lr=lr, weight_decay=wd, optimizer="SGD", scheduler="steplr", gamma=0.1, step_size=15,
        bs=8))
    batch = _conv_batch()
    pos_weight = train.pos_weight_from_labels(batch["labels"])
    t0 = time.perf_counter()
    model = train.conv_training_model(mcfg, device="cuda", seed=0)
    build_model_s = time.perf_counter() - t0
    assert model.dtype == torch.float32 and model.compute_dtype == torch.bfloat16
    head = [n for n, _ in model.named_parameters() if not n.startswith("extractor.")]
    ref = ConvolutionalTimeSformer(mcfg, device="cuda", dtype=torch.float32,
                                   param_dtype=torch.float32, seed=0)
    _grad_check(smi, f"{phase}_check", model, ref, batch, pos_weight, head)

    # the main path: 5 steps through make_train_step, counters read per step
    state = train.create_train_state(model, cfg, steps_per_epoch=5, num_epochs=1, seed=0)
    step = train.make_train_step(model, pos_weight)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    ext0 = {n: p.detach().clone() for n, p in model.named_parameters() if n not in head}
    losses, launches, step_s = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        metrics, counts = _step_launches(lambda: step(state, batch))
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        launches.append(counts)
    want = {**CONV_LAUNCHES[tap][0], **CONV_LAUNCHES[tap][1], **NO_OTHER_LAUNCHES}
    if any(c != want for c in launches):
        raise AssertionError(f"{phase} launches per train step {launches}, want {want}")
    with torch.no_grad():
        after = float(train.forward_loss(model, batch, pos_weight, train=True)[0])
    if not (np.isfinite(after) and after < losses[0]):
        raise AssertionError(f"{phase} loss after 5 steps {after} is not below the first {losses[0]}")
    moved = sorted(k for k, v in model.named_buffers() if not torch.equal(v, stats0[k]))
    if moved:
        raise AssertionError(f"frozen extractor's BatchNorm statistics moved: {moved[:8]}")
    # a zero gradient under coupled weight decay: p <- p * (1 - lr * wd), five times
    decay = max(float((p.detach() - ext0[n] * (1 - lr * wd) ** 5).abs().max()
                      / ext0[n].abs().max().clamp(min=1e-30))
                for n, p in model.named_parameters() if n in ext0)
    if not decay <= 1e-5:
        raise AssertionError(f"frozen extractor moved by more than weight decay: {decay}")

    device_ms = time_ms(lambda: step(state, batch), iters=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    steady = sorted(step_s[1:])
    emit({"phase": phase, "card": smi, "tap_block": tap, "batch": 8, "steps": 5,
          "launches_per_step": launches[0], "losses": losses, "loss_after": after,
          "pos_weight": pos_weight, "extractor_decay_only_rel_err": decay,
          "build_model_s": build_model_s, "first_step_s": step_s[0], "step_s": step_s,
          "steps_per_s": 1 / steady[len(steady) // 2],
          "videos_per_s_batch8": 8 / steady[len(steady) // 2],
          "device_ms_per_step": device_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "profile", "card": smi, "what": f"{phase} step", "batch": 8,
          **_profile(lambda: step(state, batch))})
    return launches[0]


def phase_grouped(smi):
    """``fused_grouped_attention``, the JAX package's v1 public function, at
    flagship width (B = 8, 8 heads of 64) on both axes, masked as in
    ``tests/test_pallas_attention.py:13-31`` and with no mask: four calls
    through the entry point, each against the plain grouped attention with a
    CLS column (the attention-map path) in fp32 on the same inputs."""
    import numpy as np
    import torch

    from mintime_torch.ops import grouped_attention as ga
    from mintime_torch.ops.attention import grouped_attention_with_cls

    gen = torch.Generator().manual_seed(3)
    cases = [((G, L), masked) for G, L in ((49, 16), (16, 49)) for masked in (True, False)]
    inputs = [_grouped_inputs(gen, G, L, masked) for (G, L), masked in cases]
    outs, counts = _step_launches(
        lambda: [ga.fused_grouped_attention(*args, heads=8) for args, _ in inputs])
    want = {k: 0 for k in counts} | {"grouped_attention": len(cases)}
    if counts != want:
        raise AssertionError(f"fused_grouped_attention launches {counts}, want {want}")
    errs = []
    for ((G, L), masked), (args, mask), out in zip(cases, inputs, outs):
        q = args[0]
        assert out.shape == q.shape and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
        ref = grouped_attention_with_cls(*(t.float() for t in args[:5]),
                                         None if mask is None else mask[:, None])
        errs.append({"G": G, "L": L, "masked": masked, "vs_fp32_reference": max_err(out, ref),
                     "vs_plain": max_err(out, ga.fused_grouped_attention_plain(*args, heads=8))})
    emit({"phase": "grouped", "card": smi, "launches": counts, "cases": errs})
    worst = max(max(e["vs_fp32_reference"], e["vs_plain"]) for e in errs)
    if not np.isfinite(worst) or worst > TOL:
        raise AssertionError(f"fused_grouped_attention off by {worst} > {TOL}: {errs}")
    return counts


def phase_probes(smi):
    """The three probes' ``run()`` at their full sizes (the attention
    variants at B = 32, the depthwise forward and weight gradient at 512
    images over their geometries), their tables printed one JSON line a row;
    the kernel variants B and G must agree with variant A within 2e-2. Then
    ``dw_conv_wgrad`` must give the same bits on two calls."""
    import torch

    from mintime_torch.experiments import attn_kernel_variants as attn_probe
    from mintime_torch.experiments import dw_conv_bwd_cuda_vs_cudnn as dwb_probe
    from mintime_torch.experiments import dw_conv_cuda_vs_cudnn as dwf_probe
    from mintime_torch.ops import dw_conv

    probes = {"attn_kernel_variants": attn_probe, "dw_conv_cuda_vs_cudnn": dwf_probe,
              "dw_conv_bwd_cuda_vs_cudnn": dwb_probe}
    t0 = time.perf_counter()
    tables, counts = _step_launches(lambda: {name: mod.run() for name, mod in probes.items()})
    seconds = time.perf_counter() - t0
    for name, table in tables.items():
        for row in table:
            emit({"phase": "probe", "probe": name, "card": smi, **row})
    off = {f"{r['axis']} {k}": r[k] for r in tables["attn_kernel_variants"] for k in r
           if k.startswith(("B_vs_A", "G_vs_A")) and not r[k] <= TOL}
    if off:
        raise AssertionError(f"attention variants differ from variant A by more than {TOL}: {off}")

    _, H_, C, K, _ = dwb_probe.GEOMS[0]
    x, dy, _ = dwb_probe.make_inputs(H_, C, K, 1)
    first = dw_conv.dw_conv_wgrad(x, dy, K=K)
    bitwise = all(torch.equal(dw_conv.dw_conv_wgrad(x, dy, K=K), first) for _ in range(2))
    del x, dy
    torch.cuda.empty_cache()
    counts = {k: counts[k] for k in PROBE_KERNELS}
    emit({"phase": "probes", "card": smi, "seconds": seconds, "launches": counts,
          "dw_conv_wgrad_bitwise_stable": bitwise})
    if not bitwise:
        raise AssertionError("dw_conv_wgrad gave other bits on a rerun")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    smi = phase_device()
    rows = phase_kernels(smi)
    launches, model, stacked = phase_slice(smi)
    phase_profile(smi, model, stacked)
    del model
    torch.cuda.empty_cache()
    detect, detect_members = phase_detect(smi)
    torch.cuda.empty_cache()
    # each main path's launches, read just after it: one flagship serving
    # forward, the detector and embedder over 8 videos (no hand-written
    # kernel), the whole predict pipeline for each backbone (one forward of
    # 8 videos each), a 48-video test split from disk through the evaluation
    # function (6 forwards at batch 8), one flagship train step, one conv
    # forward, one conv train step
    paths = {"flagship_forward": launches, "detect": detect,
             **phase_predict(smi, detect_members)}
    torch.cuda.empty_cache()
    paths["evaluate"] = phase_evaluate(smi)
    torch.cuda.empty_cache()
    paths["flagship_train_step"], step_ms = phase_train(smi)
    torch.cuda.empty_cache()
    # a train split on disk: the augmentations on the card, then the flagship
    # trained from it through the train-mode dataset and loader
    paths["flagship_train_step_from_disk"], paths["train_main"] = \
        phase_train_from_disk(smi, step_ms)
    torch.cuda.empty_cache()
    # SlowFast R-50 through evaluation, the train step and the CLI: no kernel
    paths["slowfast"] = phase_slowfast(smi)
    torch.cuda.empty_cache()
    # the tooling: the profiler CLI (a forward and a train step), feature
    # extraction, the weight check, extractor pretraining (no kernel), then
    # train_loop.main on a one-rank NCCL group and two ranks over gloo
    paths["profiling"] = phase_profiling(smi)
    torch.cuda.empty_cache()
    paths.update(phase_tooling(smi))
    torch.cuda.empty_cache()
    paths.update(phase_parallel(smi))
    torch.cuda.empty_cache()
    paths["conv_forward"] = phase_conv(smi)
    torch.cuda.empty_cache()
    paths["conv_train_step"] = phase_conv_train(smi)
    torch.cuda.empty_cache()
    # tap block 10: both axes of every layer through the whole-slice kernels
    # at 8 groups of 192 and 192 groups of 8
    paths["conv_tap10_forward"] = phase_conv(smi, tap=10)
    torch.cuda.empty_cache()
    paths["conv_tap10_train_step"] = phase_conv_train(smi, tap=10)
    torch.cuda.empty_cache()
    # the probes' paths: the JAX package's v1 grouped attention through its
    # public function, and the three probes' entry points
    paths["grouped_attention_calls"] = phase_grouped(smi)
    torch.cuda.empty_cache()
    paths["probes"] = phase_probes(smi)

    sources = {
        "geglu_ffn": ("mintime_torch/csrc/geglu_ffn.cu", "mintime_tpu/ops/pallas_ffn.py:57"),
        "divided_attention": ("mintime_torch/csrc/divided_attention.cu",
                              "mintime_tpu/ops/pallas_attention.py:140"),
        "token_rows_attention": ("mintime_torch/csrc/token_rows_attention.cu",
                                 "mintime_tpu/ops/pallas_attention.py:530"),
        "geglu_ffn_bwd": ("mintime_torch/csrc/geglu_ffn_bwd.cu", "mintime_tpu/ops/pallas_ffn.py:77"),
        "divided_attention_bwd": ("mintime_torch/csrc/divided_attention_bwd.cu",
                                  "mintime_tpu/ops/pallas_attention.py:289"),
        "token_rows_attention_bwd": ("mintime_torch/csrc/token_rows_attention_bwd.cu",
                                     "mintime_tpu/ops/pallas_attention.py:571"),
        "grouped_attention": ("mintime_torch/csrc/grouped_attention.cu",
                              "mintime_tpu/ops/pallas_attention.py:35"),
        "chunked_attention": ("mintime_torch/csrc/chunked_attention.cu",
                              "experiments/attn_kernel_variants.py:173"),
        "dw_conv": ("mintime_torch/csrc/dw_conv.cu", "experiments/dw_conv_pallas_vs_xla.py:24"),
        "conv3x3": ("mintime_torch/csrc/dw_conv.cu",
                    "none: the JAX package leaves Xception's depthwise 3 x 3 to XLA"),
        "dw_conv_wgrad": ("mintime_torch/csrc/dw_conv_wgrad.cu",
                          "experiments/dw_conv_bwd_pallas_vs_xla.py:128, :188, :231"),
    }
    kernels = []
    for name, shapes in rows.items():
        calls = sum(s["calls"] for s in shapes)
        per_call = lambda key: sum(s[key] * s["calls"] for s in shapes) / calls  # noqa: E731
        by_path = {p: c[name] for p, c in paths.items() if c.get(name)}
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            # per launch, averaged over the shapes the main paths launch it at
            "ms": per_call("ms"), "plain_ms": per_call("plain_ms"),
            "bound_ms": per_call("bound_ms"),
            "bound_by": max(shapes, key=lambda s: s["calls"] * s["bound_ms"])["bound_by"],
            "library_ms": (per_call("library_ms")
                           if all(s["library_ms"] is not None for s in shapes) else None),
            "card": smi, "shapes": shapes,
        })
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
