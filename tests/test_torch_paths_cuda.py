"""The port's main paths on the card at the sizes they serve and train at:
the flagship forward and its serving pipeline from decoded DFDC-size frames
(MINTIME-EF and MINTIME-XC, sequential and pipelined), face detection and
clustering, evaluation of a 48-video split from disk, the flagship's train
step (in memory, from disk, through the training CLI), the augmentations,
SlowFast, the tooling (profiler, feature extraction, weight check,
extractor pretraining), data and tensor parallelism, the Convolutional
TimeSformer tapped at blocks 20 and 10, the v1 grouped attention and the
probes. Each path is held to its plain path, to the CPU in fp32 or to its
own invariants, and ``test_path_launches`` holds every path to its line of
``LAUNCHES``: the hand-written kernels it launches, counted by the wrappers'
launch counters, and no others.

Each path runs for up to minutes on the card, so the tests are marked
``slow`` as well as ``cuda``: tier-1 (``-m 'not slow'``) leaves them out,
and without a card they skip. On a machine with a card run
``python -m pytest tests/test_torch_paths_cuda.py -m cuda``. The file and
its inputs (``card_inputs.py``) import no JAX, cv2, yaml, PIL, pandas or
matplotlib: the card's machine has none of them.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import math
import multiprocessing as mp
import os
import re
import socket
import time
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

import card_inputs as ci

pytestmark = [pytest.mark.cuda, pytest.mark.slow]

TOL = 2e-2  # kernels against the plain path on the card, in bf16

#: the wrappers' launch counters, each a kernel's calls
COUNTERS = ("divided_attention", "geglu_ffn", "token_rows_attention", "divided_attention_bwd",
            "geglu_ffn_bwd", "token_rows_attention_bwd", "grouped_attention",
            "chunked_attention", "dw_conv", "dw_conv_wgrad", "conv3x3")
#: a count that the probes' timing loops set: one launch or more
SOME = None
ZERO = dict.fromkeys(COUNTERS, 0)
#: one flagship forward: 9 layers x 2 attentions (whole-slice) and 2 FFNs
#: (tokens, CLS); with attention maps the last layer's two attentions stay plain
FORWARD = {**ZERO, "divided_attention": 18, "geglu_ffn": 18}
SERVE = {**FORWARD, "divided_attention": 16}
#: one flagship train step: the backward as the forward, but for the last
#: layer's token FFN, whose output reaches no logit
STEP = {**FORWARD, "divided_attention_bwd": 18, "geglu_ffn_bwd": 17}
#: Xception's 34 depthwise 3 x 3 layers on their kernel, in inference
XC = {"conv3x3": 34}
#: the conv model at tap block 20: 4 layers x (one token-row time axis, two
#: FFNs), the space axis (L = 1280) plain; at block 10 both axes take the
#: whole-slice kernels (8 groups of 192 and 192 groups of 8)
CONV = {**ZERO, "geglu_ffn": 8, "token_rows_attention": 4}
CONV_TAP10 = {**ZERO, "divided_attention": 8, "geglu_ffn": 8}

#: path -> the launches of each unit of it that the path's run records (a
#: forward, a train step, a run): every kernel with the count given, and no
#: kernel at 0
LAUNCHES = {
    "flagship_forward": SERVE,  # 8 videos with attention maps
    "detect": ZERO,  # 8 videos of 150 DFDC frames
    "predict_ef": SERVE, "predict_ef_pipelined": SERVE, "predict_ef_plain": ZERO,
    "predict_xc": {**SERVE, **XC}, "predict_xc_pipelined": {**SERVE, **XC},
    "predict_xc_plain": ZERO,
    "evaluate": FORWARD,  # a forward, at batch 8 and at the yaml's 1
    "flagship_train_step": STEP, "flagship_train_step_from_disk": STEP,
    "train_main_step": STEP, "train_main_validation": {**FORWARD, **XC},
    "train_main_nccl": {**ZERO, "divided_attention": 36, "geglu_ffn": 36,
                        "divided_attention_bwd": 18, "geglu_ffn_bwd": 17},  # a step, a validation
    "slowfast": ZERO,  # evaluation, a train step, the CLI
    "profiling_forward": FORWARD, "profiling_train": STEP,  # a traced call
    "verify_weights": SERVE, "pretrain": ZERO,
    "parallel_dp2": STEP, "parallel_tp2": STEP,  # each rank's step
    "conv_forward": CONV,
    "conv_train_step": {**CONV, "geglu_ffn_bwd": 7, "token_rows_attention_bwd": 4},
    "conv_tap10_forward": CONV_TAP10,
    "conv_tap10_train_step": {**CONV_TAP10, "divided_attention_bwd": 8, "geglu_ffn_bwd": 7},
    "grouped_attention_calls": {**ZERO, "grouped_attention": 4},
    "probes": {**ZERO, "divided_attention": SOME, "token_rows_attention": SOME,
               "chunked_attention": SOME, "dw_conv": SOME, "dw_conv_wgrad": SOME},
}


# ---------------------------------------------------------------------------
# Counting and the runs
# ---------------------------------------------------------------------------

def _launch_counts() -> dict:
    """The wrappers' launch counters as they stand."""
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
    """``fn()`` and the wrappers' launches during it, counted from 0."""
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


def _per(counts: dict, n: int) -> dict:
    """Launches of one of ``n`` like units."""
    return {k: v / n for k, v in counts.items()}


class _Runs:
    """Each path's run, made once a module on first use; a run that raised
    raises again for every test that reads it."""

    def __init__(self, tmp_path_factory):
        self._tmp = tmp_path_factory
        self._done = {}

    def get(self, name: str):
        if name not in self._done:
            try:
                self._done[name] = RUNS[name](self)
            except Exception as e:
                self._done[name] = e
                raise
            finally:
                torch.cuda.empty_cache()
        out = self._done[name]
        if isinstance(out, Exception):
            raise out
        return out

    def dir(self, name: str) -> str:
        return str(self._tmp.mktemp(name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paths run the CUDA kernels")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield _Runs(tmp_path_factory)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _set_use_kernels(model, flag: bool) -> None:
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = flag


# ---------------------------------------------------------------------------
# Serving: the flagship forward, detection, the predict pipeline
# ---------------------------------------------------------------------------

def _run_slice(runs) -> dict:
    """The flagship (EfficientNet-B0 + Size-Invariant TimeSformer) at full
    width, seeded weights, through ``crops_from_frames → cluster_crops →
    assemble_inputs → predict_assembled`` for 8 in-memory videos at batch 8."""
    from mintime_torch import predict
    from mintime_torch.models.classifier import MintimeVideoClassifier

    cfg = ci.flagship_config()
    model = MintimeVideoClassifier(cfg.model, backbone="efficientnet-b0", head="timesformer",
                                   require_attention=True, use_kernels=True, device="cuda",
                                   seed=0)
    staged = []
    for full, boxes, fps, dims in ci.synthetic_videos(8, seed=1):
        crops = predict.crops_from_frames(full, boxes, fps)
        assert crops and all(c[2].shape == (224, 224, 3) for c in crops), "crops must be 224 px"
        identities, _ = predict.cluster_crops(crops, ci.stand_in_embedder)
        staged.append(predict.assemble_inputs(identities, dims, cfg))
    n_ids = [len(s[1].identity_keys) for s in staged]
    assert n_ids[0] == 1 and all(k == 2 for k in n_ids[1:]), n_ids
    assert any(int((~s[0]["mask"]).sum()) for s in staged), "the run should hold padded frames"

    results, counts = _step_launches(lambda: predict.predict_assembled(staged, model, None, cfg))
    assert len(results) == 8
    for res, k in zip(results, n_ids):
        assert 0.0 <= res.probability <= 1.0 and np.isfinite(res.probability)
        assert len(res.identity_attentions) == k
        for a in res.aggregated_attentions:
            assert a.shape == (16,) and abs(float(a.sum()) - 1.0) < 1e-6

    stacked = predict.stack_inputs(staged)
    logits_k, maps_k = predict.forward_batch(model, None, stacked)
    _set_use_kernels(model, False)
    logits_p, _ = predict.forward_batch(model, None, stacked)
    _set_use_kernels(model, True)
    for m in maps_k:
        assert m.shape == (8 * 8, 1, 1 + 16 * 49) and np.isfinite(m).all()
        np.testing.assert_allclose(m.sum(-1), 1.0, atol=1e-5)
    assert logits_k.shape == (8,) and np.isfinite(logits_k).all()
    assert float(np.abs(logits_k - logits_p).max()) <= TOL

    # the same weights in fp32 on the CPU (plain path) on video 1
    cpu = MintimeVideoClassifier(cfg.model, require_attention=True, device="cpu", seed=0)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    logits_cpu, _ = predict.forward_batch(cpu, None, {k: v[1:2] for k, v in stacked.items()})
    assert abs(float(logits_cpu[0]) - float(logits_k[1])) <= 5e-2
    return {"launches": {"flagship_forward": [counts]}}


def _members(identities) -> dict:
    """Each identity's key and its crops' (frame, face) indices."""
    return {str(k): sorted((i, j) for i, j, *_ in items) for k, items in identities.items()}


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


#: videos of the check that copies every stage-1 tail under the lookahead
TAIL_VIDEOS = 3


def _run_detect(runs) -> dict:
    """8 videos of 150 frames at 1920 x 1080 through
    ``MTCNNDetector.detect_videos`` (one video of lookahead), a crop a second,
    ``predict.cluster_crops`` with the FaceEmbedder's InceptionResnetV1 at
    128 px; the card's boxes and embeddings against the CPU's."""
    from mintime_torch import native, predict
    from mintime_torch.preprocessing import mtcnn
    from mintime_torch.preprocessing.cluster_faces import FaceEmbedder, connected_components

    sds = ci.detect_weights()
    kw = dict(thresholds=ci.DETECT_THRESHOLDS, input_scale=2, channel_order="bgr")
    det = mtcnn.MTCNNDetector(sds, device_crops=True, device="cuda", **kw)
    emb_sd = FaceEmbedder.init_state_dict(ci.DETECT_SEED)
    emb = FaceEmbedder(emb_sd, device="cuda")
    devices = {p.device.type for n in det.nets.values() for p in n.parameters()}
    devices |= {p.device.type for p in emb.net.parameters()}
    assert devices == {"cuda"}, devices

    kept, two = {}, []

    def videos():  # one video at a time, so the host holds at most two
        for v in range(ci.DETECT_VIDEOS):
            frames = ci.detect_video(v)
            kept[v] = {i: frames[i] for i in range(0, ci.DETECT_FRAMES, ci.DETECT_FPS)}
            if v == 0:
                two.extend([frames[0], frames[ci.DETECT_FRAMES // 2]])
            yield frames

    def main_path():
        out = []
        for v, boxes_v in enumerate(det.detect_videos(videos())):
            boxes = {str(i): b[:, :4].tolist() if len(b) else None for i, b in enumerate(boxes_v)}
            crops = predict.crops_from_frames(kept[v], boxes, ci.DETECT_FPS)
            identities, _ = predict.cluster_crops(crops, emb)
            out.append((boxes_v, crops, identities))
        return out

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        results, counts = _step_launches(main_path)
    truncation = [str(w.message) for w in caught if "P-Net" in str(w.message)]
    assert not truncation, f"P-Net truncation warnings: {truncation}"
    assert sum(len(b) for r in results for b in r[0]), "the detector found no face"

    lib = native._lib
    assert lib is not None and lib._name == str(native.library_path()), \
        "the native NMS library is not the one loaded"

    def box_err(a, b):
        if [len(x) for x in a] != [len(x) for x in b]:
            return None
        return max([float(np.abs(x - y).max()) for x, y in zip(a, b) if len(x)], default=0.0)

    card = det.detect_batch(two)
    cpu = mtcnn.MTCNNDetector(sds, device_crops=True, device="cpu", **kw).detect_batch(two)
    host_crops = mtcnn.MTCNNDetector(sds, device_crops=False, device="cuda", **kw).detect_batch(two)
    for other in (cpu, host_crops):  # None: other box counts
        err = box_err(card, other)
        assert err is not None and err <= TOL, err
    # the stage-1 tail's copy under the lookahead: with a head of 0 cells
    # every video copies its tail, after the next video's stage 1 is
    # enqueued; its boxes against those the main path's head gave
    tail = collections.Counter()
    restore = _count_tail_copies(mtcnn, tail)
    try:
        no_head = mtcnn.MTCNNDetector(sds, device_crops=True, device="cuda", pnet_head_k=0, **kw)
        tail_runs = no_head.detect_videos(ci.detect_video(v) for v in range(TAIL_VIDEOS))
    finally:
        restore()
    assert tail["tail_copies"] == TAIL_VIDEOS, tail
    tail_errs = [box_err(t, r[0]) for t, r in zip(tail_runs, results)]
    assert all(e is not None and e <= TOL for e in tail_errs), tail_errs
    crops = [c[2] for c in results[0][1]]
    e_card, e_cpu = emb(crops), FaceEmbedder(emb_sd, device="cpu")(crops)
    assert float(np.abs(e_card - e_cpu).max()) <= 1e-4
    assert connected_components(e_card @ e_card.T) == connected_components(e_cpu @ e_cpu.T)
    return {"launches": {"detect": [counts]}, "members": [_members(r[2]) for r in results]}


def _run_predict(runs) -> dict:
    """The predict CLI's loading code and the whole pipeline, for MINTIME-EF
    and MINTIME-XC at full width: reference-format weight files read back
    through ``predict.load_predict_models``; ``_run_detect``'s 8 videos from
    decoded frames through ``predict.stage_decoded`` and
    ``predict.predict_assembled`` at batch 8, then through the served path's
    pipelining (``stage_decoded_pipelined``, ``predict_staged``)."""
    from mintime_torch import predict
    from mintime_torch.data import augment
    from mintime_torch.models.classifier import MintimeVideoClassifier

    detect_members = runs.get("detect")["members"]
    videos = []
    for v in range(ci.DETECT_VIDEOS):
        frames = ci.detect_video(v)
        videos.append((frames, {i: frames[i] for i in range(0, ci.DETECT_FRAMES, ci.DETECT_FPS)}))
    options = dict(thresholds=ci.DETECT_THRESHOLDS, input_scale=2, device_crops=True)
    files = ci.write_weight_files(runs.dir("predict_weights"))
    launches = {}
    for path, model_id, backbone, channels in ci.PREDICT_MODELS:
        cfg = ci.flagship_config(channels)
        model, det, emb = predict.load_predict_models(
            cfg, files[path][0], files["mtcnn"], files["facenet"],
            extractor_weights=files[path][1], extractor_model=model_id, device="cuda",
            detector_options=options)

        def pipeline():
            staged = [predict.stage_decoded(half, full, ci.DETECT_FPS, det, emb, cfg,
                                            device="cuda") for half, full in videos]
            return staged, predict.predict_assembled(staged, model, None, cfg)

        (staged, results), launches[path] = _step_launches(pipeline)
        members = [_members(s[2]) for s in staged]
        assert members == detect_members, (path, members, detect_members)
        stacked = predict.stack_inputs(staged)
        logits_k, maps_k = predict.forward_batch(model, None, stacked)
        _set_use_kernels(model, False)
        (logits_p, _), launches[f"{path}_plain"] = _step_launches(
            lambda: predict.forward_batch(model, None, stacked))
        _set_use_kernels(model, True)
        assert float(np.abs(logits_k - logits_p).max()) <= TOL, path
        assert (np.isfinite(logits_k).all() and all(np.isfinite(m).all() for m in maps_k)
                and all(np.isfinite(a).all() for r in results for a in r.aggregated_attentions))
        cpu = MintimeVideoClassifier(cfg.model, backbone=backbone, require_attention=True,
                                     device="cpu")
        cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        logits_cpu, _ = predict.forward_batch(cpu, None, {k: v[:1] for k, v in stacked.items()})
        assert abs(float(logits_cpu[0]) - float(logits_k[0])) <= 5e-2, path
        del cpu
        # the card's evaluation transform against the CPU's: every crop of the
        # run (all under 224 px: the cubic path) and crops of a frame at the
        # sides of larger faces (the INTER_AREA path)
        crops = [c for s in staged for items in s[2].values() for _, _, c, _ in items]
        frame = videos[0][1][0]
        crops += [frame[:h, :w] for h, w in ((225, 225), (300, 448), (448, 448), (700, 365),
                                             (1080, 1080))]
        vt = augment.create_val_transform(224)
        levels = (vt(crops, "cuda").cpu().to(torch.int16) - vt(crops, "cpu").to(torch.int16)).abs()
        assert int(levels.max()) <= 1 and float((levels > 0).float().mean()) <= 1e-3, path
        del staged, stacked
        torch.cuda.empty_cache()

        # the served path's pipelining: video i+1's stage 1 enqueued before
        # video i's host stages, then predict_videos' batch logic
        decoded = ((frames, full, ci.DETECT_FPS) for frames, full in videos)
        piped, launches[f"{path}_pipelined"] = _step_launches(lambda: predict.predict_staged(
            predict.stage_decoded_pipelined(decoded, det, emb, cfg, device="cuda"), len(videos),
            model, None, cfg, batch_size=8))
        assert max(abs(r.probability - s.probability) for r, s in zip(piped, results)) <= 1e-6
        assert [_members(r.identities) for r in piped] == [_members(s.identities) for s in results]
        del model, det, emb, results, piped
        torch.cuda.empty_cache()
    return {"launches": {k: [v] for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# Evaluation of a split from disk
# ---------------------------------------------------------------------------

#: standard deviation of the logits of the fitted output layer over the split
EVAL_LOGIT_STD = 0.15


@contextlib.contextmanager
def _captured_forwards(logits: dict):
    """Record each video's logit from ``evaluate``'s forwards into ``logits``."""
    from mintime_torch import evaluate

    forward = evaluate._forward

    def recorded(model, state, batch):
        out = forward(model, state, batch)
        logits.update(zip(batch["video_id"], out[0].tolist()))
        return out

    evaluate._forward = recorded
    try:
        yield
    finally:
        evaluate._forward = forward


def _fit_output_layer(cfg, head: str, ext: str, man, faces: str) -> None:
    """Refit the head file's output layer (``to_out.1``) to the split, so
    that its logits read the videos' crops: a random head maps every video to
    nearly one logit. A plain fp32 run on the card gives each video's
    normalised CLS embedding. The layer projects onto their covariance with
    the video's mean crop level (the band its block noise was drawn from),
    made orthogonal to the difference between the mean embeddings of one
    identity and of more, which would otherwise part the logits by identity
    count. It is scaled to logits of standard deviation ``EVAL_LOGIT_STD``
    around their median."""
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


def _finite_report(report: dict) -> bool:
    return (all(math.isfinite(report[k]) for k in ("loss", "accuracy", "f1", "auc"))
            and all(math.isfinite(x) for x in report["per_method_errors"].values()))


def _run_evaluate(runs) -> dict:
    """The evaluation CLI's function (``evaluate.evaluate_split``) on the
    48-video split: MINTIME-EF from reference-format weight files at full
    width (its output layer fitted to the split), 4 spawned workers, batch 8
    and the yaml's test batch of 1."""
    from mintime_torch import evaluate
    from mintime_torch.data.manifest import load_manifest

    _, model_id, backbone, channels = ci.PREDICT_MODELS[0]
    cfg = ci.flagship_config(channels)
    d = runs.dir("evaluate")
    faces, split, _ = ci.write_split(d)
    head, ext = ci.write_model_files(d, model_id, backbone, channels)
    man = load_manifest(split, faces)
    _fit_output_layer(cfg, head, ext, man, faces)
    run = dict(extractor_weights=ext, workers=4, device="cuda")
    kernel, plain_logits = {}, {}
    with _captured_forwards(kernel):
        report, counts = _step_launches(
            lambda: evaluate.evaluate_split(cfg, head, split, faces, batch_size=8, **run))
    per_forward = [_per(counts, -(-ci.SPLIT_VIDEOS // 8))]
    with _captured_forwards(plain_logits):
        plain = evaluate.evaluate_split(cfg, head, split, faces, batch_size=8,
                                        fused_attention=0, **run)
    multi = evaluate.evaluate_split(cfg, head, split, faces, batch_size=8,
                                    only_multiidentity=True, **run)
    # the model and the loader built as evaluate_split builds them, at batch
    # 8 and at the yaml's test batch
    model = evaluate.build_model(cfg, head, ext, device="cuda")
    passes = []
    for batch in (8, cfg.test.bs):
        with evaluate.split_loader(cfg, man.videos, man.labels, man.multiclass, faces,
                                   batch, 4, None, 0, 42, "cuda") as loader:
            again, counts = _step_launches(lambda: evaluate.evaluate(model, None, loader))
        per_forward.append(_per(counts, -(-ci.SPLIT_VIDEOS // batch)))
        passes.append(again)
    del model
    torch.cuda.empty_cache()
    # the same files in fp32 on the CPU, the split's first two videos
    cpu_logits = {}
    cpu = evaluate.build_model(cfg, head, ext, device="cpu", dtype=torch.float32)
    with _captured_forwards(cpu_logits), evaluate.split_loader(
            cfg, man.videos[:2], man.labels[:2], man.multiclass[:2], faces, 2, workers=1,
            device="cpu") as loader:
        evaluate.evaluate(cpu, None, loader)
    del cpu

    ids = sorted(kernel)
    k_arr = np.array([kernel[i] for i in ids])
    p_arr = np.array([plain_logits[i] for i in ids])
    assert float(np.abs(k_arr - p_arr).max()) <= min(TOL, float(p_arr.std()) / 4)
    decided = np.abs(p_arr) > TOL  # the sign of every video clear of 0, both sides well filled
    assert ((k_arr > 0) == (p_arr > 0))[decided].all()
    assert min((p_arr[decided] < 0).sum(), (p_arr[decided] > 0).sum()) >= ci.SPLIT_VIDEOS // 4
    assert len(cpu_logits) == 2
    assert max(abs(kernel[i] - v) for i, v in cpu_logits.items()) <= 5e-2
    assert report["n_videos"] == plain["n_videos"] == ci.SPLIT_VIDEOS
    assert multi["n_videos"] == sum(n > 1 for n in ci.SPLIT_IDENTITIES)
    if not (np.abs(k_arr) <= TOL).any():  # no logit within 2e-2 of 0
        assert report["accuracy"] == plain["accuracy"]
    assert all(_finite_report(r) for r in (report, plain, multi, *passes))
    assert all(p["n_videos"] == report["n_videos"] and abs(p["loss"] - report["loss"]) <= TOL
               for p in passes)
    return {"launches": {"evaluate": per_forward}}


# ---------------------------------------------------------------------------
# Training: one step's gradients, the train step, the data and the CLI
# ---------------------------------------------------------------------------

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
    from mintime_torch import train
    from mintime_torch.models.efficientnet import BatchRows
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.ops import token_rows as tr
    from mintime_torch.parallel.mesh import axis_size

    stats = {k: v.clone() for k, v in model.named_buffers()}
    _set_use_kernels(model, use_kernels)
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
                    stack.enter_context(
                        mock.patch.object(mod, f"{n}_cuda", getattr(mod, f"{n}_plain")))
        loss, logits = train.forward_loss(model, batch, pos_weight, train=True,
                                          generator=generator, mesh=mesh, net=net)
        loss.backward()
    grads = {n: None if p.grad is None else p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(stats[k])
    _set_use_kernels(model, True)
    model.zero_grad(set_to_none=True)
    if with_logits:
        return float(loss.detach()), grads, logits.detach().float()
    return float(loss.detach()), grads


def _grad_check(model, ref, batch, pos_weight, trained, mesh=None, check_logits=False) -> None:
    """One step's gradients with kernels against the plain path on the same
    weights, batch and masks. ``trained`` names the parameters that must get
    a finite, non-zero gradient; every other parameter must get none. ``ref``
    is a plain fp32 copy of the model, loaded here and freed after. With a
    data-parallel ``mesh`` every run is the mesh's (``batch`` this rank's
    rows). ``check_logits`` holds the step's logits to the gradients' rule
    too.

    Two readings sit beside the kernel-vs-plain gap. An fp32 run of the same
    step (same weights, plain path) tells which tensors have a zero gradient
    in exact arithmetic: the biases of the _bn2 layers whose output a
    train-mode BatchNorm re-centres. There the bf16 paths hold nothing but
    round-off, at least 2^8 times the fp32 value. A kernel-free twin (the
    kernel path with its plain versions on the card) shows how far two
    correct bf16 runs that round at different places already drift apart at
    random init: a few percent of a tensor's largest gradient, up to about
    1e-1 on some tensors. Each tensor's kernel-vs-plain gap must stay within
    5e-2 of its largest plain gradient beyond the twin's gap."""
    from mintime_torch.parallel.mesh import axis_size, data_parallel

    dp = axis_size(mesh) > 1
    kw = dict(mesh=mesh, net=data_parallel(model, mesh) if dp else None, with_logits=True)
    loss_k, gk, lk = _one_step_grads(model, batch, pos_weight, True, **kw)
    loss_p, gp, lp = _one_step_grads(model, batch, pos_weight, False, **kw)
    bad = [n for n in trained if gk[n] is None or not torch.isfinite(gk[n]).all()
           or not gk[n].abs().max() > 0]
    assert not bad, f"parameters without a finite non-zero gradient: {bad[:8]}"
    frozen = [n for n, g in gk.items() if n not in trained and g is not None and g.any()]
    assert not frozen, f"frozen parameters with a gradient: {frozen[:8]}"
    _, gt, lt = _one_step_grads(model, batch, pos_weight, True, kernel_free=True, **kw)
    ref.load_state_dict(model.state_dict())
    _, g32 = _one_step_grads(ref, batch, pos_weight, False, mesh=mesh,
                             net=data_parallel(ref, mesh) if dp else None)
    del ref
    torch.cuda.empty_cache()
    rows = {}
    for n in trained:
        top = float(gp[n].abs().max())
        rows[n] = {"gap": float((gk[n] - gp[n]).abs().max()) / top,
                   "twin_gap": float((gt[n] - gp[n]).abs().max()) / top,
                   "fp32_over_plain": float(g32[n].abs().max()) / top}
    zero = {n for n, r in rows.items() if r["fp32_over_plain"] <= 2**-8}
    failed = [n for n, r in rows.items()
              if n not in zero and r["gap"] > 5e-2 and not r["gap"] <= 5e-2 + r["twin_gap"]]
    assert abs(loss_k - loss_p) <= TOL, f"kernel vs plain loss {loss_k} vs {loss_p}"
    assert not failed, f"kernel vs plain gradients off: {[(n, rows[n]) for n in failed[:4]]}"
    if check_logits:
        top = float(lp.abs().max())
        gap, twin = float((lk - lp).abs().max()) / top, float((lt - lp).abs().max()) / top
        assert gap <= 5e-2 + twin, f"kernel vs plain logits off: {gap} (twin {twin})"


def _run_train(runs) -> dict:
    """The flagship at full width with fp32 masters computing in bf16, kernels
    on: one step's gradients against the plain path, then 5 SGD steps (lr
    0.01, weight decay 1e-4, cosine) at batch 8 through
    ``train.make_train_step``."""
    from mintime_torch import train
    from mintime_torch.models.classifier import MintimeVideoClassifier

    cfg, batch, pos_weight = ci.flagship_train_batch()
    model = train.training_model(cfg.model, device="cuda", seed=0)
    assert model.dtype == torch.float32 and model.compute_dtype == torch.bfloat16
    ref = MintimeVideoClassifier(cfg.model, use_kernels=False, device="cuda",
                                 dtype=torch.float32, param_dtype=torch.float32, seed=0)
    _grad_check(model, ref, batch, pos_weight, [n for n, _ in model.named_parameters()])

    state = train.create_train_state(model, cfg, steps_per_epoch=5, num_epochs=1, seed=0)
    step = train.make_train_step(model, pos_weight)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    losses, launches = [], []
    for _ in range(5):
        metrics, counts = _step_launches(lambda: step(state, batch))
        losses.append(float(metrics["loss"]))
        launches.append(counts)
    with torch.no_grad():  # the loss of step 0's forward (same drop-connect masks), now
        after, _ = train.forward_loss(model, batch, pos_weight, train=True,
                                      generator=train.step_generator(0, 0))
    after = float(after)
    assert np.isfinite(after) and after < losses[0], (after, losses)
    unmoved = sorted(k for k, v in model.named_buffers() if torch.equal(v, stats0[k]))
    assert not unmoved, f"BatchNorm statistics unmoved: {unmoved[:8]}"
    return {"launches": {"flagship_train_step": launches}}


#: the train split's videos the augmentations run on, and the seed of their draws
AUG_VIDEOS, AUG_SEED = 8, 16
#: the transforms held bitwise between the card and the CPU (the rest within one level)
AUG_BITWISE = ("HorizontalFlip", "InvertImg", "CoarseDropout", "RandomBrightnessContrast",
               "RandomGamma", "RGBShift", "GaussNoise", "MultiplicativeNoise", "MedianBlur")
#: the train-mode loader's batch, epochs and spawned workers
DISK_BATCH, DISK_EPOCHS, DISK_WORKERS = 8, 2, 4


def _train_dataset(cfg, man, faces, augmentation, device="cuda"):
    from mintime_torch.data.dataset import DeepfakesDataset

    m = cfg.model
    return DeepfakesDataset(man.videos, man.labels, data_path=faces, image_size=m.image_size,
                            num_frames=m.num_frames, num_patches=m.num_patches,
                            max_identities=m.max_identities, mode="train",
                            augmentation=augmentation, device=device)


def _run_train_split(runs) -> dict:
    """A train split of the 48 videos of packs, shared by the augmentations,
    ``train_disk`` and ``train_main``."""
    from mintime_torch.data.manifest import load_manifest

    d = runs.dir("train_split")
    faces, split, _ = ci.write_split(d)
    return {"dir": d, "faces": faces, "split": split, "man": load_manifest(split, faces)}


def _run_augment(runs) -> dict:
    """``AUG_VIDEOS`` videos of the train split (16 slots, dummy slots
    included) through the resize chain of their natural ``max`` draws, then
    each transform forced once a video (a one-member ``OneOf(p=1.0)``), held
    against the port on the CPU on the same stack and draws."""
    from mintime_torch.data import augment, augment_plan

    s = runs.get("train_split")
    cfg = ci.flagship_train_config()
    size = cfg.model.image_size
    ds = _train_dataset(cfg, s["man"], s["faces"], "max")
    raws = [ds.load(i) for i in range(AUG_VIDEOS)]
    stacks = [augment.resize_chain(r["crops"], r["steps"], "cuda")[0] for r in raws]
    chain_differ = sum(int((st.cpu() != augment.resize_chain(r["crops"], r["steps"], "cpu")[0])
                           .sum()) for st, r in zip(stacks, raws))
    assert not chain_differ, f"the resize chain differs card vs CPU on {chain_differ} values"
    bad = {}
    for k, name in enumerate(sorted(augment.STACK_STEPS)):
        one = augment_plan.OneOf([getattr(augment_plan, name)()], p=1.0)
        worst = 0
        for v, stack in enumerate(stacks):
            drawn = []
            one.draw(drawn, (size, size, 3), np.random.default_rng((AUG_SEED, k, v)))
            card = augment.apply_step(stack, drawn[0]).cpu()
            cpu = augment.apply_step(stack.cpu(), drawn[0])
            worst = max(worst, int((card.to(torch.int16) - cpu.to(torch.int16)).abs().max()))
        if worst > (0 if name in AUG_BITWISE else 1):
            bad[name] = worst
    assert not bad, f"card vs CPU beyond the bound (levels): {bad}"
    return {"launches": {}}


def _run_train_disk(runs) -> dict:
    """The flagship trained from the train split on disk:
    ``DeepfakesDataset(mode="train", augmentation="max")`` through the port's
    ``DataLoader`` (batch 8, shuffled, 4 spawned workers), 2 epochs through
    ``train.make_train_step``."""
    from mintime_torch import train
    from mintime_torch.data import loader as loader_mod

    s = runs.get("train_split")
    cfg, man = ci.flagship_train_config(), s["man"]
    ds = _train_dataset(cfg, man, s["faces"], "max")
    n = len(ds)
    steps_per_epoch = -(-n // DISK_BATCH)
    pos_weight = train.pos_weight_from_labels(np.asarray(man.labels, np.float32))
    model = train.training_model(cfg.model, device="cuda", seed=0)
    state = train.create_train_state(model, cfg, steps_per_epoch=steps_per_epoch,
                                     num_epochs=DISK_EPOCHS, seed=0)
    step = train.make_train_step(model, pos_weight)
    frames, launches, losses, last = [], [], [], None
    with loader_mod.DataLoader(ds, DISK_BATCH, shuffle=True, num_workers=DISK_WORKERS, seed=0,
                               worker_mode="process") as loader:
        for _ in range(DISK_EPOCHS):
            order = loader._batches()
            seen = {}
            for b, batch in enumerate(loader):
                for i, v in enumerate(order[b]):
                    seen[v] = batch["frames"][i].cpu()
                metrics, counts = _step_launches(lambda: step(state, batch))
                launches.append(counts)
                losses.append(float(metrics["loss"]))
                last = batch
            frames.append(seen)
    assert np.isfinite(losses).all() and len(losses) == DISK_EPOCHS * steps_per_epoch, losses
    loss_k, _ = _one_step_grads(model, last, pos_weight, True)
    loss_p, _ = _one_step_grads(model, last, pos_weight, False)
    assert abs(loss_k - loss_p) <= TOL, (loss_k, loss_p)
    # the JAX package's (seed, index) draw ignores the epoch
    same = [v for v in frames[0] if torch.equal(frames[0][v], frames[1][v])]
    assert len(same) == n and len(frames[1]) == n, f"{n - len(same)} videos' frames differ"
    return {"launches": {"flagship_train_step_from_disk": launches}}


#: ``train_main``: epochs of the first run (``--num_epochs 1``), spawned workers
MAIN_EPOCHS, MAIN_WORKERS = 2, 4


def _main_argv(d, split, val, *extra):
    return ["--train_list_file", split, "--validation_list_file", val,
            "--data_path", os.path.join(d, "faces"), "--workers", str(MAIN_WORKERS),
            "--models_output_path", os.path.join(d, "models"),
            "--logger_name", os.path.join(d, "runs"), "--device", "cuda", *extra]


@contextlib.contextmanager
def _watch_main():
    """Hooks on what ``train_loop.main`` (and ``pretrain_extractor.main``)
    runs, read into the yielded dict: each train and validation step's
    launches (the counters' growth over the step) and loss, the step count
    the first train step starts from, and the scalars logged by step."""
    from mintime_torch import train, train_loop

    rec = {"train": [], "val": [], "start_steps": [], "scalars": collections.defaultdict(dict)}
    saved = [(train, "make_train_step", train.make_train_step),
             (train, "make_eval_step", train.make_eval_step),
             (train_loop.ScalarLogger, "add_scalar", train_loop.ScalarLogger.add_scalar)]

    def counted(fn, into):
        def run(*a):
            torch.cuda.synchronize()
            before = _launch_counts()
            out = fn(*a)
            torch.cuda.synchronize()
            after = _launch_counts()
            rec[into].append({"launches": {k: after[k] - before[k] for k in after},
                              "loss": float(out["loss"])})
            return out
        return run

    def make_train_step(model, pos_weight=1.0, **kw):
        step = counted(saved[0][2](model, pos_weight, **kw), "train")

        def train_step(state, batch):
            if not rec["train"]:
                rec["start_steps"].append(state.step)
            return step(state, batch)
        return train_step

    def make_eval_step(model, pos_weight=1.0, **kw):
        return counted(saved[1][2](model, pos_weight, **kw), "val")

    def add_scalar(self, tag, value, step):
        rec["scalars"][step][tag] = float(value)
        return saved[2][2](self, tag, value, step)

    for (owner, name, _), fn in zip(saved, (make_train_step, make_eval_step, add_scalar)):
        setattr(owner, name, fn)
    try:
        yield rec
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _run_train_main(runs) -> dict:
    """The training CLI's function (``train_loop.main`` with an argv list and
    ``configs/size_invariant_timesformer.yaml``'s config, MINTIME-XC) on the
    train split: 48 train videos, every third the validation list, batch 8,
    4 spawned workers, 2 epochs, then an automatic resumption that runs one
    more epoch from the last checkpoint."""
    from mintime_torch import train_loop

    s = runs.get("train_split")
    d, split = s["dir"], s["split"]
    rows, val = ci.write_val_list(d, split)
    cfg = ci.train_main_config()
    argv = _main_argv(d, split, val, "--extractor_model", "1", "--patience", "5")
    launches = {"train_main_step": [], "train_main_validation": []}
    done = []
    for epochs in (MAIN_EPOCHS - 1, MAIN_EPOCHS):  # the first run, the resumed run
        with _watch_main() as rec:
            result = train_loop.main(argv + ["--num_epochs", str(epochs)], config=cfg)
        launches["train_main_step"] += [r["launches"] for r in rec["train"]]
        launches["train_main_validation"] += [r["launches"] for r in rec["val"]]
        losses = [r["loss"] for r in rec["train"] + rec["val"]]
        assert losses and np.isfinite(losses).all(), losses
        assert all("Validation/Loss" in row for row in rec["scalars"].values()), rec["scalars"]
        epochs_run = sorted(k for k, row in rec["scalars"].items() if "Training/Loss" in row)
        done.append((epochs_run, rec["start_steps"][0], result.checkpoints))
    steps_per_epoch = -(-len(rows) // cfg.training.bs)
    (first, first_start, checkpoints), (resumed, resumed_start, _) = done
    assert first == list(range(MAIN_EPOCHS)) and checkpoints and first_start == 0, done[0]
    last = max(int(os.path.basename(p).split("_")[1]) for p in checkpoints)
    assert resumed == list(range(last + 1, MAIN_EPOCHS + 1)), (resumed, last)
    assert resumed_start == (last + 1) * steps_per_epoch, (resumed_start, last)
    return {"launches": launches}


def _run_slowfast(runs) -> dict:
    """SlowFast R-50 (``configs/slowfast.yaml``: 256 px, 32 fast and 8 slow
    frames) from a weight file in pytorchvideo's ``slowfast_r50`` keys:
    ``evaluate.evaluate_split(model=2)`` over the 48-video split at the
    yaml's batch of 32, SGD steps at batch 32 through
    ``train.make_train_step``, one epoch of ``train_loop.main --model 2``."""
    from mintime_torch import evaluate, train, train_loop
    from mintime_torch.data import loader as loader_mod
    from mintime_torch.data.manifest import load_manifest
    from mintime_torch.models.slowfast import SlowFastClassifier
    from mintime_torch.utils.checkpoint import load_model_state

    cfg = ci.slowfast_config()
    d = runs.dir("slowfast")
    faces, split, _ = ci.write_split(d)
    man = load_manifest(split, faces)
    weights = os.path.join(d, "slowfast_r50.pth")
    sd = ci.slowfast_state_dict(SlowFastClassifier(device="cpu"), seed=5)
    torch.save({**sd, **{k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
                         for k in sd if k.endswith("running_var")}}, weights)
    launches = []

    # the evaluation function at the yaml's batch, then one video on the CPU in fp32
    logits, cpu_logits = {}, {}
    with _captured_forwards(logits):
        report, counts = _step_launches(lambda: evaluate.evaluate_split(
            cfg, weights, split, faces, model=2, workers=4, device="cuda"))
    launches.append(counts)
    assert report["n_videos"] == len(man) and _finite_report(report), report
    cpu = evaluate.build_model(cfg, weights, model=2, device="cpu", dtype=torch.float32)
    with _captured_forwards(cpu_logits), evaluate.split_loader(
            cfg, man.videos[:1], man.labels[:1], man.multiclass[:1], faces, 1, workers=1,
            device="cpu") as loader:
        evaluate.evaluate(cpu, None, loader)
    del cpu
    (first, cpu_logit), = cpu_logits.items()
    assert abs(logits[first] - cpu_logit) <= 5e-2, (logits[first], cpu_logit)

    # SGD steps at the yaml's batch through the train step
    model = train.slowfast_training_model(cfg.model, device="cuda", seed=0)
    model.load_state_dict(load_model_state(model, cfg, weights))
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    ds = _train_dataset(cfg, man, faces, cfg.training.augmentation)
    with loader_mod.DataLoader(ds, cfg.training.bs, shuffle=True, num_workers=4, seed=0,
                               worker_mode="process") as loader:
        batch = next(iter(loader))
    pos_weight = train.pos_weight_from_labels(np.asarray(man.labels, np.float32))
    state = train.create_train_state(model, cfg, steps_per_epoch=2, num_epochs=1)
    step = train.make_train_step(model, pos_weight)
    metrics, counts = _step_launches(lambda: step(state, batch))
    launches.append(counts)
    no_grad = [k for k, p in model.named_parameters() if p.grad is None
               or not torch.isfinite(p.grad).all() or not p.grad.abs().max() > 0]
    still = [k for k, v in model.named_buffers() if torch.equal(v, stats0[k])]
    losses = [float(metrics["loss"])] + [float(step(state, batch)["loss"]) for _ in range(3)]
    assert not no_grad and not still and np.isfinite(losses).all(), (no_grad[:4], still[:4], losses)
    del model, state, step
    torch.cuda.empty_cache()

    # one epoch of the training CLI
    _, val = ci.write_val_list(d, split)
    with _watch_main() as rec:
        result, counts = _step_launches(lambda: train_loop.main(
            _main_argv(d, split, val, "--model", "2", "--num_epochs", "0"), config=cfg))
    launches.append(counts)
    main_losses = [r["loss"] for r in rec["train"] + rec["val"]]
    assert result.checkpoints and main_losses and np.isfinite(main_losses).all(), main_losses
    return {"launches": {"slowfast": launches}}


# ---------------------------------------------------------------------------
# The tooling: the profiler CLI, feature extraction, the weight check,
# extractor pretraining
# ---------------------------------------------------------------------------

#: ``profiling.main``'s traced calls a run, and runs for a trace that lost no kernel
PROF_ITERS, PROF_TRIES = 3, 3


def _table_launches(rows, kind: str) -> int:
    """The most launched kernel of a table layer, its template variants
    summed (the FFN forward's differ between token and CLS rows)."""
    by_kernel = collections.Counter()
    for r in rows:
        if r["type"] == kind:
            by_kernel[re.search(r"(\w+_kernel)", r["name"]).group(1)] += r["launches"]
    return max(by_kernel.values(), default=0)


def _run_profiling(runs) -> dict:
    """The profiler CLI's function (``utils.profiling.main``) at flagship
    width, batch 8, a forward and ``--train``, each traced ``PROF_ITERS``
    times: each kernel's launches in the trace (template variants summed)
    equal its wrapper's counter over the traced calls; a trace that lost a
    kernel is taken again."""
    from mintime_torch.utils import profiling

    argv = ["--model", "1", "--batch", "8", "--iters", str(PROF_ITERS), "--device", "cuda",
            "--fused_attention", "1", "--trace_dir", runs.dir("trace")]
    fwd = {"divided_attention kernel": "divided_attention", "geglu_ffn kernel": "geglu_ffn"}
    kinds = {"forward": fwd,
             "train": {**fwd, "divided_attention backward kernel": "divided_attention_bwd",
                       "geglu_ffn backward kernel": "geglu_ffn_bwd"}}
    launches = {}
    for name, extra in (("forward", []), ("train", ["--train"])):
        tries = []
        for _ in range(PROF_TRIES):
            out, whole = _step_launches(lambda: profiling.main(argv + extra,
                                                               config=ci.flagship_config()))
            table = {kind: _table_launches(out["rows"], kind) for kind in kinds[name]}
            tries.append(table)
            if all(table[k] == out["launches"][w] for k, w in kinds[name].items()):
                break
        else:
            raise AssertionError(f"profiling {name}: the table's launches against the counters "
                                 f"{out['launches']} in {PROF_TRIES} runs: {tries}")
        # a traced call's launches of the model's kernels (the CLI counts them
        # over its traced calls); the other kernels over the whole run
        launches[f"profiling_{name}"] = [{**whole, **_per(out["launches"], PROF_ITERS)}]
    return {"launches": launches}


def _run_tooling_split(runs) -> dict:
    d = runs.dir("tooling")
    faces, split, _ = ci.write_split(d)
    return {"dir": d, "faces": faces, "split": split}


#: ``extract_features``: batch, the crops held card vs CPU
FEAT_BATCH, FEAT_CHECKED = 64, 8


def _run_extract_features(runs) -> dict:
    """B0 features of every crop of the split's packs through
    ``extract_features.extract_features`` on the card at batch 64, from an
    ``Extractor_checkpoint`` file of seeded weights; one ``.npy`` a crop; the
    first crops' maps against the CPU in fp32."""
    from mintime_torch.data.crop_store import CropPack, find_pack
    from mintime_torch.data.frames import pack_crop_names
    from mintime_torch.preprocessing import extract_features as ef

    s = runs.get("tooling_split")
    faces, d = s["faces"], runs.dir("extract_features")
    paths, crops = [], []
    for root, _, _ in sorted(os.walk(faces)):
        if find_pack(root):
            pack = CropPack(find_pack(root))
            for i, name in enumerate(pack_crop_names(pack)):
                paths.append(os.path.join(root, name))
                crops.append(pack.read(i))
    _, ext = ci.write_model_files(d, 0, "efficientnet-b0", 1280)
    out, cpu = os.path.join(d, "features"), os.path.join(d, "features_cpu")
    n = ef.extract_features(paths, ef.build_extractor(ext, device="cuda"), out, faces,
                            crops=crops, batch_size=FEAT_BATCH)
    ef.extract_features(paths[:FEAT_CHECKED], ef.build_extractor(ext, device="cpu"), cpu, faces,
                        crops=crops[:FEAT_CHECKED], batch_size=FEAT_CHECKED)
    written = sum(len(f) for _, _, f in os.walk(out))
    assert n == written == len(paths), (n, written, len(paths))
    for p in paths[:FEAT_CHECKED]:
        rel = os.path.splitext(os.path.relpath(p, faces))[0] + ".npy"
        got, want = np.load(os.path.join(out, rel)), np.load(os.path.join(cpu, rel))
        assert float(np.abs(got - want).max() / np.abs(want).max()) <= 5e-2, rel
    return {"launches": {}}


def _run_verify_weights(runs) -> dict:
    """``verify_weights.main`` on seeded weight files in the published
    formats (MTCNN, FaceNet, MINTIME-EF's Model and Extractor files, a
    ``slowfast_r50`` file wrapped as the hub file is): rc 0 and every arm's
    ``[ OK ]`` lines."""
    from mintime_torch import verify_weights
    from mintime_torch.models.slowfast import SlowFastClassifier

    d = runs.dir("verify_weights")
    files = ci.write_weight_files(d)
    sf = os.path.join(d, "SLOWFAST_8x8_R50.pyth")
    torch.save({"model_state": ci.slowfast_state_dict(SlowFastClassifier(device="cpu"), seed=5)},
               sf)
    head, ext = files["predict_ef"]
    argv = ["--mtcnn_weights", files["mtcnn"], "--facenet_weights", files["facenet"],
            "--model_weights", head, "--extractor_weights", ext, "--extractor_model", "0",
            "--slowfast_weights", sf, "--device", "cuda"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc, counts = _step_launches(lambda: verify_weights.main(argv,
                                                                config=ci.flagship_config()))
    ok = [ln for ln in printed.getvalue().splitlines() if ln.startswith("[ OK ]")]
    assert rc == 0 and len(ok) >= 8, (rc, printed.getvalue())
    return {"launches": {"verify_weights": [counts]}}


#: ``pretrain``: epochs (``--num_epochs 1``), spawned workers
PRE_EPOCHS, PRE_WORKERS = 2, 4


def _run_pretrain(runs) -> dict:
    """``pretrain_extractor.main`` with ``configs/extractor_pretraining.yaml``'s
    config (224 px, batch 16, the ``min`` preset, SGD, StepLR) for 2 epochs
    on the split's videos, every third the validation list, 4 spawned
    workers. The exported extractor equals the checkpoint's bitwise and
    loads into MINTIME-EF bitwise."""
    from mintime_torch import pretrain_extractor
    from mintime_torch.models.classifier import MintimeVideoClassifier
    from mintime_torch.utils.checkpoint import load_model_state

    s = runs.get("tooling_split")
    d = runs.dir("pretrain")
    _, val = ci.write_val_list(d, s["split"])
    out = os.path.join(d, "pretrain")
    argv = ["--train_list_file", s["split"], "--validation_list_file", val,
            "--data_path", s["faces"], "--num_epochs", str(PRE_EPOCHS - 1),
            "--workers", str(PRE_WORKERS), "--models_output_path", out, "--device", "cuda"]
    with _watch_main() as rec:
        best, counts = _step_launches(
            lambda: pretrain_extractor.main(argv, config=ci.pretrain_config()))
    assert np.isfinite([r["loss"] for r in rec["train"] + rec["val"]]).all()
    ck = torch.load(os.path.join(out, f"checkpoint_{best.rsplit('checkpoint', 1)[1]}"),
                    weights_only=True)["params"]
    exported = torch.load(best, weights_only=True)
    assert all(torch.equal(exported[k[len("extractor."):]], v)
               for k, v in ck.items() if k.startswith("extractor."))
    head, _ = ci.write_model_files(d, 0, "efficientnet-b0", 1280)
    model = MintimeVideoClassifier(ci.flagship_config().model, device="cuda",
                                   param_dtype=torch.float32)
    model.load_state_dict(load_model_state(model, None, head, extractor_weights=best))
    assert all(torch.equal(model.state_dict()[f"extractor.{k}"].cpu(), v)
               for k, v in exported.items())
    return {"launches": {"pretrain": [counts]}}


# ---------------------------------------------------------------------------
# Data and tensor parallelism: spawned ranks on the one card
# ---------------------------------------------------------------------------

#: seconds a spawned rank may take
RANK_LIMIT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(target, world: int, args: tuple, d: str) -> list:
    """``target(rank, world, port, *args, out)`` in ``world`` spawned
    processes on the one card, each writing its result to ``out``; a rank
    past ``RANK_LIMIT_S`` is killed and fails the run."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, port, *args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_LIMIT_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    late = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not late and not any(p.exitcode for p in procs), \
        f"ranks {late} late, exit codes {[p.exitcode for p in procs]}"
    return [torch.load(o, weights_only=False) for o in outs]


def _rank_env(rank: int, world: int, port: int) -> None:
    # LOCAL_RANK 0 for every rank: the processes share the one card
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")


def _nccl_main_rank(rank, world, port, argv, out):
    """One rank of a ``torchrun``-like launch of ``train_loop.main``: the
    process group from the environment, NCCL on the card."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from mintime_torch import train_loop

    result, counts = _step_launches(
        lambda: train_loop.main(argv, config=ci.flagship_train_config()))
    torch.save({"backend": dist.get_backend(), "world": dist.get_world_size(),
                "epochs_run": result.epochs_run, "checkpoints": result.checkpoints,
                "launches": counts}, out)
    dist.destroy_process_group()


def _run_nccl(runs) -> dict:
    """A one-rank NCCL group (the environment of ``torchrun --nproc_per_node
    1``) running ``train_loop.main`` for one step of 8 videos and their
    validation pass."""
    s = runs.get("tooling_split")
    d = runs.dir("nccl")
    _, val = ci.write_val_list(d, s["split"])
    argv = ["--train_list_file", s["split"], "--validation_list_file", val,
            "--data_path", s["faces"], "--num_epochs", "0", "--max_videos", "8",
            "--workers", "2", "--models_output_path", os.path.join(d, "models"),
            "--logger_name", os.path.join(d, "runs"), "--device", "cuda"]
    (run,) = _spawn_ranks(_nccl_main_rank, 1, (argv,), d)
    assert run["backend"] == "nccl" and run["world"] == 1 and run["epochs_run"] == 1, run
    assert len(run["checkpoints"]) == 1, run
    return {"launches": {"train_main_nccl": [run["launches"]]}}


def _plain_fp32(mcfg):
    """The flagship on the plain path in fp32 from seed 0 (TF32 off by the caller)."""
    from mintime_torch.models.classifier import MintimeVideoClassifier

    return MintimeVideoClassifier(mcfg, use_kernels=False, device="cuda", dtype=torch.float32,
                                  param_dtype=torch.float32, seed=0)


def _parallel_step(cfg, model, batch, pos_weight, mesh) -> dict:
    """One train step of ``model`` on ``batch`` through the mesh: its loss,
    its launches counted from 0, the gradients and the parameters after it,
    and the TP shards' heads and hidden widths."""
    from mintime_torch import train
    from mintime_torch.parallel.mesh import TensorParallelGEGLU

    state = train.create_train_state(model, cfg, steps_per_epoch=5, num_epochs=1, seed=0)
    step = train.make_train_step(model, pos_weight, mesh=mesh)
    metrics, counts = _step_launches(lambda: step(state, batch))
    return {"loss": float(metrics["loss"]), "launches": counts,
            "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "heads": sorted({m.heads for m in model.modules() if hasattr(m, "heads")}),
            "hidden": [m.net["3"].weight.shape[1] for m in model.modules()
                       if isinstance(m, TensorParallelGEGLU)][:1]}


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


def _tp_fp32_check(mcfg, batch, pos_weight, mesh) -> None:
    """TP=2 on the plain path in fp32 against the same model in one piece on
    the whole batch: eval-mode logits within 1e-4 of their max, the step's
    loss within 1e-4 relative, and each head parameter's gradient (this
    rank's part of the whole one) within 1e-3 of its max. A wrong split or a
    missing all-reduce, forward or backward, moves these by far more."""
    from mintime_torch import train
    from mintime_torch.parallel.mesh import MODEL_AXIS, axis_rank, axis_size, tensor_parallel

    model = _plain_fp32(mcfg)
    inputs = train.model_inputs(batch, model.head_kind, model.device)
    with torch.no_grad():
        logits_one = model(*inputs, train=False).float()
    loss_one, g_one = _one_step_grads(model, batch, pos_weight, False)
    _set_use_kernels(model, False)
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
    assert float((logits_tp - logits_one).abs().max()) <= 1e-4 * float(logits_one.abs().max())
    assert abs(loss_tp - loss_one) <= 1e-4 * abs(loss_one), (loss_tp, loss_one)
    assert max(errs.values()) <= 1e-3, max(errs.items(), key=lambda kv: kv[1])
    del model
    torch.cuda.empty_cache()


def _parallel_rank(rank, world, port, batch_path, out):
    """One rank over gloo on the card (NCCL refuses two ranks on one card).
    Data-parallel, on this rank's half of the batch: the plain path's step in
    fp32, then the kernels held to ``_grad_check``'s rule with every run
    data-parallel, then the flagship's bf16 step with the kernels.
    Tensor-parallel, on the whole batch with half the heads and hidden
    units: the plain path in fp32 against one process, the kernels held to
    ``_grad_check``'s rule (logits too), then the bf16 step."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from mintime_torch import train
    from mintime_torch.parallel.mesh import make_mesh, shard_batch, tensor_parallel

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    cfg, batch, pos_weight = torch.load(batch_path, weights_only=False)
    dp_mesh = make_mesh(device="cuda")
    rows = shard_batch(dp_mesh, batch)
    fp32 = _parallel_step(cfg, _plain_fp32(cfg.model), rows, pos_weight, dp_mesh)
    torch.cuda.empty_cache()
    model = train.training_model(cfg.model, device="cuda", seed=0)
    _grad_check(model, _plain_fp32(cfg.model), rows, pos_weight,
                [n for n, _ in model.named_parameters()], mesh=dp_mesh, check_logits=True)
    del model
    dp = _parallel_step(cfg, train.training_model(cfg.model, device="cuda", seed=0), rows,
                        pos_weight, dp_mesh)
    torch.cuda.empty_cache()
    tp_mesh = make_mesh(model_parallel=2, device="cuda")
    _tp_fp32_check(cfg.model, batch, pos_weight, tp_mesh)
    model = tensor_parallel(train.training_model(cfg.model, device="cuda", seed=0), tp_mesh)
    _grad_check(model, tensor_parallel(_plain_fp32(cfg.model), tp_mesh), batch, pos_weight,
                [n for n, _ in model.named_parameters()], check_logits=True)
    del model
    torch.cuda.empty_cache()
    tp = _parallel_step(cfg, tensor_parallel(train.training_model(cfg.model, device="cuda",
                                                                  seed=0), tp_mesh),
                        batch, pos_weight, tp_mesh)
    torch.save({"fp32": fp32, "dp": dp, "tp": tp}, out)
    dist.destroy_process_group()


def _run_parallel(runs) -> dict:
    """Two ranks on the one card over gloo against one process at batch 8.
    DP=2, batch 8 as 4 + 4: the plain path's step in fp32 (TF32 off), each
    gradient within 1e-3 of its tensor's max, the tensors zero in exact
    arithmetic aside (an fp32 max under 2^-8 of the bf16 one); the kernels
    against the plain path; then the flagship's step at full width in bf16
    with the kernels, its loss within 2e-2 of one process's and the ranks'
    parameters bitwise equal after it. TP=2 (4 heads and 1024 hidden units a
    rank): the plain path in fp32 against one process, the kernels by the
    same rule, then the bf16 step, its loss within 2e-2."""
    from mintime_torch import train

    cfg, batch, pos_weight = ci.flagship_train_batch()
    model = train.training_model(cfg.model, device="cuda", seed=0)
    loss_one, g_one = _one_step_grads(model, batch, pos_weight, True)
    ref = _plain_fp32(cfg.model)
    loss_32, g32 = _one_step_grads(ref, batch, pos_weight, False)
    del model, ref
    torch.cuda.empty_cache()
    d = runs.dir("parallel")
    batch_path = os.path.join(d, "batch.pt")
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
    torch.save((cfg, cpu, pos_weight), batch_path)
    ranks = _spawn_ranks(_parallel_rank, 2, (batch_path,), d)
    fp32, dp, tp = ([r[k] for r in ranks] for k in ("fp32", "dp", "tp"))
    assert all(abs(r["loss"] - loss_one) <= TOL for r in dp + tp), \
        ([r["loss"] for r in dp + tp], loss_one)
    assert all(abs(r["loss"] - loss_32) <= 1e-4 * abs(loss_32) for r in fp32), \
        ([r["loss"] for r in fp32], loss_32)
    fp32_err = {}
    for n, g in g32.items():
        top = 0.0 if g_one[n] is None else float(g_one[n].abs().max())
        # no gradient (the last layer's token FFN), or zero in exact
        # arithmetic: the _bn2 biases under a train-mode BatchNorm hold
        # rounding noise on both sides
        if top and float(g.abs().max()) > 2**-8 * top:
            fp32_err[n] = float((fp32[0]["grads"][n].to(g.device) - g).abs().max()) / \
                float(g.abs().max())
    worst = max(fp32_err, key=fp32_err.get)
    assert fp32_err[worst] <= 1e-3, (worst, fp32_err[worst])
    differ = [n for n in dp[0]["params"] if not torch.equal(dp[0]["params"][n], dp[1]["params"][n])]
    assert not differ, f"parameters differing across ranks: {differ[:4]}"
    hidden = cfg.model.dim * 4 // 2
    assert all(r["heads"] == [cfg.model.heads // 2] and r["hidden"] == [hidden] for r in tp), \
        [(r["heads"], r["hidden"]) for r in tp]
    return {"launches": {"parallel_dp2": [r["launches"] for r in dp],
                         "parallel_tp2": [r["launches"] for r in tp]}}


# ---------------------------------------------------------------------------
# The Convolutional TimeSformer, the v1 grouped attention, the probes
# ---------------------------------------------------------------------------

def _run_conv(runs, tap: int) -> dict:
    """The Convolutional TimeSformer preset tapped at block ``tap`` at full
    width, bf16 weights from seed 0, through ``train.make_eval_step`` at
    batch 8: its logits against the plain path and a CPU fp32 run."""
    from mintime_torch import train
    from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer

    mcfg = ci.conv_model_config(tap)
    model = ConvolutionalTimeSformer(mcfg, use_kernels=True, device="cuda", seed=0)
    batch = ci.conv_batch()
    eval_step = train.make_eval_step(model, 1.0)
    out, counts = _step_launches(lambda: eval_step(None, batch))
    logits_k = out["logits"].float().cpu().numpy()
    assert logits_k.shape == (8,) and np.isfinite(logits_k).all()
    _set_use_kernels(model, False)
    logits_p = eval_step(None, batch)["logits"].float().cpu().numpy()
    _set_use_kernels(model, True)
    assert float(np.abs(logits_k - logits_p).max()) <= TOL
    # the same weights in fp32 on the CPU (plain path) on the first video
    cpu = ConvolutionalTimeSformer(mcfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        logit_cpu = float(cpu(torch.from_numpy(batch["frames"][:1]), None,
                              torch.from_numpy(batch["size_embedding"][:1]))[0, 0])
    assert abs(logit_cpu - float(logits_k[0])) <= 5e-2
    return {"launches": {"conv_forward" if tap == 20 else f"conv_tap{tap}_forward": [counts]}}


def _run_conv_train(runs, tap: int) -> dict:
    """The preset tapped at block ``tap`` with fp32 masters computing in
    bf16, kernels on: one step's gradients against the plain path over the
    head's parameters, then 5 SGD steps at batch 8 (lr 0.01, weight decay
    1e-4) through ``train.make_train_step``; the extractor stays frozen."""
    from mintime_torch import train
    from mintime_torch.config import MintimeConfig, TrainingConfig
    from mintime_torch.models.conv_timesformer import ConvolutionalTimeSformer

    mcfg = ci.conv_model_config(tap)
    # the yaml's training section, but batch 8 (its bs is 1), as the flagship's
    lr, wd = 0.01, 1e-4
    cfg = MintimeConfig(model=mcfg, training=TrainingConfig(
        lr=lr, weight_decay=wd, optimizer="SGD", scheduler="steplr", gamma=0.1, step_size=15,
        bs=8))
    batch = ci.conv_batch()
    pos_weight = train.pos_weight_from_labels(batch["labels"])
    model = train.conv_training_model(mcfg, device="cuda", seed=0)
    assert model.dtype == torch.float32 and model.compute_dtype == torch.bfloat16
    head = [n for n, _ in model.named_parameters() if not n.startswith("extractor.")]
    ref = ConvolutionalTimeSformer(mcfg, device="cuda", dtype=torch.float32,
                                   param_dtype=torch.float32, seed=0)
    _grad_check(model, ref, batch, pos_weight, head)

    state = train.create_train_state(model, cfg, steps_per_epoch=5, num_epochs=1, seed=0)
    step = train.make_train_step(model, pos_weight)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    ext0 = {n: p.detach().clone() for n, p in model.named_parameters() if n not in head}
    losses, launches = [], []
    for _ in range(5):
        metrics, counts = _step_launches(lambda: step(state, batch))
        losses.append(float(metrics["loss"]))
        launches.append(counts)
    with torch.no_grad():
        after = float(train.forward_loss(model, batch, pos_weight, train=True)[0])
    assert np.isfinite(after) and after < losses[0], (after, losses)
    moved = sorted(k for k, v in model.named_buffers() if not torch.equal(v, stats0[k]))
    assert not moved, f"frozen extractor's BatchNorm statistics moved: {moved[:8]}"
    # a zero gradient under coupled weight decay: p <- p * (1 - lr * wd), five times
    decay = max(float((p.detach() - ext0[n] * (1 - lr * wd) ** 5).abs().max()
                      / ext0[n].abs().max().clamp(min=1e-30))
                for n, p in model.named_parameters() if n in ext0)
    assert decay <= 1e-5, f"frozen extractor moved by more than weight decay: {decay}"
    return {"launches": {"conv_train_step" if tap == 20 else f"conv_tap{tap}_train_step":
                         launches}}


def _run_grouped(runs) -> dict:
    """``fused_grouped_attention``, the JAX package's v1 public function, at
    flagship width (B = 8, 8 heads of 64) on both axes, masked as
    ``tests/test_pallas_attention.py`` masks and unmasked: four calls through
    the entry point, each against the plain grouped attention with a CLS
    column (the attention-map path) in fp32 and the kernel's plain version."""
    from mintime_torch.experiments.kernel_turns import grouped_inputs
    from mintime_torch.ops import grouped_attention as ga
    from mintime_torch.ops.attention import grouped_attention_with_cls

    gen = torch.Generator().manual_seed(3)
    inputs = [grouped_inputs(gen, G, L, masked) for G, L in ((49, 16), (16, 49))
              for masked in (True, False)]
    outs, counts = _step_launches(
        lambda: [ga.fused_grouped_attention(*args, heads=8) for args, _ in inputs])
    for (args, mask), out in zip(inputs, outs):
        assert out.shape == args[0].shape and out.dtype == torch.bfloat16
        assert torch.isfinite(out).all()
        ref = grouped_attention_with_cls(*(t.float() for t in args[:5]),
                                         None if mask is None else mask[:, None])
        for want in (ref, ga.fused_grouped_attention_plain(*args, heads=8)):
            assert float((out.float() - want.float()).abs().max()) <= TOL
    return {"launches": {"grouped_attention_calls": [counts]}}


def _run_probes(runs) -> dict:
    """The three probes' ``run()`` at their full sizes (the attention variants
    at B = 32, the depthwise forward and weight gradient at 512 images over
    their geometries): the kernel variants B and G agree with variant A
    within 2e-2."""
    from mintime_torch.experiments import attn_kernel_variants as attn_probe
    from mintime_torch.experiments import dw_conv_bwd_cuda_vs_cudnn as dwb_probe
    from mintime_torch.experiments import dw_conv_cuda_vs_cudnn as dwf_probe

    probes = (attn_probe, dwf_probe, dwb_probe)
    tables, counts = _step_launches(lambda: [mod.run() for mod in probes])
    off = {f"{r['axis']} {k}": r[k] for r in tables[0] for k in r
           if k.startswith(("B_vs_A", "G_vs_A")) and not r[k] <= TOL}
    assert not off, f"attention variants differ from variant A by more than {TOL}: {off}"
    return {"launches": {"probes": [counts]}}


RUNS = {
    "slice": _run_slice, "detect": _run_detect, "predict": _run_predict,
    "evaluate": _run_evaluate, "train": _run_train, "train_split": _run_train_split,
    "augment": _run_augment, "train_disk": _run_train_disk, "train_main": _run_train_main,
    "slowfast": _run_slowfast, "profiling": _run_profiling, "tooling_split": _run_tooling_split,
    "extract_features": _run_extract_features, "verify_weights": _run_verify_weights,
    "pretrain": _run_pretrain, "nccl": _run_nccl, "parallel": _run_parallel,
    "conv20": functools.partial(_run_conv, tap=20), "conv10": functools.partial(_run_conv, tap=10),
    "conv_train20": functools.partial(_run_conv_train, tap=20),
    "conv_train10": functools.partial(_run_conv_train, tap=10),
    "grouped": _run_grouped, "probes": _run_probes,
}
#: the run that records each path's launches
PATH_RUN = {
    "flagship_forward": "slice", "detect": "detect",
    **{f"predict_{m}{s}": "predict" for m in ("ef", "xc") for s in ("", "_pipelined", "_plain")},
    "evaluate": "evaluate", "flagship_train_step": "train",
    "flagship_train_step_from_disk": "train_disk",
    "train_main_step": "train_main", "train_main_validation": "train_main",
    "train_main_nccl": "nccl", "slowfast": "slowfast",
    "profiling_forward": "profiling", "profiling_train": "profiling",
    "verify_weights": "verify_weights", "pretrain": "pretrain",
    "parallel_dp2": "parallel", "parallel_tp2": "parallel",
    "conv_forward": "conv20", "conv_train_step": "conv_train20",
    "conv_tap10_forward": "conv10", "conv_tap10_train_step": "conv_train10",
    "grouped_attention_calls": "grouped", "probes": "probes",
}


# ---------------------------------------------------------------------------
# The tests: each path's checks, then every path's launches
# ---------------------------------------------------------------------------

def test_flagship_forward_matches_plain_and_cpu(runs):
    """Crops of 224 px, one identity in video 0 and two in the rest, padded
    frames; probabilities in [0, 1], an attention map per identity and
    aggregated maps that sum to 1; kernel logits within 2e-2 of the plain
    path's and within 5e-2 of a CPU fp32 run's."""
    runs.get("slice")


def test_detect_at_dfdc_frame_size_matches_cpu(runs):
    """The nets on the card, the native NMS library loaded, no P-Net
    truncation at 1920 x 1080, faces found; on two frames the card's boxes
    against the CPU's and against host crops within 2e-2 with the same
    counts; three videos through the stage-1 tail's copy against the main
    path's boxes; embeddings within 1e-4 of the CPU's, the same clusters."""
    runs.get("detect")


def test_predict_pipeline_matches_plain_cpu_and_detect(runs):
    """For MINTIME-EF and MINTIME-XC from weight files: kernel logits within
    2e-2 of the plain path's and within 5e-2 of a CPU fp32 run's; the card's
    evaluation transform within one level of the CPU's on at most 0.1% of
    the values; finite probabilities and maps; the detection run's
    identities; the pipelined run's probabilities within 1e-6 of the
    sequential run's and its identities equal."""
    runs.get("predict")


def test_evaluate_split_matches_plain_and_cpu(runs):
    """Kernel logits within min(2e-2, a quarter of the plain logits' std) of
    a plain run's, of the same sign where the plain logit lies more than
    2e-2 from 0 (a quarter of the videos or more on each side); the first
    two videos within 5e-2 of a CPU fp32 run; ``n_videos`` 48, and 32 with
    ``only_multiidentity``; equal accuracy where no logit lies within 2e-2 of
    0; finite reports, and the loader's passes at batch 8 and 1 giving the
    split's report."""
    runs.get("evaluate")


def test_flagship_train_step(runs):
    """fp32 masters computing in bf16; one step's gradients against the plain
    path (``_grad_check``); after 5 steps the loss of step 0's batch below
    the first, every BatchNorm statistic moved."""
    runs.get("train")


def test_augmentations_match_cpu(runs):
    """The resize chain bitwise, and each of the 26 transforms bitwise or
    within one level (``AUG_BITWISE``) of the CPU on the same stack and
    draws."""
    runs.get("augment")


def test_flagship_trains_from_disk(runs):
    """Finite losses for 2 epochs of 6 steps, one step's loss with kernels
    within 2e-2 of the plain path's, every video's frames bitwise equal in
    both epochs."""
    runs.get("train_disk")


def test_training_cli_runs_and_resumes(runs):
    """Finite losses, ``Validation/Loss`` logged every epoch, a checkpoint
    written, and the resumed run starting at that checkpoint's epoch + 1 and
    step."""
    runs.get("train_main")


def test_slowfast_evaluates_and_trains(runs):
    """The report over 48 videos finite, the first logit within 5e-2 of a
    CPU fp32 run; every parameter a finite non-zero gradient, every
    BatchNorm statistic moved, finite losses; the CLI's epoch writes a
    checkpoint."""
    runs.get("slowfast")


def test_profiler_traces_every_launch(runs):
    """Each kernel's launches in the profiler CLI's table equal its wrapper's
    counter over the traced calls."""
    runs.get("profiling")


def test_extract_features_matches_cpu(runs):
    """A feature file for every crop, the first 8 within 5e-2 of max |CPU|."""
    runs.get("extract_features")


def test_verify_weights_accepts_the_published_formats(runs):
    """rc 0 and 8 ``[ OK ]`` lines or more."""
    runs.get("verify_weights")


def test_pretrain_exports_the_extractor(runs):
    """Finite losses; the exported extractor equal to the checkpoint's and
    loaded into MINTIME-EF bitwise."""
    runs.get("pretrain")


def test_training_cli_on_one_nccl_rank(runs):
    """The NCCL backend, one rank, one epoch run, one checkpoint."""
    runs.get("nccl")


def test_data_and_tensor_parallel_steps(runs):
    """DP=2 and TP=2 against one process, as ``_run_parallel`` says."""
    runs.get("parallel")


@pytest.mark.parametrize("tap", [20, 10])
def test_conv_forward_matches_plain_and_cpu(runs, tap):
    """Kernel logits within 2e-2 of the plain path's and within 5e-2 of a
    CPU fp32 run's."""
    runs.get(f"conv{tap}")


@pytest.mark.parametrize("tap", [20, 10])
def test_conv_train_step(runs, tap):
    """``_grad_check`` over the head; the loss falls; the frozen extractor's
    statistics stay bitwise and its weights move by weight decay alone."""
    runs.get(f"conv_train{tap}")


def test_grouped_attention_entry_point(runs):
    """Each output bf16, finite, of q's shape and within 2e-2 of the fp32
    reference and of the kernel's plain version."""
    runs.get("grouped")


def test_probes_agree_with_variant_a(runs):
    """The attention probe's kernel variants B and G within 2e-2 of A."""
    runs.get("probes")


@pytest.mark.parametrize("path", sorted(LAUNCHES))
def test_path_launches(runs, path):
    """Each unit of the path (a forward, a step, a run) launches the kernels
    of its line of ``LAUNCHES``, and no others; every kernel that a wrapper
    counts is launched by some path."""
    launched = {k for line in LAUNCHES.values() for k, n in line.items() if n != 0}
    assert launched == set(COUNTERS), f"kernels no path launches: {set(COUNTERS) - launched}"
    want = LAUNCHES[path]
    got = runs.get(PATH_RUN[path])["launches"][path]
    assert got, path
    for counts in got:
        assert set(counts) == set(want)
        off = {k: counts[k] for k, n in want.items()
               if (counts[k] == 0 if n is SOME else counts[k] != n)}
        assert not off, f"{path}: launches {off}, want {want}"
