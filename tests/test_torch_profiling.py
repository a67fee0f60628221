"""The port's profiler (``mintime_torch/utils/profiling.py``) against the JAX
package's (``mintime_tpu/utils/profiling.py``) on the CPU: the example inputs
bitwise, ``op_stats`` on a directory without a trace, and the
CLI at a small size (32 px, depth 1, dim 32) for ``--model 0``, ``1``, ``3``,
``--grad`` and ``--train``: videos/s printed and a non-empty op table whose
sections sort the forward's ops into ``fwd`` and the autograd engine's into
``bwd``; and ``_window_kernels`` and ``_profile`` on a card's window given as
raw profiler records built by hand.
"""

import os

import numpy as np
import pytest
import torch

from mintime_torch.config import MintimeConfig, ModelConfig
from mintime_torch.utils import profiling

SMALL = ModelConfig(image_size=32, num_frames=8, num_patches=1, channels=1280, dim=32, depth=1,
                    heads=2, dim_head=16, max_identities=2)
CONV = ModelConfig(image_size=32, num_frames=8, num_patches=1280, channels=1280, dim=64,
                   depth=1, heads=2, dim_head=32, efficient_net_block=20)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch", [1, 3])
def test_example_inputs_are_the_jax_ones_bitwise(batch):
    from mintime_tpu.config import ModelConfig as JaxModelConfig
    from mintime_tpu.utils import profiling as jax_profiling

    jcfg = JaxModelConfig(image_size=32, num_frames=16, num_patches=4)
    cfg = ModelConfig(image_size=32, num_frames=16, num_patches=4)
    for got, want in zip(profiling._example_inputs(cfg, batch),
                         jax_profiling._example_inputs(jcfg, batch)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_op_stats_requires_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.op_stats(str(tmp_path))


def test_sync_passes_cpu_tensors_through():
    x = {"a": [torch.ones(2)], "b": 3}
    assert profiling.sync(x) is x


def test_trace_writes_a_chrome_trace_that_op_stats_reads(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), cuda=False):
        with profiling.span(profiling.MODEL + "head"):
            (a @ a).sum()
    rows = profiling.op_stats(str(tmp_path), top=50)
    assert set(rows[0]) == {"name", "type", "self_ms", "launches", "section"}
    mm = [r for r in rows if r["name"] == "aten::mm"]
    assert mm and mm[0]["section"] == "fwd" and mm[0]["launches"] == 1


def _run(capsys, tmp_path, cfg, *args):
    out = profiling.main(["--device", "cpu", "--batch", "2", "--iters", "2", "--top", "5",
                          "--trace_dir", str(tmp_path), *args], config=MintimeConfig(model=cfg))
    printed = capsys.readouterr().out
    assert "videos/s" in printed and "total self-time by graph section" in printed
    assert out["rows"] and out["videos_per_s"] > 0
    return out


@pytest.mark.parametrize("model", ["0", "1"])
def test_cli_forward(capsys, tmp_path, model):
    out = _run(capsys, tmp_path, SMALL, "--model", model)
    assert {r["section"] for r in out["rows"]} == {"fwd"}
    assert any("convolution" in r["name"] for r in out["rows"])


def test_cli_conv_model(capsys, tmp_path):
    out = _run(capsys, tmp_path, CONV, "--model", "3")
    assert {r["section"] for r in out["rows"]} == {"fwd"}


def test_cli_grad(capsys, tmp_path):
    out = _run(capsys, tmp_path, SMALL, "--model", "1", "--grad")
    assert {"fwd", "bwd"} <= {r["section"] for r in out["rows"]}


def test_cli_train_step(capsys, tmp_path):
    out = _run(capsys, tmp_path, SMALL, "--model", "1", "--train")
    sections = {r["section"] for r in out["rows"]}
    assert {"fwd", "bwd", "other"} <= sections  # "other": the SGD update
    # the kernel wrappers' plain versions on the CPU count no launch
    assert not any(out["launches"].values())


def test_cli_train_refuses_slowfast(capsys, tmp_path):
    with pytest.raises(SystemExit):
        profiling.main(["--device", "cpu", "--model", "2", "--train"],
                       config=MintimeConfig(model=SMALL))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        profiling.main(["--model", "1"], config=MintimeConfig(model=SMALL))


def _synthetic_card_trace(d):
    """A Chrome trace as the card writes one: the lead-in's four launches,
    then a forward's launch (under a ``model.*`` span), a backward's (under the autograd engine's
    range), an optimizer's and a ``*_bwd*`` kernel's; one launch lost."""
    import json

    ev = []
    for i in range(4):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": i,
                   "dur": 1, "tid": 1, "args": {"correlation": i}})
    ev += [{"ph": "X", "cat": "user_annotation", "name": "model.extractor", "ts": 10, "dur": 20,
            "tid": 1},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 11, "dur": 10, "tid": 1},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1,
            "tid": 1, "args": {"correlation": 10}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 14, "dur": 1,
            "tid": 1, "args": {"correlation": 11}},
           {"ph": "X", "cat": "cpu_op", "name": BWD, "ts": 40, "dur": 20, "tid": 2},
           {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 41, "dur": 1,
            "tid": 2, "args": {"correlation": 12}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 1,
            "tid": 1, "args": {"correlation": 13}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 80, "dur": 1,
            "tid": 1, "args": {"correlation": 14}}]
    for corr, name in ((10, "nvjet_tst_gemm"), (12, "attn_rows_kernel"), (13, "sgd_update"),
                       (14, "ffn_bwd_dh_kernel")):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": 100 + corr, "dur": 2000,
                   "args": {"correlation": corr}})
    with open(os.path.join(d, "host.1.pt.trace.json"), "w") as f:
        json.dump({"traceEvents": ev}, f)


BWD = profiling.BACKWARD_RANGE + ": MmBackward0"


def test_card_trace_sections_and_lost_kernels(tmp_path):
    _synthetic_card_trace(str(tmp_path))
    rows = {r["name"]: r for r in profiling.op_stats(str(tmp_path), top=10)}
    assert {n: (r["section"], r["type"]) for n, r in rows.items()} == {
        "nvjet_tst_gemm": ("fwd", "matmul (cuBLAS)"), "attn_rows_kernel": ("bwd", "elementwise"),
        "sgd_update": ("other", "elementwise"), "ffn_bwd_dh_kernel": ("bwd",
                                                                      "geglu_ffn backward kernel")}
    assert all(r["self_ms"] == 2.0 and r["launches"] == 1 for r in rows.values())
    assert profiling.kernels_lost(str(tmp_path)) == {"aten::mm": 1}


class _Record:
    """A raw profiler record, as ``prof.profiler.kineto_results.events()``
    gives one."""

    def __init__(self, name, device, corr, start, end, annotation=False):
        self._v = (name, device, corr, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def _raw_profile():
    """A card's window in raw records: the lead-in's four spin kernels; two
    launched kernels that overlap, the second recorded 100 ns before its
    launch; a launch without a record; a copy; and a ``forward`` range's
    device span, which is no kernel."""
    from types import SimpleNamespace

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    recs = []
    for i in range(profiling.LEAD_INS):
        recs += [_Record("cudaLaunchKernel", cpu, i, 10 * i, 10 * i + 1),
                 _Record("void at::native::spin_kernel(long)", cuda, i, 10 * i + 2, 10 * i + 5)]
    recs += [_Record("cudaLaunchKernel", cpu, 100, 1000, 1010),
             _Record("cudaLaunchKernel", cpu, 101, 2100, 2110),
             _Record("cuLaunchKernelEx", cpu, 102, 2200, 2210),
             _Record("cudaMemcpyAsync", cpu, 103, 2300, 2310),
             _Record("model.extractor", cuda, 0, 1500, 4500, annotation=True),
             _Record("void geglu_ffn_up_kernel<64>(Params)", cuda, 100, 1500, 2500),
             _Record("nvjet_tst_gemm", cuda, 101, 2000, 3000),
             _Record("Memcpy HtoD (Pageable -> Device)", cuda, 103, 4000, 4500)]
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: list(reversed(recs)))))


def test_window_kernels_read_the_raw_records():
    kernels, lost, early_ms = profiling._window_kernels(_raw_profile())
    assert kernels == [("void geglu_ffn_up_kernel<64>(Params)", 1500, 2500),
                       ("nvjet_tst_gemm", 2000, 3000),
                       ("Memcpy HtoD (Pageable -> Device)", 4000, 4500)]
    assert lost == 1
    assert early_ms == pytest.approx(1e-4)


def test_profile_reports_the_union_of_the_raw_records(monkeypatch):
    """Busy time is the union of the device records (2000 ns of a 4000 ns
    window); the window that lost a record is profiled again, ``TRIES``
    times, and then reported with the loss, since no launch count is
    given; with one, it raises."""
    windows = []

    def profiled(fn):
        windows.append(1)
        return _raw_profile(), 4e-3

    monkeypatch.setattr(profiling, "_profiled", profiled)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    out = profiling._profile(lambda: None)
    assert len(windows) == profiling.TRIES
    assert (out["kernels"], out["kernels_lost"]) == (3, 1)
    assert out["device_busy_ms"] == pytest.approx(2e-3)
    assert out["device_idle_share"] == pytest.approx(0.5)
    assert out["ms_by_layer"] == pytest.approx({"geglu_ffn kernel": 1e-3, "matmul (cuBLAS)": 1e-3,
                                                "memory copies": 5e-4})
    assert out["top_kernels"][0]["launches"] == 1
    with pytest.raises(RuntimeError, match="not 3 kernels"):
        profiling._profile(lambda: None, launches=3)
