"""The GEGLU FFN forward and backward, the depthwise forward, the
divided-attention forward and backward, the token-row forward and backward
and the chunked attention of this tree against another checkout's, in
turns, on one card.

Each tree is measured by a process of its own (its ``mintime_torch`` on
``PYTHONPATH``, its kernels built into its own ``mintime_torch/.build/``), in
the order other, this, this, other, so that a drift of the card's clocks
falls on both alike. Without ``--other`` this tree alone is measured, once.
Both trees are measured by this tree's harness: ``chip_smoke.py``'s FFN,
attention and chunked-attention rows, profiler and timers, and the depthwise
probe's ``run``.

For each tree:

  geglu_ffn      at ``chip_smoke.FFN_SHAPES`` (the flagship's token rows
                 D=512 M=6272 and CLS rows M=8, the conv model's D=256
                 M=81920 and M=8): ``chip_smoke._ffn_fwd_row`` (the output
                 against the plain version, device and host ms, PyTorch's
                 three calls by device ms), two reruns bitwise equal or not,
                 and three calls' CUDA launches by name under
                 ``torch.profiler``;
  geglu_ffn_bwd  at ``chip_smoke.FFN_SHAPES`` (widths 512 and 256, the token
                 and CLS rows of a batch of 8): ``chip_smoke._ffn_bwd_row``
                 (each gradient against the plain version, device and host
                 ms), two reruns bitwise equal or not, and three calls'
                 CUDA launches by name under ``torch.profiler``;
  dw_conv        ``dw_conv_cuda_vs_cudnn.run(check=True)``: the probe's
                 eight geometries at 512 images, ms by CUDA events beside
                 cuDNN's ``conv2d(groups=C)`` + ``F.silu``, relative error
                 against the plain version;
  divided_attention  at ``chip_smoke._divided_cases``:
                 ``chip_smoke._divided_fwd_row`` (the outputs against the
                 plain version, the kernel's device and host ms and SDPA's
                 device ms), two reruns bitwise equal or not, and three
                 calls' CUDA launches by name;
  divided_attention_bwd  at ``chip_smoke._divided_cases`` (the flagship's
                 time and space axes at batch 8, the conv model's tap-10
                 time axis and its space axis at L = 80, 112, 192, 256):
                 ``chip_smoke._divided_bwd_row`` (each gradient against the
                 plain version, the kernel's and SDPA's backward by device
                 and host ms), two reruns bitwise equal or not, and three
                 calls' CUDA launches by name under ``torch.profiler``;
  token_rows_attention, token_rows_attention_bwd  at
                 ``chip_smoke.TOKEN_ROWS_CASES`` (the conv time axis G =
                 1280 L = 8, masked G = 96, and G = 96 at L = 33, 49, 64,
                 masked and not): ``chip_smoke._token_rows_row`` and
                 ``_token_rows_bwd_row`` (the output or each gradient against
                 the plain version, the kernel's and SDPA's device and host
                 ms), two reruns bitwise equal or not, and three calls' CUDA
                 launches by name;
  grouped_attention  at the probe rows of ``chip_smoke.py`` (flagship
                 width B = 8, both axes, masked and not) and
                 ``chip_smoke.GROUPED_EDGES``: ``chip_smoke._grouped_row``,
                 two reruns bitwise equal or not, three calls' launches;
  chunked_attention  at ``chip_smoke.CHUNKED_CASES`` (the attention probe's
                 time and space axes at B = 32 and its packing, and the
                 kernel's edges): ``chip_smoke._chunked_row`` (the outputs
                 against the plain version, two reruns bitwise equal or not,
                 the kernel's device and host ms, SDPA's device ms) and three
                 calls' CUDA launches by name. A case that a tree's kernel
                 refuses (the CLS row of an older kernel holds at most 12288
                 keys) gives a row with the error and no times; only this
                 tree's refusals count as failures.

Every row also carries ``digest``, a hash of the bits of one call's
outputs. Both trees draw the same inputs, so with ``--same-bits NAME ...``
the named kernels must give the same digest in every turn of both trees
(a change that must leave their results as they were).

Run on a machine with a card, from the root of a checkout, with another
checkout unpacked in a directory (for example by ``git archive``):
``python -m mintime_torch.experiments.kernel_turns [--other DIR] [--out FILE]
[--kernels NAME ...] [--same-bits NAME ...]``.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # this tree, whose harness measures both
TAG = "kernel_turns "  # prefix of the lines a measuring process prints


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KERNELS = ("geglu_ffn", "geglu_ffn_bwd", "dw_conv", "divided_attention", "divided_attention_bwd",
           "token_rows_attention", "token_rows_attention_bwd", "grouped_attention",
           "chunked_attention")


def _launches(cs, call) -> list:
    """Three calls' CUDA launches by name: [name, launches, ms over the three]."""
    prof = cs._profile(lambda: [call() for _ in range(3)], calls=3)
    return [[k["name"][:60], k["launches"], k["ms"]] for k in prof["top_kernels"]]


def _outputs(call) -> list:
    import torch

    got = call()
    return [got] if isinstance(got, torch.Tensor) else list(got)


def _bitwise(call) -> bool:
    import torch

    first = _outputs(call)
    return all(all(torch.equal(a, b) for a, b in zip(_outputs(call), first)) for _ in range(2))


def _digest(call) -> str:
    """A hash of the bits of one call's outputs."""
    import torch

    h = hashlib.sha256()
    for t in _outputs(call):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(label: str, kernels) -> None:
    """Measure the ``mintime_torch`` this process imports; print one line a row."""
    import torch

    from mintime_torch.experiments import card
    from mintime_torch.experiments import dw_conv_cuda_vs_cudnn as dwf
    from mintime_torch.ops import chunked_attention as ca
    from mintime_torch.ops import divided_attention as da
    from mintime_torch.ops import geglu_ffn as ffn
    from mintime_torch.ops import grouped_attention as ga
    from mintime_torch.ops import token_rows as tr

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    out = lambda row: print(TAG + json.dumps({"tree": label, "card": smi, **row}), flush=True)  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    for dim, hidden, shapes in cs.FFN_SHAPES if "geglu_ffn" in kernels else ():
        w0, b0, w1, b1 = cs._ffn_weights(r, dim, hidden)
        for m, calls, _ in shapes:
            args = (r(m, dim), w0, b0, w1, b1)
            # the other tree's forward may launch another number of kernels a call
            row = cs._ffn_fwd_row(args, calls)
            call = lambda: ffn.geglu_ffn_cuda(*args)  # noqa: E731
            out({"kernel": "geglu_ffn", **row, "bitwise_reruns": _bitwise(call),
                 "digest": _digest(call),
                 "within": row["max_abs_err"] <= cs.TOL, "launches_3_calls": _launches(cs, call)})
            del args
        torch.cuda.empty_cache()
    for dim, hidden, shapes in cs.FFN_SHAPES if "geglu_ffn_bwd" in kernels else ():
        w0, b0, w1, _ = cs._ffn_weights(r, dim, hidden)
        for m, _, calls in shapes:
            args = (r(m, dim), w0, b0, w1, r(m, dim))
            # the other tree's backward may launch another number of kernels a call
            row = cs._ffn_bwd_row(args, calls, launches=None)
            call = lambda: ffn.geglu_ffn_bwd_cuda(*args)  # noqa: E731
            out({"kernel": "geglu_ffn_bwd", **row, "bitwise_reruns": _bitwise(call),
                 "digest": _digest(call),
                 "within": all(g["max_abs_err"] <= g["limit"] for g in row["grads"]),
                 "launches_3_calls": _launches(cs, call)})
            del args
        torch.cuda.empty_cache()
    for row in dwf.run(check=True) if "dw_conv" in kernels else ():
        out({"kernel": "dw_conv", **row, "shape": f"N={row['N']} {row['H']}x{row['W']}"
             f" C={row['C']} K={row['K']}", "within": row["check_rel_err"] <= dwf.CHECK_REL})

    for shape, args, H, calls, _ in cs._divided_cases(gen) if "divided_attention" in kernels else ():
        row = cs._divided_fwd_row(shape, args, H, calls)
        call = lambda: da.divided_attention_cuda(*args, heads=H, dim_head=64)  # noqa: E731
        out({"kernel": "divided_attention", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call),
             "within": row["max_abs_err"] <= cs.TOL, "launches_3_calls": _launches(cs, call)})
        del args
    if "divided_attention_bwd" in kernels:
        for shape, args, H, _, calls in cs._divided_cases(gen):
            # the other tree's backward may launch another number of kernels a call
            row = cs._divided_bwd_row(shape, args, H, calls, gen)
            d_tok = torch.randn(*args[0].shape[:3], H * 64, generator=gen).cuda().bfloat16()
            d_cls = torch.randn(args[0].shape[0], 1, H * 64, generator=gen).cuda().bfloat16()
            call = lambda: da.divided_attention_bwd_cuda(*args, d_tok, d_cls, heads=H,  # noqa: E731
                                                         dim_head=64)
            out({"kernel": "divided_attention_bwd", **row, "bitwise_reruns": _bitwise(call),
                 "digest": _digest(call),
                 "within": all(g["max_abs_err"] <= g["limit"] for g in row["grads"])
                 and row["d_qkv_differing"] <= row["differing_limit"],
                 "launches_3_calls": _launches(cs, call)})
            del args, d_tok, d_cls

    # the other tree's token-row kernels may launch another number of kernels a call
    for case in cs.TOKEN_ROWS_CASES if "token_rows_attention" in kernels else ():
        row = cs._token_rows_row(case, gen)
        qkv, qkvc, sb = cs._token_rows_inputs(gen, case[0], case[2], F=case[1])
        call = lambda: tr.token_rows_attention_cuda(qkv, qkvc, sb, heads=6, dim_head=64)  # noqa: E731
        out({"kernel": "token_rows_attention", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call),
             "within": row["max_abs_err"] <= cs.TOL, "launches_3_calls": _launches(cs, call)})
        del qkv, qkvc, sb
    for case in cs.TOKEN_ROWS_CASES if "token_rows_attention_bwd" in kernels else ():
        row = cs._token_rows_bwd_row(case, gen)
        args = cs._token_rows_bwd_inputs(gen, case)
        call = lambda: tr.token_rows_attention_bwd_cuda(*args, heads=6, dim_head=64)  # noqa: E731
        out({"kernel": "token_rows_attention_bwd", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call),
             "within": all(g["max_abs_err"] <= g["limit"] for g in row["grads"]),
             "launches_3_calls": _launches(cs, call)})
        del args

    grouped = [((G, L, masked), "", 1) for G, L in ((49, 16), (16, 49))
               for masked in (True, False)]
    grouped += [(edge, "edge ", 0) for edge in cs.GROUPED_EDGES]
    edge_gen = torch.Generator().manual_seed(12)
    for shape, tag, calls in grouped if "grouped_attention" in kernels else ():
        if tag:
            args, mask = cs._grouped_edge_inputs(edge_gen, *shape)
        else:
            args, mask = cs._grouped_inputs(gen, *shape)
        row = cs._grouped_row(args, mask, 8, calls, tag)
        call = lambda: ga.fused_grouped_attention_cuda(*args, heads=8)  # noqa: E731
        out({"kernel": "grouped_attention", **row, "bitwise_reruns": _bitwise(call),
             "digest": _digest(call), "within": row["max_abs_err"] <= cs.TOL,
             "launches_3_calls": _launches(cs, call)})
        del args, mask

    for case in cs.CHUNKED_CASES if "chunked_attention" in kernels else ():
        try:
            row = cs._chunked_row(case)
        except (ValueError, RuntimeError) as e:  # a kernel that does not take the shape
            _, G, L, P, B = case[:5]
            out({"kernel": "chunked_attention", "shape": f"{case[0]} B={B} G={G} L={L} P={P}",
                 "refused": str(e)[:200], "within": label != "this"})
            continue
        args, kw = cs._chunked_inputs(case)
        call = lambda: ca.chunked_attention_cuda(*args, **kw)  # noqa: E731
        out({"kernel": "chunked_attention", **row, "digest": _digest(call),
             "within": row["max_abs_err"] <= row["limit"],
             "launches_3_calls": _launches(cs, call)})
        del args
        torch.cuda.empty_cache()


def _run_tree(root: Path, label: str, kernels) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", label,
                           "--kernels", *kernels],
                          cwd=root, env=env, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} ({root}) failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rows = [json.loads(ln[len(TAG):]) for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
    print(f"{label}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of another checkout to measure in turns")
    ap.add_argument("--out", type=Path, help="write every row here as JSON lines")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the kernels to measure (default: all)")
    ap.add_argument("--same-bits", nargs="+", choices=KERNELS, default=[],
                    help="kernels whose outputs must keep their bits in every turn of both trees")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure, args.kernels)
        return
    order = [("this", ROOT)] if args.other is None else [
        ("other", args.other.resolve()), ("this", ROOT), ("this", ROOT), ("other", args.other.resolve())]
    rows, failed = [], []
    for turn, (label, root) in enumerate(order):
        try:
            rows += [dict(r, turn=turn) for r in _run_tree(root, label, args.kernels)]
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            print(e, flush=True)
            failed.append(turn)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    bad = [r for r in rows if not r["within"] or r.get("bitwise_reruns") is False]
    digests = collections.defaultdict(set)
    for r in rows:
        if r["kernel"] in args.same_bits:
            digests[r["kernel"], r["shape"]].add(r.get("digest"))
    changed = sorted(k for k, d in digests.items() if len(d) > 1)
    for kernel, shape in changed:
        print(f"{kernel} {shape}: other bits in another turn or tree", flush=True)
    for r in rows:
        if "refused" in r:
            print(f"turn {r['turn']} {r['tree']:5s} {r['kernel']:24s} {r['shape']:40s}"
                  f" refused: {r['refused']}")
            continue
        print(f"turn {r['turn']} {r['tree']:5s} {r['kernel']:24s} {r['shape']:40s} ms {r['ms']:.4f}"
              + (f" host_ms {r['host_ms']:.4f}" if "host_ms" in r else "")
              + (f" library_ms {r['library_ms']:.4f}" if r.get("library_ms") else "")
              + (f" cublas_products_ms {r['cublas_products_ms']:.4f}"
                 if "cublas_products_ms" in r else "")
              + ("" if r["within"] else " OFF")
              + (" NOT-BITWISE" if r.get("bitwise_reruns") is False else ""))
        if "launches_3_calls" in r:
            print("    " + "; ".join(f"{n} x{k} {ms:.4f}" for n, k, ms in r["launches_3_calls"]))
    if args.same_bits:
        print(f"same bits in every turn: {len(digests) - len(changed)} of {len(digests)} shapes of"
              f" {', '.join(args.same_bits)}", flush=True)
    if bad or failed or changed:
        raise SystemExit(f"{len(bad)} rows off their limits or not bitwise on reruns;"
                         f" {len(changed)} shapes whose bits changed; turns that failed: {failed}")


if __name__ == "__main__":
    main()
