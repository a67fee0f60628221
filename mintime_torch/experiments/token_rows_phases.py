"""Where the token-row tile launches spend their time: the forward and the
backward at the Convolutional TimeSformer's time axis (B = 8 videos, G = 1280
channel groups of L = 8 frames, 6 heads of 64), each whole and with phases
cut, by device time.

A launch of ``csrc/token_rows_attention{,_bwd}.cu`` at L <= 16 has three
phases a run of groups: the 16-byte copies of its token rows into shared
memory, the products of its warps (softmax, mma, the results written back
into the tiles) and the 16-byte stores of its output rows. Each variant is a
copy of the two sources and ``csrc/token_rows_tile.cuh`` with some of those
statements guarded off (``CUTS``), compiled with the port's nvcc flags into
``mintime_torch/.build/phases/``; what a variant computes is wrong by design
and is not checked. A phase alone, against the whole launch, says how far
the phases overlap: the whole takes their sum where they do not.

Times are ``chip_smoke.device_ms`` (the kernels' durations under
``torch.profiler``), so the host's issue rate does not enter.

Run on a machine with a card, from the root of a checkout:
``python -m mintime_torch.experiments.token_rows_phases``.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from mintime_torch.experiments import card, require_card
from mintime_torch.experiments.kernel_turns import _chip_smoke
from mintime_torch.ops import _build
from mintime_torch.ops import token_rows as tr

SOURCES = ("token_rows_attention", "token_rows_attention_bwd")
#: phase -> (file, statement as it stands, the same statement guarded off)
CUTS = {
    "copies": ("token_rows_tile.cuh", "        warp_mma::cp_async16_zfill(",
               "        if (w < 0) warp_mma::cp_async16_zfill("),
    "stores": ("token_rows_tile.cuh",
               "        *reinterpret_cast<uint4*>(orow + o * inner + w * 8) =",
               "        if (w < 0) *reinterpret_cast<uint4*>(orow + o * inner + w * 8) ="),
    "products": (None, "if (hh < k.heads) {  // warp-uniform", "if (hh < 0) {  // warp-uniform"),
}
#: variant -> the phases it cuts
VARIANTS = {"whole": (), "no_copies": ("copies",), "no_products": ("products",),
            "no_stores": ("stores",), "copies_only": ("products", "stores"),
            "products_only": ("copies", "stores"), "stores_only": ("copies", "products")}


def _build_variants() -> dict:
    """Compile every variant of both sources (one nvcc each, all at once);
    return variant -> source -> loaded library."""
    root = _build.BUILD_DIR / "phases"
    jobs = []
    for variant, cut in VARIANTS.items():
        d = root / variant
        d.mkdir(parents=True, exist_ok=True)
        texts = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
        for phase in cut:
            file, old, new = CUTS[phase]
            for name in [file] if file else [f"{s}.cu" for s in SOURCES]:
                if old not in texts[name]:
                    raise RuntimeError(f"{name} no longer holds {old!r}: update CUTS")
                texts[name] = texts[name].replace(old, new)
        for name, text in texts.items():
            (d / name).write_text(text)
        for src in SOURCES:
            out = d / f"{src}.so"
            cmd = [_build._nvcc(), *_build._flags(()), "-o", str(out), str(d / f"{src}.cu")]
            jobs.append((variant, src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                             stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, src, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}/{src}:\n{log}")
        libs.setdefault(variant, {})[src] = ctypes.CDLL(str(out))
    return libs


def run(device="cuda") -> list[dict]:
    """One row a variant: the forward's and the backward's device ms a call."""
    require_card(device)
    cs = _chip_smoke()
    libs = _build_variants()
    gen = torch.Generator().manual_seed(0)
    qkv, qkvc, sb, d_tok = cs._token_rows_bwd_inputs(gen, cs.TOKEN_ROWS_CASES[0])
    kw = dict(heads=6, dim_head=64)
    launches = tr.plan(*qkv.shape[:3], 6)
    rows = []
    saved = {s: _build.load(s) for s in SOURCES}
    try:
        for variant in VARIANTS:
            _build._LIBS.update(libs[variant])
            rows.append({
                "variant": variant, "cuts": list(VARIANTS[variant]),
                "fwd_ms": cs.device_ms(lambda: tr.token_rows_attention_cuda(qkv, qkvc, sb, **kw),
                                       launches=launches["fwd_launches"]),
                "bwd_ms": cs.device_ms(
                    lambda: tr.token_rows_attention_bwd_cuda(qkv, qkvc, sb, d_tok, **kw),
                    launches=launches["bwd_launches"])})
    finally:
        _build._LIBS.update(saved)
    return rows


def main() -> None:
    rows = run()
    print(f"token-row tile launches, B=8 G=1280 L=8 H=6 dh=64, device ms a call ({card()})")
    for r in rows:
        print(f"  {r['variant']:14s} forward {r['fwd_ms']:.4f}  backward {r['bwd_ms']:.4f}")


if __name__ == "__main__":
    main()
