"""Build and load the port's CUDA kernels.

Each ``mintime_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Libraries land in ``mintime_torch/.build/<name>-<hash>.so``, keyed
on a hash of the source, the headers it includes with ``#include "..."``
(``csrc/warp_mma.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused. :func:`build_all` starts one
``nvcc`` per source, all at once. Nothing here runs at import time: the CPU
tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)
_LIBS: dict[str, ctypes.CDLL] = {}
#: per-source ``nvcc`` output (register and shared-memory use from ``-Xptxas -v``)
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _flags(defines: tuple[str, ...]) -> list[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _sources(path: Path) -> list[Path]:
    """``path`` and every file it includes with ``#include "..."``, in the
    order first met, through includes of includes."""
    found, todo = [], [path]
    while todo:
        p = todo.pop(0)
        if p not in found:
            found.append(p)
            todo += [p.parent / inc for inc in _INCLUDE.findall(p.read_text())]
    return found


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256()
    for src in _sources(CSRC / f"{name}.cu"):
        digest.update(src.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, defines: tuple[str, ...] = ()):
    """Start ``nvcc`` for one source unless its library exists; return
    ``(key, target, tmp, process or None)``."""
    target = _target(name, defines)
    key = name if not defines else f"{name}[{','.join(defines)}]"
    if target.exists():
        return key, target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return key, target, tmp, proc


def _finish(key, target, tmp, proc) -> None:
    if proc is not None:
        out, _ = proc.communicate()
        BUILD_LOG[key] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    _LIBS[key] = ctypes.CDLL(str(target))


def build_all(names=None) -> float:
    """Build (in parallel) and load every kernel library; return seconds taken."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    started = [_start(n) for n in names if n not in _LIBS]
    for job in started:
        _finish(*job)
    return time.perf_counter() - t0


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use;
    ``defines`` builds a variant with those macros set (the probes'
    ablations)."""
    if not defines:
        if name not in _LIBS:
            build_all([name])
        return _LIBS[name]
    job = _start(name, defines)
    if job[0] not in _LIBS:
        _finish(*job)
    return _LIBS[job[0]]


def check(status: int, what: str) -> None:
    """Raise when a C launcher reports a non-zero ``cudaGetLastError()``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
