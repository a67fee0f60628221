"""Host-side C for the MTCNN cascade's greedy NMS (``nms.c``, a copy of the
JAX package's source).

The suppression recurrence is the host's hot loop under candidate load: a
few thousand calls a video, each over up to a few hundred boxes. ``nms.c``
runs it in the boxes' own dtype (f32 and f64 entry points) and gives the
same keep sets as :func:`greedy_nms_numpy`, the plain version that the tests
hold it against.

Build: at the first call, ``gcc -O2 -shared -fPIC`` compiles ``nms.c`` into
``mintime_torch/.build/nms-<hash>.so`` (keyed on a hash of the source) and
``ctypes`` loads it. A failed build raises with gcc's output: the cascade
never falls back to the numpy loop in silence. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "nms.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the shared library for this ``nms.c`` lives once built."""
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"nms-{tag}.so"


def load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if gcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        gcc = shutil.which("gcc")
        if gcc is None:
            raise RuntimeError("gcc not found: the native NMS (mintime_torch/native/nms.c) "
                               "is compiled at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gcc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"gcc failed to build {SRC.name} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)  # atomic when two processes build at once
    lib = ctypes.CDLL(str(so))
    for name, real in (("nms_greedy_f32", ctypes.c_float), ("nms_greedy_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [
            ctypes.c_void_p,  # boxes (n, 4) contiguous
            ctypes.c_void_p,  # order, int64 (overwritten: suppressed -> -1)
            ctypes.c_long,  # n
            real,  # threshold
            ctypes.c_int,  # method_min
            ctypes.c_int,  # plus_one
            ctypes.c_void_p,  # keep_out, int64
        ]
    _lib = lib
    return lib


def greedy_nms(boxes: np.ndarray, order: np.ndarray, threshold: float, method_min: bool,
               plus_one: bool) -> np.ndarray:
    """Greedy suppression in C. ``boxes`` is ``(n, >=4)`` float32 or float64;
    ``order`` the traversal order (the caller's argsort, whose tie rule is
    part of its contract), never mutated. A box is dropped when its overlap
    with a kept one is above ``threshold`` or NaN; the overlap is IoU, or
    intersection over the smaller area with ``method_min``, with MATLAB's
    +1 areas when ``plus_one``. Returns the kept indices in traversal
    order."""
    fns = {np.float32: "nms_greedy_f32", np.float64: "nms_greedy_f64"}
    if boxes.dtype.type not in fns:
        raise TypeError(f"boxes must be float32 or float64, got {boxes.dtype}")
    n = len(order)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    fn = getattr(load(), fns[boxes.dtype.type])
    boxes = np.ascontiguousarray(boxes[:, :4])
    work = np.array(order, dtype=np.int64)  # a copy: the C loop overwrites it
    if work.min() < 0 or work.max() >= len(boxes):
        raise IndexError("order holds an index outside boxes")
    keep = np.empty(n, dtype=np.int64)
    kept = fn(boxes.ctypes.data, work.ctypes.data, n, boxes.dtype.type(threshold),
              int(method_min), int(plus_one), keep.ctypes.data)
    return keep[:kept]


def greedy_nms_numpy(boxes: np.ndarray, order: np.ndarray, threshold: float,
                     method_min: bool, plus_one: bool) -> np.ndarray:
    """The plain version of :func:`greedy_nms`: the same recurrence in numpy,
    element for element as ``nms.c`` computes it (a comparison with a NaN
    picks the second operand, as C's ``a < b ? a : b`` does)."""
    n = len(order)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    dt = boxes.dtype.type
    one = dt(1) if plus_one else dt(0)
    x1, y1, x2, y2 = (boxes[:, c] for c in range(4))
    area = (x2 - x1 + one) * (y2 - y1 + one)
    order = np.asarray(order, dtype=np.int64)
    keep = []
    while order.size:
        i, rest = order[0], order[1:]
        keep.append(i)
        xx1 = np.where(x1[i] > x1[rest], x1[i], x1[rest])
        yy1 = np.where(y1[i] > y1[rest], y1[i], y1[rest])
        xx2 = np.where(x2[i] < x2[rest], x2[i], x2[rest])
        yy2 = np.where(y2[i] < y2[rest], y2[i], y2[rest])
        w = xx2 - xx1 + one
        h = yy2 - yy1 + one
        w = np.where(w < 0, dt(0), w)
        h = np.where(h < 0, dt(0), h)
        inter = w * h
        if method_min:
            denom = np.where(area[i] < area[rest], area[i], area[rest])
        else:
            denom = area[i] + area[rest] - inter
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            o = inter / denom
        order = rest[o <= dt(threshold)]
    return np.asarray(keep, dtype=np.int64)
