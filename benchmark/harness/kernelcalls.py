"""Each hand-written kernel's calls in a traced window, with the operations
and bytes that its shapes need: every ``benchmark/kernels/<name>.py`` names
the program's launcher (``MODULE``, ``FUNCTION``), the device kernels that a
call runs (``KERNELS``) and ``work(args, kwargs, out) -> (flops, bytes)``.
While :func:`recording` is open, each launcher is wrapped to note its calls."""

from __future__ import annotations

import contextlib
import importlib

from harness import files


def specs() -> dict:
    return files.modules("kernels")


@contextlib.contextmanager
def recording():
    """Yields the list that collects ``(kernel file, flops, bytes)`` a call."""
    calls, undo = [], []
    for name, spec in specs().items():
        mod = importlib.import_module(spec.MODULE)
        orig = getattr(mod, spec.FUNCTION)

        def wrapped(*args, _o=orig, _n=name, _s=spec, **kwargs):
            out = _o(*args, **kwargs)
            calls.append((_n, *_s.work(args, kwargs, out)))
            return out

        setattr(mod, spec.FUNCTION, wrapped)
        undo.append((mod, spec.FUNCTION, orig))
    try:
        yield calls
    finally:
        for mod, fn, orig in undo:
            setattr(mod, fn, orig)


def is_handwritten(kernel_name: str, table: dict | None = None) -> bool:
    table = specs() if table is None else table
    return any(k in kernel_name for s in table.values() for k in s.KERNELS)


def nbytes(*tensors) -> int:
    """Bytes of each tensor's logical elements, read or written once."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total
