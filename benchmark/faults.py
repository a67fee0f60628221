"""Faults planted under the timed path, for the checks that ``correct``
comes out false (``tests/test_bench_faults.py``, ``control.py``). The
benchmark's own runs plant none."""

from __future__ import annotations


def plant(system, fault: str | None):
    """Wrap a serving or training system's entry with ``fault``."""
    if fault is None:
        return system
    if fault == "unchanged":  # a step that returns its state unchanged
        import torch

        step = system.step

        def unchanged(batch):
            before = {k: v.detach().clone() for k, v in system.params().items()}
            loss = step(batch)
            with torch.no_grad():
                for k, v in system.params().items():
                    v.copy_(before[k])
            return loss
        system.step = unchanged
    elif fault == "half_batch":  # half of the batch left out, the mean over the rest
        step = system.step

        def half(batch):
            n = len(batch["labels"]) // 2
            return step({k: v[:n] for k, v in batch.items()})
        system.step = half
    elif fault == "altered":  # an answer altered where it is produced
        predict = system.predict

        def altered(items):
            out = predict(items)
            p, *rest = out[0]
            out[0] = (p + 0.25 if p < 0.5 else p - 0.25, *rest)
            return out
        system.predict = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return system
