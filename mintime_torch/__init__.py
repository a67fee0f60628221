"""MINTIME in PyTorch, with hand-written CUDA kernels for Hopper.

A second package beside :mod:`mintime_tpu`, which stays the numerics
reference. This package never imports JAX, Flax or :mod:`mintime_tpu`: the
host-side helpers it needs are copied into it.

Device policy: every entry point takes an explicit ``device`` that defaults
to ``"cuda"``; without a card that default raises instead of falling back to
the CPU (see :func:`mintime_torch.device.resolve_device`). Compute runs in
bf16 on the card and in fp32 on the CPU.
"""
