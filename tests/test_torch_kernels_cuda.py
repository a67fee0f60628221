"""CUDA kernels against their plain versions on the card, in bf16 at the
flagship shapes, max abs error 2e-2. These need an NVIDIA GPU (a CUDA kernel
has no CPU mode) and skip without one; on a machine with a card run
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``. The file
imports no JAX, so it runs where JAX is not installed.
"""

import pytest
import torch

from mintime_torch.ops import divided_attention as port_divided
from mintime_torch.ops import geglu_ffn as port


@pytest.mark.cuda
def test_geglu_kernel_on_card():
    """The CUDA kernel against its plain version in bf16 (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.05).cuda().bfloat16()
    w0, b0, w1, b1 = r(4096, 512), r(4096), r(512, 2048), r(512)
    for m in (6272, 8, 37):
        x = r(m, 512) * 20
        torch.testing.assert_close(port.geglu_ffn_cuda(x, w0, b0, w1, b1).float(),
                                   port.geglu_ffn_plain(x, w0, b0, w1, b1).float(),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_divided_attention_kernel_on_card():
    """The CUDA kernel against its plain version in bf16 (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    B, G, L, H, dh = 2, 16, 49, 8, 64
    qkv = torch.randn(B, G, L, 3 * H * dh, generator=gen).cuda().bfloat16()
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    rb = torch.zeros(B, G, 1, device="cuda")
    rb[1, 12:] = port_divided.NEG
    got = port_divided.divided_attention_cuda(qkv, qkvc, None, rb, heads=H, dim_head=dh)
    want = port_divided.divided_attention_plain(qkv, qkvc, None, rb, heads=H, dim_head=dh)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
