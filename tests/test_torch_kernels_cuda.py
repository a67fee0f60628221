"""CUDA kernels against their plain versions on the card, in bf16 at the
flagship shapes and at the Convolutional TimeSformer's (the FFN at width 256,
the token rows), max abs error 2e-2, the probes' kernels (grouped and
chunked attention, depthwise conv forward and weight gradient), and
Xception's depthwise 3 x 3 kernel with its dispatch and launch counter; the
CUDA launches a call under ``torch.profiler``, and reruns bitwise equal.
These need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip without
one; on a machine with a card run
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``. The file
imports no JAX, so it runs where JAX is not installed. Kernel times are
``mintime_torch.experiments.kernel_turns``'.
"""

import pytest
import torch

from mintime_torch.ops import chunked_attention as port_chunked
from mintime_torch.ops import divided_attention as port_divided
from mintime_torch.ops import dw_conv as port_dw
from mintime_torch.ops import geglu_ffn as port
from mintime_torch.ops import grouped_attention as port_grouped
from mintime_torch.ops import token_rows as port_rows
from mintime_torch.utils import profiling


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


def _flagship_axis(axis, gen, B=2, F=16, n=49, H=8, dh=64):
    """One flagship axis with masked frames: qkv (a strided view on the time
    axis), its CLS row, the seq_bias of the time axis' frame mask, the
    CLS-row bias, and unit-scale cotangents in qkv's stride order."""
    qkv = torch.randn(B, F, n, 3 * H * dh, generator=gen).cuda().bfloat16()
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    mask = torch.ones(B, F, dtype=torch.bool, device="cuda")
    mask[1, 10:] = False
    rb = port_divided.mask_to_bias(mask)
    if axis == "time":
        frame = torch.cat([torch.ones(B, F, 1, dtype=torch.bool, device="cuda"),
                           mask[:, None, :].expand(B, F, F)], dim=-1)
        args = (qkv.transpose(1, 2), qkvc, port_divided.mask_to_bias(frame), rb[:, None, :])
    else:
        args = (qkv, qkvc, None, rb[:, :, None])
    G, L = args[0].shape[1:3]
    d_tok = torch.randn(B, L, G, H * dh, generator=gen).cuda().bfloat16().transpose(1, 2) \
        if axis == "time" else torch.randn(B, G, L, H * dh, generator=gen).cuda().bfloat16()
    d_cls = torch.randn(B, 1, H * dh, generator=gen).cuda().bfloat16()
    return args, (d_tok, d_cls), dict(heads=H, dim_head=dh)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("axis", ["time", "space"])
def test_divided_attention_kernel_on_card(axis, heads):
    """The CUDA kernel against its plain version in bf16 on both flagship
    axes with masked frames, at the flagship's 8 heads and a TP=2 model
    rank's 4, max abs error 2e-2 (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args, _, kw = _flagship_axis(axis, torch.Generator().manual_seed(0), H=heads)
    got = port_divided.divided_attention_cuda(*args, **kw)
    want = port_divided.divided_attention_plain(*args, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
    _within(got, want)


def _close_per_gradient(got, want, what):
    """max |kernel - plain| <= 2e-2 * max(1, max |plain|), one gradient at a time."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = float((a - b).abs().max())
        limit = 2e-2 * max(1.0, float(b.abs().max()))
        assert err <= limit, f"{what} gradient {i}: max abs error {err} > {limit}"


def _within(got, want, limit=2e-2):
    """max |kernel - plain| <= ``limit`` over every output."""
    for a, b in zip(got, want) if isinstance(got, (tuple, list)) else ((got, want),):
        err = float((a.float() - b.float()).abs().max())
        assert err <= limit, f"max abs error {err} > {limit}"


def _launches_a_call(call, n):
    """The profiler sees ``n`` CUDA launches in one ``call()`` (a window that
    lost a record is profiled again; ``_profile`` raises after its tries)."""
    assert profiling._profile(call, launches=n)["kernels"] == n


@pytest.mark.cuda
def test_geglu_backward_kernel_on_card():
    """The backward kernel against its plain version in bf16 at the token and
    CLS rows of a batch of 8 and a ragged M (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(1)
    r = lambda *s, sc=0.05: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    w0, b0, w1 = r(4096, 512), r(4096), r(512, 2048)
    for m in (6272, 8, 37):
        x, dout = r(m, 512, sc=1.0), r(m, 512, sc=0.1)
        got = port.geglu_ffn_bwd_cuda(x, w0, b0, w1, dout)
        torch.cuda.synchronize()
        _close_per_gradient(got, port.geglu_ffn_bwd_plain(x, w0, b0, w1, dout), f"ffn M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("axis", ["time", "space"])
def test_divided_attention_backward_kernel_on_card(axis, heads):
    """The backward kernel against its plain version in bf16 on both flagship
    axes at 8 heads and a TP=2 model rank's 4, with masked frames, a strided
    time-axis view and d_qkv in its stride order; under 5% of d_qkv's bf16
    values differ from the plain version's; six CUDA launches a call (the
    CLS row's logits, chunk sums and finish, the token rows' row and column
    launches, the reduce) (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args, cots, kw = _flagship_axis(axis, torch.Generator().manual_seed(2), H=heads)
    got = port_divided.divided_attention_bwd_cuda(*args, *cots, **kw)
    torch.cuda.synchronize()
    assert got[0].stride() == args[0].stride()
    want = port_divided.divided_attention_bwd_plain(*args, *cots, **kw)
    _close_per_gradient(got, want, f"attention {axis} heads={heads}")
    assert float((got[0] != want[0]).float().mean()) < 0.05
    _launches_a_call(lambda: port_divided.divided_attention_bwd_cuda(*args, *cots, **kw), 6)


@pytest.mark.cuda
def test_geglu_kernels_on_card_at_width_256():
    """Both FFN kernels at the Convolutional TimeSformer's width 256 (hidden
    1024) against their plain versions, at its token rows of one video, its
    CLS rows and a ragged M (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(3)
    r = lambda *s, sc=0.05: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    w0, b0, w1, b1 = r(2048, 256, sc=0.0625), r(2048), r(256, 1024, sc=0.031), r(256)
    for m in (8 * 1280, 8, 37):
        x, dout = r(m, 256, sc=1.0), r(m, 256, sc=1.0)
        torch.testing.assert_close(port.geglu_ffn_cuda(x, w0, b0, w1, b1).float(),
                                   port.geglu_ffn_plain(x, w0, b0, w1, b1).float(),
                                   atol=2e-2, rtol=2e-2)
        got = port.geglu_ffn_bwd_cuda(x, w0, b0, w1, dout)
        torch.cuda.synchronize()
        _close_per_gradient(got, port.geglu_ffn_bwd_plain(x, w0, b0, w1, dout), f"ffn256 M={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_token_rows_kernels_on_card(masked):
    """The token-row kernels, forward and backward, against their plain
    versions on the strided time-axis view of the Convolutional TimeSformer
    (G = 1280 channel groups of L = 8 frames, 6 heads of 64) and, with a
    seq_bias that masks frames, at G = 96 (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(4)
    B, F, G, H, dh = 2, 8, (96 if masked else 1280), 6, 64
    qkv = torch.randn(B, F, G, 3 * H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    sb = None
    if masked:
        mask = torch.ones(B, F, dtype=torch.bool)
        mask[1, 5:] = False
        frame = torch.cat([torch.ones(B, F, 1, dtype=torch.bool), mask[:, None, :].expand(B, F, F)],
                          dim=-1)
        sb = port_divided.mask_to_bias(frame.cuda())
    kw = dict(heads=H, dim_head=dh)
    got = port_rows.token_rows_attention_cuda(qkv, qkvc, sb, **kw)
    assert got.stride() == port_rows._empty_grouped(qkv, H * dh).stride()
    want = port_rows.token_rows_attention_plain(qkv, qkvc, sb, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    _within(got, want)
    d_tok = torch.randn(B, F, G, H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
    got = port_rows.token_rows_attention_bwd_cuda(qkv, qkvc, sb, d_tok, **kw)
    torch.cuda.synchronize()
    assert got[0].stride() == qkv.stride()
    assert not got[1][..., :H * dh].any()
    _close_per_gradient(got, port_rows.token_rows_attention_bwd_plain(qkv, qkvc, sb, d_tok, **kw),
                        f"token rows G={G}")


@pytest.mark.cuda
@pytest.mark.parametrize("G,L,masked", [(49, 16, True), (16, 49, True), (49, 16, False),
                                      (16, 49, False)])
def test_grouped_attention_kernel_on_card(G, L, masked):
    """The v1 grouped-attention kernel against its plain version in bf16 at
    flagship width (8 heads of 64) on both axes, with and without a key
    mask, max abs error 2e-2 (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(5)
    B, H, D = 2, 8, 64
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.5).cuda().bfloat16()  # noqa: E731
    q, k, v, kc, vc = r(B, H, G, L, D), r(B, H, G, L, D), r(B, H, G, L, D), r(B, H, 1, D), r(B, H, 1, D)
    bias = None
    if masked:
        keep = torch.rand(B, L, 1 + L, generator=gen) > 0.3
        keep[..., 0] = True
        bias = port_grouped.mask_to_bias(keep.cuda())
    got = port_grouped.fused_grouped_attention_cuda(q, k, v, kc, vc, bias, heads=H)
    want = port_grouped.fused_grouped_attention_plain(q, k, v, kc, vc, bias, heads=H)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    _within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G,L,D,masked", [(8, 1, 64, False), (8, 17, 64, True),
                                          (8, 33, 64, False), (4, 64, 64, True),
                                          (16, 49, 30, True)])
def test_grouped_attention_kernel_on_card_at_edges(G, L, D, masked):
    """The grouped-attention kernel at its edges: one key, one row past a
    16-row tile, the longest group, a head width that is no multiple of 8
    (staged by 4-byte loads), and masks that drop every token key of some
    rows (the CLS key kept), against its plain version in bf16, max abs
    error 2e-2 (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(6)
    B, H = 2, 8
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.5).cuda().bfloat16()  # noqa: E731
    q, k, v, kc, vc = r(B, H, G, L, D), r(B, H, G, L, D), r(B, H, G, L, D), r(B, H, 1, D), r(B, H, 1, D)
    bias = None
    if masked:
        keep = torch.rand(B, L, 1 + L, generator=gen) > 0.3
        keep[..., 0] = True
        keep[0, ::3, 1:] = False
        bias = port_grouped.mask_to_bias(keep.cuda())
    got = port_grouped.fused_grouped_attention_cuda(q, k, v, kc, vc, bias, heads=H)
    want = port_grouped.fused_grouped_attention_plain(q, k, v, kc, vc, bias, heads=H)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    _within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G,L", [(49, 16), (16, 49)])
def test_grouped_attention_kernel_is_bitwise_stable(G, L):
    """The grouped kernel gives the same bits on reruns: each output is
    written once, with no atomics (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(7)
    r = lambda *s: (torch.randn(*s, generator=gen) * 0.5).cuda().bfloat16()  # noqa: E731
    B, H, D = 2, 8, 64
    args = (r(B, H, G, L, D), r(B, H, G, L, D), r(B, H, G, L, D), r(B, H, 1, D), r(B, H, 1, D),
            port_grouped.mask_to_bias((torch.rand(B, L, 1 + L, generator=gen) > 0.3).cuda()))
    first = port_grouped.fused_grouped_attention_cuda(*args, heads=H)
    for _ in range(2):
        assert torch.equal(port_grouped.fused_grouped_attention_cuda(*args, heads=H), first)


@pytest.mark.cuda
@pytest.mark.parametrize("G,L,P,masked_row", [(49, 16, 4, False), (16, 49, 2, False),
                                              (49, 16, 8, False), (7, 5, 3, False),
                                              (13, 16, 4, False), (10, 13, 3, False),
                                              (112, 128, 1, False), (16, 49, 2, True)])
def test_chunked_attention_kernel_on_card(G, L, P, masked_row):
    """The chunked-dense kernel against its plain version in bf16 on both
    flagship geometries, at the packings the probe uses and at its edges: G
    no multiple of P, odd L padded to Lp > L, a tile of 128 rows, more
    CLS-row keys than the parent kernel's one-block CLS row held (G*L =
    14336 > 12288), and a video whose token keys are all masked but the CLS
    key; max |kernel - plain| <= 2e-2 * max(1, max |plain|) besides (2e-2 at
    the probe's packings of the two axes), and two reruns give the same bits
    (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(6)
    B, H, dh = 2, 8, 64
    qkv = torch.randn(B, G, L, 3 * H * dh, generator=gen).cuda().bfloat16()
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    sb = port_divided.mask_to_bias((torch.rand(B, L, 1 + L, generator=gen) > 0.1).cuda())
    rb = port_divided.mask_to_bias((torch.rand(B, 1, L, generator=gen) > 0.1).cuda())
    if masked_row:
        sb[0, :, 0], sb[0, :, 1:] = 0.0, port_divided.NEG
        rb[0] = port_divided.NEG
    kw = dict(heads=H, dim_head=dh, P=P)
    got = port_chunked.chunked_attention_cuda(qkv, qkvc, sb, rb, **kw)
    want = port_chunked.chunked_attention_plain(qkv, qkvc, sb, rb, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
    _close_per_gradient(got, want, f"chunked_attention G={G} L={L} P={P}")
    if (G, L, P) in ((49, 16, 4), (16, 49, 2)) and not masked_row:
        _within(got, want)
    for _ in range(2):
        again = port_chunked.chunked_attention_cuda(qkv, qkvc, sb, rb, **kw)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,K", [(112, 112, 32, 3), (14, 14, 672, 5), (9, 7, 17, 3),
                                     (7, 7, 150, 5), (56, 56, 144, 3), (28, 28, 144, 5),
                                     (7, 7, 1152, 5), (7, 7, 1152, 3), (10, 9, 24, 5),
                                     (28, 28, 240, 5), (14, 14, 480, 3), (14, 14, 480, 5)])
def test_dw_conv_kernels_on_card(H, W, C, K):
    """The depthwise forward (+bias+SiLU) and weight-gradient kernels against
    their plain versions in bf16, at the dw probes' geometries (every
    stride-1 depthwise layer of EfficientNet-B0), with even and odd C and a
    ragged channel tile; the weight gradient bitwise equal on a rerun (needs
    the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(7)
    N = 4
    x = torch.randn(N, H, W, C, generator=gen).cuda().bfloat16()
    dy = torch.randn(N, H, W, C, generator=gen).cuda().bfloat16()
    w = (torch.randn(K, K, C, generator=gen) * 0.1).cuda()
    b = (torch.randn(C, generator=gen) * 0.1).cuda()
    got = port_dw.dw_conv_bias_silu_cuda(x, w, b, K=K).float()
    want = port_dw.dw_conv_bias_silu_plain(x, w, b, K=K).float()
    assert float((got - want).abs().max()) <= 2e-2 * max(1.0, float(want.abs().max()))
    got = port_dw.dw_conv_wgrad_cuda(x, dy, K=K)
    want = port_dw.dw_conv_wgrad_plain(x, dy, K=K)
    assert got.shape == (K, K, 1, C) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert torch.equal(port_dw.dw_conv_wgrad_cuda(x, dy, K=K), got)


#: Xception's depthwise shapes at 224 px (the probe ``dw_conv3x3_cuda_vs_cudnn``'s
#: GEOMS, repeated here: this file imports no experiment), and ragged ones
#: that the shape rule admits (7 columns or more, C a multiple of 8)
XC_DW_SHAPES = [(109, 109, 64), (109, 109, 128), (55, 55, 128), (55, 55, 256), (28, 28, 256),
                (28, 28, 728), (14, 14, 728), (7, 7, 1024), (7, 7, 1536), (9, 10, 16), (6, 8, 48)]


def _xc_dw_inputs(H, W, C, n=3, seed=11):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, H, W, C, generator=gen).cuda().bfloat16().permute(0, 3, 1, 2)
    w = (torch.randn(C, 1, 3, 3, generator=gen) * 0.3).cuda().bfloat16()
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("H,W,C", XC_DW_SHAPES)
def test_dw_conv3x3_kernel_on_card(H, W, C, relu):
    """Xception's plain 3 x 3 kernel against its plain version, every output
    within one bf16 rounding of the fp32 sum (the kernel rounds once) and of
    the largest output of the plain version in bf16, reruns bitwise equal,
    the output channels-last like x (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, w = _xc_dw_inputs(H, W, C)
    got = port_dw.dw_conv3x3_cuda(x, w, relu=relu)
    want = port_dw.dw_conv3x3_plain(x.float(), w, relu=relu)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - want).abs()
    assert bool((err <= want.abs() * 2 ** -7 + 1e-5 * float(want.abs().max())).all()), \
        float(err.max())
    # against the plain version in bf16 (each rounds one fp32 sum): within one
    # bf16 rounding of the largest output
    plain = port_dw.dw_conv3x3_plain(x, w, relu=relu).float()
    assert float((got.float() - plain).abs().max()) <= 2 ** -7 * float(plain.abs().max())
    for _ in range(2):
        assert torch.equal(port_dw.dw_conv3x3_cuda(x, w, relu=relu), got)


@pytest.mark.cuda
def test_dw_conv3x3_dispatch_on_card():
    """The kernel path in inference (grad off, or nothing requires grad),
    cuDNN when a gradient is wanted, when the module's ``use_kernels`` is off
    or the shape rule refuses the shape, with the same result; the launch
    counter counts the kernel's call alone (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from mintime_torch.models.xception import SeparableConv

    sep = SeparableConv(128, 128, use_kernels=True).cuda().bfloat16()
    sep = sep.to(memory_format=torch.channels_last)
    x, _ = _xc_dw_inputs(55, 55, 128)
    w = sep.conv1.weight
    with torch.inference_mode():
        assert port_dw.on_kernel(x, w)
    with torch.no_grad():
        assert port_dw.on_kernel(x, w)
    assert not port_dw.on_kernel(x, w)  # the weight requires grad
    assert port_dw.on_kernel(x, w.detach())
    assert not port_dw.on_kernel(x.float(), w.detach().float())  # bf16 only
    assert not port_dw.on_kernel(x.contiguous(), w.detach())  # channels-last only
    for H, W, C in ((9, 10, 13), (6, 5, 48)):  # the shape rule keeps these on cuDNN
        xr, wr = _xc_dw_inputs(H, W, C)
        assert not port_dw.on_kernel(xr, wr)
        with pytest.raises(ValueError, match="shape rule"):
            port_dw.dw_conv3x3_cuda(xr, wr, relu=True)
    layers = []
    sep.register_forward_pre_hook(lambda *a: layers.append(1))
    before = port_dw.conv3x3_launches
    with torch.inference_mode():
        fast = sep(x, relu=True)
        sep.use_kernels = False
        plain = sep(x, relu=True)  # the port's kernel switch off: cuDNN
        sep.use_kernels = True
    slow = sep(x, relu=True)
    slow.float().sum().backward()
    assert sep.conv1.weight.grad is not None
    assert len(layers) == 3 and port_dw.conv3x3_launches - before == 1
    want = slow.detach().float()
    for got in (fast, plain):
        assert float((got.float() - want).abs().max()) <= 2e-2 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_xception_forward_on_card_counts_its_kernel_layers():
    """One 224 px forward in bf16 under inference mode runs all 34 depthwise
    layers, each on the kernel (every shape passes the shape rule), and its
    map is the cuDNN path's within bf16's drift over 36 convolutions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from mintime_torch.models.classifier import init_weights
    from mintime_torch.models.xception import SeparableConv, Xception

    model = Xception(use_kernels=True).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.cuda().bfloat16().to(memory_format=torch.channels_last)
    frames = torch.rand(4, 224, 224, 3, generator=torch.Generator().manual_seed(1)).cuda()
    frames = frames.bfloat16()
    layers = []
    for m in model.modules():
        if isinstance(m, SeparableConv):
            m.register_forward_pre_hook(lambda *a: layers.append(1))
    before = port_dw.conv3x3_launches
    with torch.inference_mode():
        got = model(frames).float()
    after = port_dw.conv3x3_launches
    assert len(layers) == 34 and after - before == 34
    want = model(frames).detach().float()  # parameters require grad: cuDNN throughout
    assert port_dw.conv3x3_launches == after
    assert got.shape == (4, 7, 7, 2048)
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())


def _ffn_bwd_args(dim, hidden, m, seed):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    return (r(m, dim), r(2 * hidden, dim, sc=dim ** -0.5), r(2 * hidden, sc=0.02),
            r(dim, hidden, sc=hidden ** -0.5), r(m, dim))


@pytest.mark.cuda
@pytest.mark.parametrize("dim,hidden", [(512, 2048), (256, 1024), (512, 1024)])
@pytest.mark.parametrize("m", [1, 8, 100, 6272, 6280, 81920])
def test_geglu_backward_kernel_on_card_split_k(dim, hidden, m):
    """The FFN backward at both model widths and a TP=2 model rank's half
    hidden width, at row counts that split its products' reductions
    differently (dx over 2H at few rows, the weight gradients over M; the
    flagship's and the conv model's token rows, a tile past the flagship's),
    against its plain version with unit-scale cotangents; three CUDA
    launches a call (dh, the products, the reduce) (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = _ffn_bwd_args(dim, hidden, m, seed=11)
    got = port.geglu_ffn_bwd_cuda(*args)
    torch.cuda.synchronize()
    _close_per_gradient(got, port.geglu_ffn_bwd_plain(*args), f"ffn D={dim} M={m}")
    _launches_a_call(lambda: port.geglu_ffn_bwd_cuda(*args), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,hidden,m", [(512, 2048, 6272), (256, 1024, 8), (512, 2048, 100),
                                          (256, 1024, 8 * 8 * 1280)])
def test_geglu_backward_kernel_is_bitwise_stable(dim, hidden, m):
    """Split-K partials are summed in slice order, without atomics: a rerun
    gives the same bits of every gradient (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = _ffn_bwd_args(dim, hidden, m, seed=12)
    first = port.geglu_ffn_bwd_cuda(*args)
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(port.geglu_ffn_bwd_cuda(*args), first))


@pytest.mark.cuda
def test_token_rows_forward_kernel_on_card_at_space_axis():
    """The token-row forward kernel on the flagship space axis (L = 49
    patches, 8 heads), where the attention probe's variant B runs it (needs
    the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(8)
    B, G, L, H, dh = 2, 16, 49, 8, 64
    qkv = torch.randn(B, G, L, 3 * H * dh, generator=gen).cuda().bfloat16()
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    sb = port_divided.mask_to_bias((torch.rand(B, L, 1 + L, generator=gen) > 0.1).cuda())
    kw = dict(heads=H, dim_head=dh)
    torch.testing.assert_close(port_rows.token_rows_attention_cuda(qkv, qkvc, sb, **kw).float(),
                               port_rows.token_rows_attention_plain(qkv, qkvc, sb, **kw).float(),
                               atol=2e-2, rtol=2e-2)


def _long_axis_inputs(L, gen, B=2, G=8, H=6, dh=64, masked=False):
    """The conv model's space axis at L channel tokens on a strided view, a
    CLS-row bias that masks frames and, if ``masked``, a seq_bias."""
    qkv = torch.randn(B, L, G, 3 * H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    rb = torch.zeros(B, G, 1, device="cuda")
    rb[1, 5:] = port_divided.NEG
    sb = None
    if masked:
        keep = torch.rand(B, L, 1 + L, generator=gen) > 0.1
        keep[..., 0] = True
        sb = port_divided.mask_to_bias(keep.cuda())
    d_tok = torch.randn(B, G, L, H * dh, generator=gen).cuda().bfloat16()
    d_cls = torch.randn(B, 1, H * dh, generator=gen).cuda().bfloat16()
    return (qkv, qkvc, sb, rb), (d_tok, d_cls), dict(heads=H, dim_head=dh)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", [65, 80, 112, 129, 192, 200, 256])
def test_divided_attention_kernels_on_card_at_long_axes(L, masked):
    """Both whole-slice kernels at 64 < L <= 256 (the conv model's space axis
    at tap blocks 4-13: G = 8 frames of L = C channel tokens, 6 heads of 64,
    and 65, 129, 200 at the edges of the backward's 16-row tiles and 64-row
    chunks) against their plain versions in bf16, on a strided view with a
    CLS-row bias that masks frames, with and without a seq_bias; forward max
    abs error 2e-2, six CUDA launches a backward call (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args, cots, kw = _long_axis_inputs(L, torch.Generator().manual_seed(9), masked=masked)
    got = port_divided.divided_attention_cuda(*args, **kw)
    want = port_divided.divided_attention_plain(*args, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
    _within(got, want)
    _launches_a_call(lambda: port_divided.divided_attention_bwd_cuda(*args, *cots, **kw), 6)
    got = port_divided.divided_attention_bwd_cuda(*args, *cots, **kw)
    torch.cuda.synchronize()
    assert got[0].stride() == args[0].stride()
    want = port_divided.divided_attention_bwd_plain(*args, *cots, **kw)
    _close_per_gradient(got, want, f"attention L={L} seq_bias={masked}")
    # P and dS enter the tensor-core products as bf16 hi/lo pairs: few values
    # round otherwise than the fp32 plain version's (about 40% would if P and
    # dS were rounded once to bf16)
    assert float((got[0] != want[0]).float().mean()) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("L", [49, 192])
def test_divided_attention_forward_kernel_is_bitwise_stable(L):
    """The forward kernel gives the same bits on reruns: the CLS row's chunks
    are summed in a fixed order and no atomics are used (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args, _, kw = _long_axis_inputs(L, torch.Generator().manual_seed(12), masked=True)
    first = port_divided.divided_attention_cuda(*args, **kw)
    for _ in range(2):
        again = port_divided.divided_attention_cuda(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", [1, 8, 16, 17, 49, 64])
def test_divided_attention_forward_kernel_on_card_at_short_axes(L, masked):
    """The tensor-core token rows at L <= 64 (the flagship's 16 and 49, the
    conv time axis' 8, and the edges of a 16-row tile) against the plain
    version in bf16, max abs error 2e-2, on a strided view with a CLS-row
    bias (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args, _, kw = _long_axis_inputs(L, torch.Generator().manual_seed(13), masked=masked)
    got = port_divided.divided_attention_cuda(*args, **kw)
    want = port_divided.divided_attention_plain(*args, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
    _within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", [1, 8, 16, 17, 33, 49, 63, 64])
def test_divided_attention_backward_kernel_on_card_at_short_axes(L, masked):
    """The backward's tensor-core token rows at L <= 64 (the flagship's 16
    and 49, the conv time axis' 8, the edges of a 16-row tile, four, two and
    one groups a block, one short of a full 64-row tile) against the plain
    version per gradient, on a strided view with a CLS-row bias, with and
    without a seq_bias; G = 7, so that a block's groups span two videos and
    the last block is short; six CUDA launches a call (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args, cots, kw = _long_axis_inputs(L, torch.Generator().manual_seed(14), G=7, masked=masked)
    _launches_a_call(lambda: port_divided.divided_attention_bwd_cuda(*args, *cots, **kw), 6)
    got = port_divided.divided_attention_bwd_cuda(*args, *cots, **kw)
    torch.cuda.synchronize()
    assert got[0].stride() == args[0].stride()
    want = port_divided.divided_attention_bwd_plain(*args, *cots, **kw)
    _close_per_gradient(got, want, f"attention L={L} seq_bias={masked}")
    # P and dS enter the tensor-core products as bf16 hi/lo pairs
    assert float((got[0] != want[0]).float().mean()) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 49, 192])
def test_divided_attention_backward_kernel_is_bitwise_stable(L):
    """The backward kernel gives the same bits on reruns: every sum runs in a
    fixed order and no atomics are used (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args, cots, kw = _long_axis_inputs(L, torch.Generator().manual_seed(11), masked=True)
    first = port_divided.divided_attention_bwd_cuda(*args, *cots, **kw)
    for _ in range(2):
        again = port_divided.divided_attention_bwd_cuda(*args, *cots, **kw)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,C,K", [(64, 112, 32, 3), (64, 28, 240, 5), (512, 112, 32, 3)])
def test_dw_conv_wgrad_kernel_on_card_at_b0_and_b4(N, H, C, K):
    """The weight-gradient kernel at EfficientNet-B0's blocks 0 and 4 (the
    probe's geometries at 64 images, and block 0 at the probe's 512) against
    its plain version, 2e-2 of max |plain|, and bitwise equal on a rerun
    (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(N, H, H, C, generator=gen).cuda().bfloat16()
    dy = torch.randn(N, H, H, C, generator=gen).cuda().bfloat16()
    got = port_dw.dw_conv_wgrad_cuda(x, dy, K=K)
    want = port_dw.dw_conv_wgrad_plain(x, dy, K=K)
    assert got.shape == (K, K, 1, C) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert torch.equal(port_dw.dw_conv_wgrad_cuda(x, dy, K=K), got)


def _ffn_fwd_args(dim, hidden, m, seed):
    """x and the weights at unit fan-in scale, as ``kernel_turns`` draws them."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).cuda().bfloat16()  # noqa: E731
    return (r(m, dim), r(2 * hidden, dim, sc=dim ** -0.5), r(2 * hidden, sc=0.02),
            r(dim, hidden, sc=hidden ** -0.5), r(dim, sc=0.02))


def _ffn_prod_plain(x, w0, b0):
    """Launch A's result in plain PyTorch: bf16(val * gelu(gate)) of the
    bf16-rounded up-projection."""
    f32 = torch.float32
    h = (x.to(f32) @ w0.to(f32).T + b0.to(f32)).to(x.dtype)
    val, gate = h.to(f32).chunk(2, dim=-1)
    return (val * torch.nn.functional.gelu(gate)).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,hidden", [(512, 2048), (256, 1024), (512, 1024)])
@pytest.mark.parametrize("m", [1, 8, 127, 129, 6272, 6273, 81920])
def test_geglu_forward_launches_on_card(dim, hidden, m):
    """Each launch of the FFN forward against plain PyTorch, at both widths
    and a TP=2 model rank's half hidden width, at row counts that take every
    tile width of its plan (wide tiles at the token rows of the flagship and
    the conv model, narrow ones and split slices under a row tile, ragged
    last tiles): launch A's product and the output, max abs error 2e-2; the
    plan's CUDA launches a call (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, w0, b0, w1, b1 = _ffn_fwd_args(dim, hidden, m, seed=13)
    out, prod = port._fwd_launch(x, w0, b0, w1, b1)
    torch.cuda.synchronize()
    torch.testing.assert_close(prod.float(), _ffn_prod_plain(x, w0, b0).float(), atol=2e-2,
                               rtol=2e-2)
    want = port.geglu_ffn_plain(x, w0, b0, w1, b1)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    _within(out, want)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _launches_a_call(lambda: port.geglu_ffn_cuda(x, w0, b0, w1, b1),
                     port.fwd_plan(m, dim, hidden, sms)["launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("dim,hidden,m", [(512, 2048, 6272), (512, 2048, 8), (256, 1024, 8)])
def test_geglu_forward_kernel_is_bitwise_stable(dim, hidden, m):
    """Split slices are summed in order, without atomics: a rerun of the
    forward gives the same bits (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = _ffn_fwd_args(dim, hidden, m, seed=14)
    first = port.geglu_ffn_cuda(*args)
    for _ in range(2):
        assert torch.equal(port.geglu_ffn_cuda(*args), first)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", [33, 49, 64])
def test_token_rows_backward_kernel_on_card_at_long_axes(L, masked):
    """The token-row backward above 32 frames, up to the forward's limit of
    64 (three keys a lane, two warps a block), on the strided time-axis view,
    against its plain version per gradient (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(15)
    B, G, H, dh = 2, 24, 6, 64
    qkv = torch.randn(B, L, G, 3 * H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
    qkvc = torch.randn(B, 1, 3 * H * dh, generator=gen).cuda().bfloat16()
    sb = None
    if masked:
        keep = torch.rand(B, L, 1 + L, generator=gen) > 0.1
        keep[..., 0] = True
        sb = port_divided.mask_to_bias(keep.cuda())
    kw = dict(heads=H, dim_head=dh)
    d_tok = torch.randn(B, L, G, H * dh, generator=gen).cuda().bfloat16().transpose(1, 2)
    got = port_rows.token_rows_attention_bwd_cuda(qkv, qkvc, sb, d_tok, **kw)
    torch.cuda.synchronize()
    assert got[0].stride() == qkv.stride()
    assert not got[1][..., :H * dh].any()
    _close_per_gradient(got, port_rows.token_rows_attention_bwd_plain(qkv, qkvc, sb, d_tok, **kw),
                        f"token rows L={L} seq_bias={masked}")


def _token_rows_case(gen, B, G, L, masked, H=6, dh=64, unaligned=False):
    """The time axis as the conv model passes it, qkv (B, L, G, 3*H*dh) seen
    as its (B, G, L, ·) transpose, its cotangent likewise; with ``masked`` a
    seq_bias that masks video 1's frames from 5 on (the CLS key kept);
    ``unaligned`` takes both from buffers one value wider, so that no row
    starts on 16 bytes."""
    c3, inner, pad = 3 * H * dh, H * dh, int(unaligned)
    qkv = torch.randn(B, L, G, c3 + pad, generator=gen).cuda().bfloat16()[..., pad:]
    d_tok = torch.randn(B, L, G, inner + pad, generator=gen).cuda().bfloat16()[..., pad:]
    qkvc = torch.randn(B, 1, c3, generator=gen).cuda().bfloat16()
    sb = None
    if masked:
        mask = torch.ones(B, L, dtype=torch.bool)
        mask[1, min(5, L - 1):] = False
        frame = torch.cat([torch.ones(B, L, 1, dtype=torch.bool),
                           mask[:, None, :].expand(B, L, L)], dim=-1)
        sb = port_divided.mask_to_bias(frame.cuda())
    return qkv.transpose(1, 2), qkvc, sb, d_tok.transpose(1, 2), dict(heads=H, dim_head=dh)


def _check_token_rows(qkv, qkvc, sb, d_tok, kw, what):
    """Forward within 2e-2 of plain (max abs error), each gradient within
    2e-2 of max(1, its max |plain|), the outputs in qkv's stride order, the CLS query's third of
    d_qkvc exactly zero."""
    H, dh = kw["heads"], kw["dim_head"]
    got = port_rows.token_rows_attention_cuda(qkv, qkvc, sb, **kw)
    want = port_rows.token_rows_attention_plain(qkv, qkvc, sb, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2,
                               msg=lambda m: f"{what}: {m}")
    _within(got, want)
    assert got.stride() == port_rows._empty_grouped(qkv, H * dh).stride()
    got = port_rows.token_rows_attention_bwd_cuda(qkv, qkvc, sb, d_tok, **kw)
    torch.cuda.synchronize()
    assert got[0].stride() == port_rows._empty_grouped(qkv, 3 * H * dh).stride()
    assert not got[1][..., :H * dh].any(), what
    _close_per_gradient(got, port_rows.token_rows_attention_bwd_plain(qkv, qkvc, sb, d_tok, **kw),
                        what)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L", list(range(1, 17)) + [33, 49, 64])
def test_token_rows_kernels_on_card_at_every_short_length(L, masked):
    """Forward and backward against plain at every L the tile launches take
    (16 // L groups a warp tile) and at the long axes, on 3 videos of an odd
    7 groups, so that video 1 (masked with ``masked``) begins mid-tile in a
    numbering across videos (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(16 + L)
    _check_token_rows(*_token_rows_case(gen, 3, 7, L, masked), f"L={L} seq_bias={masked}")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 7, 1281])
def test_token_rows_kernels_on_card_at_odd_group_counts(G):
    """At the conv time axis's 8 frames and odd group counts, so that each
    video's last tile holds one group, with video 1's frames masked (needs
    the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(17)
    _check_token_rows(*_token_rows_case(gen, 2, G, 8, True), f"G={G}")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 49])
def test_token_rows_kernels_on_card_through_an_unaligned_view(L):
    """Views whose rows do not start on 16 bytes are copied by the wrappers
    and give the same results (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(18)
    qkv, qkvc, sb, d_tok, kw = _token_rows_case(gen, 2, 9, L, True, unaligned=True)
    assert qkv.data_ptr() % 16 and d_tok.data_ptr() % 16
    _check_token_rows(qkv, qkvc, sb, d_tok, kw, f"unaligned L={L}")


@pytest.mark.cuda
@pytest.mark.parametrize("G,L,masked", [(1280, 8, False), (96, 49, False), (96, 8, True),
                                        (96, 33, False), (96, 33, True), (96, 49, True),
                                        (96, 64, False), (96, 64, True)])
def test_token_rows_kernels_are_bitwise_stable(G, L, masked):
    """At the conv time axis (B = 8 videos of G = 1280 groups of 8 frames)
    and at G = 96 up to 64 frames, masked and not: two reruns of the forward
    and the backward give the same bits (no atomics; the CLS key's partials
    are summed in order), each in the CUDA launches of its plan (needs the
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(19)
    qkv, qkvc, sb, d_tok, kw = _token_rows_case(gen, 8, G, L, masked)
    fwd = port_rows.token_rows_attention_cuda(qkv, qkvc, sb, **kw)
    bwd = port_rows.token_rows_attention_bwd_cuda(qkv, qkvc, sb, d_tok, **kw)
    for _ in range(2):
        assert torch.equal(port_rows.token_rows_attention_cuda(qkv, qkvc, sb, **kw), fwd)
        assert all(torch.equal(a, b) for a, b in
                   zip(port_rows.token_rows_attention_bwd_cuda(qkv, qkvc, sb, d_tok, **kw), bwd))
    plan = port_rows.plan(8, G, L, kw["heads"])
    _launches_a_call(lambda: port_rows.token_rows_attention_cuda(qkv, qkvc, sb, **kw),
                     plan["fwd_launches"])
    _launches_a_call(lambda: port_rows.token_rows_attention_bwd_cuda(qkv, qkvc, sb, d_tok, **kw),
                     plan["bwd_launches"])
