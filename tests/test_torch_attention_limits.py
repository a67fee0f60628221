"""Every attended axis that the port's models send to the whole-slice
divided-attention kernels is one those kernels take, for every
``efficient_net_block`` of the Convolutional TimeSformer (1-20) and for the
flagship, at each ``num_frames`` the config allows. The routing is the
models' own: ``DividedAttention`` takes the kernel path for an axis of at
most ``KERNEL_MAX_AXIS`` positions, and ``divided_attention`` sends a slice
of at most 6 MiB of packed qkv (at bf16, the card's element size) to the
whole-slice kernels. No card is needed: the kernels' shape limits are the
wrapper's ``check_kernel_shape``, which raises where the kernels would.
"""

import dataclasses
import functools

import pytest

from mintime_torch.config import VALID_NUM_FRAMES
from mintime_torch.models.efficientnet import EfficientNet
from mintime_torch.models.timesformer import KERNEL_MAX_AXIS
from mintime_torch.ops import divided_attention as da

BF16 = 2


@functools.lru_cache(maxsize=None)
def channels(block: int) -> int:
    return EfficientNet("efficientnet-b0", tap_block=block).feature_dim


def conv_config(block: int, frames: int):
    import chip_smoke

    return dataclasses.replace(chip_smoke.conv_model_config(), efficient_net_block=block,
                               num_frames=frames)


def whole_slice_axes(G_time: int, L_time: int, heads: int, dim_head: int):
    """(axis, G, L) of the two axes that reach the whole-slice kernels; the
    space axis is the time axis with groups and positions swapped."""
    c3 = 3 * heads * dim_head
    return [(axis, G, L) for axis, G, L in (("time", G_time, L_time), ("space", L_time, G_time))
            if L <= KERNEL_MAX_AXIS and da.takes_whole_slice(G, L, c3, BF16)]


def test_the_model_and_the_kernels_name_one_limit():
    assert KERNEL_MAX_AXIS == da._KERNEL_MAX_L == 256


@pytest.mark.parametrize("frames", VALID_NUM_FRAMES)
@pytest.mark.parametrize("block", range(1, 21))
def test_conv_model_axes_fit_the_whole_slice_kernels(block, frames):
    cfg = conv_config(block, frames)
    C = channels(block)
    for axis, G, L in whole_slice_axes(C, frames, cfg.heads, cfg.dim_head):
        assert L <= da._KERNEL_MAX_L and G * L <= da._KERNEL_MAX_KEYS, (block, frames, axis)
        da.check_kernel_shape(G, L, cfg.dim_head)


@pytest.mark.parametrize("frames", VALID_NUM_FRAMES)
def test_flagship_axes_fit_the_whole_slice_kernels(frames):
    n, heads, dim_head = 49, 8, 64  # configs/size_invariant_timesformer.yaml
    axes = whole_slice_axes(n, frames, heads, dim_head)
    assert {a for a, _, _ in axes} == {"time", "space"}
    for axis, G, L in axes:
        assert L <= da._KERNEL_MAX_L and G * L <= da._KERNEL_MAX_KEYS, (frames, axis)
        da.check_kernel_shape(G, L, dim_head)


@pytest.mark.parametrize("block,C", [(4, 80), (7, 112), (10, 192), (13, 192)])
def test_tap_blocks_4_to_13_send_space_axes_longer_than_64(block, C):
    """The shapes that the L <= 64 kernels refused: the conv space axis at C
    channel tokens, one slice of 8 x C x 1152 x 2 B."""
    cfg = conv_config(block, 8)
    assert channels(block) == C
    assert ("space", 8, C) in whole_slice_axes(C, 8, cfg.heads, cfg.dim_head)
    da.check_kernel_shape(8, C, cfg.dim_head)


def test_the_shape_check_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="L <= 256"):
        da.check_kernel_shape(8, 320, 64)
    with pytest.raises(ValueError, match="G\\*L"):
        da.check_kernel_shape(64, 256, 64)
    with pytest.raises(ValueError, match="dim_head"):
        da.check_kernel_shape(8, 16, 32)


@pytest.mark.parametrize("G,L,chunks", [(16, 49, 7), (49, 16, 7), (192, 8, 12), (8, 80, 5),
                                        (8, 192, 12), (8, 256, 16), (1, 1, 1), (48, 256, 96)])
def test_forward_cls_row_chunks_hold_at_most_128_keys(G, L, chunks):
    """The CLS row's G*L keys split into chunks of at most 128, one block of
    each CLS launch a chunk: 7 at the flagship (784 keys), 12 at tap 10."""
    assert da.cls_row_chunks(G, L) == chunks
    assert (chunks - 1) * 128 < G * L <= chunks * 128
