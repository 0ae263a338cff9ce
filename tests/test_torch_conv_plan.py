"""``ConvPlan`` for the Hopper forward kernel (``csrc/trim_conv2d.cu``).

Pure geometry, on the CPU: the register micro-tile and its slots, the
column bands and strips, the carry segments that give the card enough
blocks, the window ring and its shared memory, and the bytes of the
kernel's schedule (segment re-reads priced).  Every geometry the CPU and
card tests run must still plan, within :data:`SMEM_PER_BLOCK`.
"""

import itertools

import pytest

from repro_torch.core.conv_plan import (CONV_MAX_TILE_COUT, SMEM_PER_BLOCK,
                                        SMS, ConvPlan, _blocks_per_sm,
                                        input_grad_geometry)
from repro_torch.core.model import vgg16_layers
from repro_torch.kernels.ref import conv_pads

VGG = [((l.ifmap, l.ifmap, l.in_channels), (3, 3, l.in_channels,
                                            l.out_channels))
       for l in vgg16_layers()]

# The geometries of tests/test_torch_conv2d.py (x (2, 11, 12, 8); K, stride,
# groups, padding), its tile knobs, and tests/test_torch_cuda.py's CASES:
# (n, h, w, cin, cout, k, stride, groups, padding, tile_h, tile_cout).
SWEEP = (
    [(2, 11, 12, 8, 8, k, s, g, pad, None, None) for k, s, g, pad in
     itertools.product((1, 3, 5), (1, 2), (1, 8), ("same", "valid"))]
    + [(2, 11, 12, 8, 8, 3, 1, 1, "same", th, tc)
       for th, tc in ((1, 1), (4, 3), (64, 8))]
    + [(2, 9, 11, 4, 6, 3, 1, 1, "same", None, None),
       (2, 10, 10, 4, 8, 3, 2, 1, "same", None, None),
       (1, 11, 12, 6, 6, 5, 2, 3, "valid", 2, 2),
       (3, 7, 8, 4, 4, 1, 2, 1, "valid", None, None),
       (2, 13, 13, 3, 5, 3, 1, 1, "same", 2, None),
       (2, 12, 12, 4, 4, 3, 1, 4, "same", 3, None),
       (1, 40, 37, 8, 70, 3, 1, 1, "same", None, None),
       (1, 9, 9, 2, 40, 4, 3, 1, "valid", 3, 40),
       (2, 20, 33, 64, 96, 3, 1, 1, "same", 4, 96),
       (1, 17, 17, 16, 16, 7, 1, 16, "same", None, None),
       (1, 30, 30, 512, 64, 3, 1, 1, "same", None, None),
       (2, 28, 28, 32, 64, 3, 2, 2, "same", None, 32),
       (1, 15, 15, 40, 24, 3, 1, 1, "same", None, None),
       (2, 10, 10, 68, 20, 3, 2, 1, "same", None, None)]
    + [(n, h, w, cin, w_[3], 3, 1, 1, "same", None, None)
       for n in (1, 8) for (h, w, cin), w_ in VGG]
    + [(8, 56, 56, 128, 256, 3, 2, 1, "same", None, None),
       (8, 112, 112, 32, 32, 3, 1, 32, "same", None, None)])


def _plan(case, dataflow="carry"):
    n, h, w, cin, cout, k, s, g, padding, tile_h, tile_cout = case
    return ConvPlan.build((n, h, w, cin), (k, k, cin // g, cout), stride=s,
                          pad=conv_pads(h, w, k, s, padding), groups=g,
                          tile_h=tile_h, tile_cout=tile_cout,
                          dataflow=dataflow)


@pytest.mark.parametrize("case", SWEEP, ids=[str(i) for i in
                                              range(len(SWEEP))])
def test_every_tested_geometry_plans_within_the_card(case):
    for dataflow in ("carry", "halo"):
        p = _plan(case, dataflow)
        assert p.smem_bytes <= SMEM_PER_BLOCK
        assert 1 <= p.positions <= p.slots
        assert p.tile_cout <= CONV_MAX_TILE_COUT
        assert p.cin_stride >= p.cin_per_group
        assert p.ring_rows in (p.window_rows, 2 * p.tile_h + p.carry_rows)
        assert p.segments * p.strips_per_segment >= p.n_strips
        assert (p.segments - 1) * p.strips_per_segment < p.n_strips
        if case[9] is not None:      # a given strip, clamped to the height
            assert p.tile_h == min(case[9], p.h_out * p.stride)
    halo = _plan(case, "halo")
    assert halo.segments == halo.n_strips and not halo.prefetch


def test_conv2_at_batch_one_fills_the_card():
    """VGG-16 conv2 at N=1: 14 chains of strips, cut into segments that
    give at least one full wave."""
    p = ConvPlan.build((1, 224, 224, 64), (3, 3, 64, 64), pad=1)
    assert p.blocks >= SMS
    assert p.blocks >= SMS * _blocks_per_sm(p._smem(p.window_rows))
    assert p.chains * p.segments == p.blocks


@pytest.mark.parametrize("n", [1, 8])
def test_vgg16_plans_fill_a_wave_where_the_strips_allow(n):
    for (h, w, cin), wsh in VGG:
        p = ConvPlan.build((n, h, w, cin), wsh, pad=1)
        wave = SMS * _blocks_per_sm(p._smem(p.window_rows))
        assert p.blocks >= wave or p.segments == p.n_strips


def test_hbm_bytes_price_the_segment_rereads():
    x, w = (8, 224, 224, 64), (3, 3, 64, 64)
    carry = ConvPlan.build(x, w, pad=1)
    halo = ConvPlan.build(x, w, pad=1, dataflow="halo")
    assert 1 < carry.segments < carry.n_strips
    for p in (carry, halo):
        rows = p.n_strips * p.tile_h + p.segments * p.carry_rows
        assert p.hbm_bytes()["input"] == \
            4 * p.chains * rows * p.window_cols * p.cin_per_group
        b = p.hbm_bytes()
        assert b["total"] == b["input"] + b["weights"] + b["output"]
    # halo re-reads K-s rows a strip, carry only a segment
    extra = (halo.segments - carry.segments) * carry.carry_rows
    assert halo.hbm_bytes()["input"] - carry.hbm_bytes()["input"] == \
        4 * carry.chains * extra * carry.window_cols * 64
    assert carry.hbm_bytes()["total"] >= carry.min_bytes()


def test_micro_tile_and_window_layout():
    # a warp along C_out: 32 threads x 4 channels, 8 positions a thread
    p = ConvPlan.build((8, 28, 28, 512), (3, 3, 512, 512), pad=1)
    assert (p.tile_cout, p.threads_cout, p.slots) == (128, 32, 64)
    assert p.cin_stride == 516          # bank-skewed channel pitch
    # 64 channels: 16 threads along C_out, 16 along positions
    q = ConvPlan.build((1, 224, 224, 64), (3, 3, 64, 64), pad=1)
    assert (q.threads_cout, q.slots) == (16, 128)
    # half a warp along C_out and twice the positions where that walks no
    # more strips an SM and reads fewer window pixels an output (conv4)
    r = ConvPlan.build((8, 112, 112, 128), (3, 3, 128, 128), pad=1)
    assert (r.tile_cout, r.positions) == (64, 128)
    # Cin 3 and depthwise: an unpadded pitch (4-byte copies)
    assert ConvPlan.build((1, 224, 224, 3), (3, 3, 3, 64),
                          pad=1).cin_stride == 3
    dw = ConvPlan.build((8, 112, 112, 32), (3, 3, 1, 32), pad=1, groups=32)
    assert (dw.tile_cout, dw.threads_cout, dw.cin_stride) == (1, 1, 1)


def test_input_gradient_geometries_plan():
    """dx runs the forward kernel on the dilated cotangent, stride 1."""
    for (h, w, cin), wsh in VGG + [((56, 56, 128), (3, 3, 128, 256))]:
        s = 2 if wsh[3] == 256 and h == 56 and cin == 128 else 1
        pads = conv_pads(h, w, 3, s, "same")
        geo = input_grad_geometry((8, h, w, cin), wsh, stride=s, pad=pads)
        p = ConvPlan.build(geo["g_dilated_shape"], geo["wt_shape"],
                           pad=(geo["pad_h"], geo["pad_w"]))
        assert p.out_shape == (8, h, w, cin)
        assert p.smem_bytes <= SMEM_PER_BLOCK


def test_plans_are_cached_and_errors_kept():
    a = ConvPlan.build((2, 11, 12, 8), (3, 3, 8, 8), pad=1)
    assert ConvPlan.build((2, 11, 12, 8), (3, 3, 8, 8), pad=1) is a
    with pytest.raises(ValueError, match="exceeds"):
        ConvPlan.build((1, 8, 8, 4), (3, 3, 4, 256), tile_cout=200)
    with pytest.raises(ValueError, match="shared"):
        ConvPlan.build((1, 8, 8, 8192), (3, 3, 8192, 4))
    with pytest.raises(ValueError, match="multiple"):
        ConvPlan.build((1, 9, 9, 4), (3, 3, 4, 4), stride=2, tile_h=3)
    with pytest.raises(ValueError, match="multiple"):
        ConvPlan(n=1, h=8, w=8, cin=4, cout=4, kh=3, kw=3, stride=2,
                 pads=((1, 1), (1, 1)), groups=1, tile_h=3, tile_w=4,
                 tile_cout=4)
