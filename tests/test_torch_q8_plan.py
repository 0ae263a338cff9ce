"""The int8 kernel's plan (``ConvPlan`` with ``dtype_bytes=1``), on the CPU.

The int8 kernel of ``csrc/trim_conv2d_q8.cu`` runs three routes: ``mma``
(Cin/g a multiple of 16: ``mma.sync`` m16n8k32 straight from the window),
``im2col`` (small Cin with groups == 1) and ``dp4a`` (depthwise and other
grouped convs with Cin/g < 16).  For VGG-16's 13 convs at batch 1 and 8,
the smoke's stride-2 and depthwise cases and every ``Q8_CASES`` geometry
of the GPU tests, the plan must pick the expected route, fit a block's
227 KB, store the window at a pitch of an odd count of 16-byte quads (the
8 positions an ``ldmatrix`` phase reads sit one pitch apart on the
phase-split window, so they hit 8 distinct bank quads at any stride), lay
the warps out as the launcher accepts them, and give batch-1 conv11-13 at
least one block an SM.  The f32 plan of the same shapes keeps the f32
kernel's geometry.
"""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.core import conv_plan as cp
from repro_torch.core.conv_plan import ConvPlan
from repro_torch.core.model import vgg16_layers
from repro_torch.kernels.ref import conv_pads

_spec = importlib.util.spec_from_file_location(
    "_torch_cuda_cases", Path(__file__).with_name("test_torch_cuda.py"))
_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cases)
Q8_CASES = _cases.Q8_CASES

VGG = [(l.name, l.ifmap, l.in_channels, l.out_channels)
       for l in vgg16_layers()]


def _check(plan: ConvPlan, route: str) -> None:
    assert plan.dtype_bytes == 1 and plan.route == route
    assert plan.smem_bytes <= cp.SMEM_PER_BLOCK
    assert plan.positions <= plan.slots
    assert plan.blocks_per_sm in (1, 2)
    if route == "dp4a":
        assert (plan.warps_n, plan.warps_k, plan.m_frags) == (0, 0, 0)
        assert plan.cin_stride == cp.q8_cin4(plan.cin_per_group)
        return
    assert plan.warps_m * plan.warps_n * plan.warps_k == cp.Q8_WARPS
    assert plan.tile_cout <= cp.Q8_WARP_N * plan.warps_n
    assert plan.warps_k == 1 or plan.m_frags == 1
    assert plan.k_steps * cp.Q8_MMA_K == plan.kpad
    assert plan.col_slots % plan.stride == 0
    assert plan.col_slots >= plan.window_cols
    if route == "mma":
        # ldmatrix rows are 16-byte aligned; neighbours one pitch apart
        assert plan.cin_stride % 16 == 0
        assert (plan.cin_stride // 16) % 2 == 1
        assert plan.cin_stride - plan.cin_per_group in (0, 16)
        assert plan.row_bytes % 16 == 0
        assert 0 <= plan.row_bytes - plan.col_slots * plan.cin_stride < 128
        _check_ldmatrix_phases(plan)
    else:
        assert plan.cin_stride == plan.cin4
        assert plan.kpad <= cp.Q8_IM2COL_MAX_K


def _check_ldmatrix_phases(plan: ConvPlan) -> None:
    """Every 8-row phase of an A ``ldmatrix`` (8 consecutive positions of
    the strip, clamped to the last as the kernel clamps idle rows) reads
    8 distinct bank quads at tap (0, 0) of a strip that starts at ring row
    0, output rows crossed included; only a stride-2 band of odd width
    cannot make the next output row continue the sequence."""
    s, quads = plan.stride, plan.cin_stride // 16
    if (plan.stride * (plan.row_bytes // 16) - plan.tile_w * quads) % 8:
        assert s % 2 == 0 and plan.tile_w % 2 == 1
        return
    for p0 in range(0, plan.slots, 8):
        addrs = set()
        for p in range(p0, p0 + 8):
            oi, oc = divmod(min(p, plan.positions - 1), plan.tile_w)
            addrs.add(oi * s * plan.row_bytes + oc * plan.cin_stride)
        assert len({a // 16 % 8 for a in addrs}) == len(addrs), p0


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("dataflow", ["carry", "halo"])
@pytest.mark.parametrize("layer", VGG, ids=[v[0] for v in VGG])
def test_vgg16_layers_plan_on_the_tensor_cores(layer, dataflow, n):
    name, size, cin, cout = layer
    plan = ConvPlan.build((n, size, size, cin), (3, 3, cin, cout), pad=1,
                          dataflow=dataflow, dtype_bytes=1)
    _check(plan, "im2col" if cin == 3 else "mma")
    if n == 1 and name in ("conv11", "conv12", "conv13"):
        assert plan.blocks >= cp.SMS
    if dataflow == "halo":
        assert plan.strips_per_segment == 1
        assert plan.ring_rows == plan.window_rows


def test_smoke_extra_cases_plan():
    """The smoke's stride-2 case runs the mma route, its depthwise case
    the dp4a route."""
    for n in (1, 8):
        s2 = ConvPlan.build((n, 56, 56, 128), (3, 3, 128, 256), stride=2,
                            pad=conv_pads(56, 56, 3, 2, "same"),
                            dtype_bytes=1)
        _check(s2, "mma")
        dw = ConvPlan.build((n, 112, 112, 32), (3, 3, 1, 32), pad=1,
                            groups=32, dtype_bytes=1)
        _check(dw, "dp4a")


@pytest.mark.parametrize("case", Q8_CASES,
                         ids=[str(i) for i in range(len(Q8_CASES))])
def test_gpu_test_geometries_plan(case):
    (n, h, w, cin, cout, k, s, g, padding, _, _, _, tile_h, tile_cout,
     _) = case
    cin_pg = cin // g
    route = "mma" if cin_pg % 16 == 0 else \
        "im2col" if g == 1 and cp.q8_kpad(k, cin_pg) <= 256 else "dp4a"
    for dataflow in ("carry", "halo"):
        plan = ConvPlan.build((n, h, w, cin), (k, k, cin_pg, cout),
                              stride=s, pad=conv_pads(h, w, k, s, padding),
                              groups=g, tile_h=tile_h, tile_cout=tile_cout,
                              dataflow=dataflow, dtype_bytes=1)
        _check(plan, route)
        if tile_cout is not None:
            assert plan.tile_cout == min(tile_cout, cout // g)


@pytest.mark.parametrize("cin_pg", range(16, 1041, 16))
def test_mma_pitch_is_an_odd_count_of_quads(cin_pg):
    first = cp._q8_mma_pitches(cin_pg)[0]
    assert first % 16 == 0 and (first // 16) % 2 == 1
    assert first in (cin_pg, cin_pg + 16)


def test_routes():
    assert cp.q8_route(64, 1, 3) == "mma"
    assert cp.q8_route(48, 2, 3) == "mma"          # grouped, Cin/g % 16 == 0
    assert cp.q8_route(3, 1, 3) == "im2col"        # VGG-16 conv1: 36 bytes
    assert cp.q8_route(3, 1, 5) == "im2col"        # 100 bytes: 4 k-steps
    assert cp.q8_route(28, 1, 3) == "im2col"       # 252 -> 256 bytes
    assert cp.q8_route(40, 1, 3) == "dp4a"         # 360 -> 384 bytes
    assert cp.q8_route(1, 32, 3) == "dp4a"         # depthwise
    assert cp.q8_route(4, 2, 3) == "dp4a"          # grouped, Cin/g 4


def test_plan_refuses_a_warp_layout_the_launcher_refuses():
    base = dict(n=1, h=8, w=8, cin=64, cout=64, kh=3, kw=3, stride=1,
                pads=((1, 1), (1, 1)), groups=1, tile_h=2, tile_w=8,
                tile_cout=64, cin_stride=80, dtype_bytes=1)
    ConvPlan(warps_n=2, warps_k=1, m_frags=1, **base)
    for wn, wk, mi in ((3, 1, 1), (2, 2, 2), (4, 4, 1), (2, 1, 5),
                       (1, 1, 1), (0, 0, 0)):
        with pytest.raises(ValueError, match="warps"):
            ConvPlan(warps_n=wn, warps_k=wk, m_frags=mi, **base)


def test_f32_plans_are_the_f32_kernels():
    """The int8 fields stay at their defaults on f32 plans, and the f32
    plan's own properties do not read them."""
    for name, size, cin, cout in VGG:
        f32 = ConvPlan.build((8, size, size, cin), (3, 3, cin, cout), pad=1)
        assert f32.route == "f32" and not f32.tensor_cores
        assert (f32.warps_n, f32.warps_k, f32.m_frags) == (0, 0, 0)
        assert f32.slots == cp.CONV_THREADS // f32.threads_cout \
            * cp.CONV_POSITIONS
        assert f32.col_slots == f32.window_cols
