"""The bf16 tensor-core route of the port's conv kernels, on the CPU.

On a layer whose Cin/g is a multiple of 16 the bf16 entries of the
per-layer conv kernel (``trim_conv2d_carry_bf16`` / ``_halo_bf16``) and
the fused-group kernel's bf16 stages run ``mma.sync`` m16n8k16 on the
bf16 tensor cores, every output summed in the one k-order of
``csrc/bf16_mma.cuh``; the other layers keep the fmaf chain (route
``"ffma"``).  The kernels run only on the card (``tests/test_torch_cuda.py``
holds them there); what is checked here is everything around them:

* ``bf16_route`` over VGG-16, AlexNet (its K 11 sub-kernels too),
  ResNet-18, U-Net, a depthwise layer and the input-gradient convs the
  backward launches;
* that a bf16 plan's route and k-steps depend on the layer alone (not on
  N, the dataflow, the tuner's tiles), and that every mma plan fits and
  has the conflict-free pitch;
* the ``BF16_MMA_*`` / ``FUSED_MMA_*`` constants against the ``.cuh`` /
  ``.cu`` they mirror (parsed);
* ``BF16FusedGroup``'s pitches (16-byte rows, an odd count of quads), its
  shared memory and the fused plan of full-width VGG-16 in bf16;
* the autotuner: bf16 records name their route, and one of the fmaf
  chain's design is never read as an mma plan.
"""

import re
from pathlib import Path

import pytest

from repro_torch.core import autotune, conv_plan, fuse_plan
from repro_torch.core.conv_plan import (BF16ConvPlan, ConvPlan,
                                        SMEM_PER_BLOCK, bf16_route,
                                        input_grad_geometry)
from repro_torch.core.fuse_plan import (BF16FusedGroup, FusedGroupPlan,
                                        build_group, stage_layout)
from repro_torch.core.model import ConvLayer, alexnet_layers, vgg16_layers
from repro_torch.core.netplan import graph_nodes
from repro_torch.core.tiling import subkernel_decomposition
from repro_torch.kernels import trim_conv2d_fused as tf
from repro_torch.kernels.ref import conv_pads

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a per-test temp file."""
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


def _problem(layer, n):
    pads = conv_pads(layer.ifmap, layer.ifmap, layer.kernel, layer.stride,
                     "same" if layer.padding else "valid")
    return ((n, layer.ifmap, layer.ifmap, layer.in_channels),
            (layer.kernel, layer.kernel, layer.in_channels // layer.groups,
             layer.out_channels), pads)


def _native(layers):
    return [l for l in layers if l.kernel <= 8]


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,want", [
    ("vgg16", ["ffma"] + ["mma"] * 12),
    ("alexnet", ["ffma"] + ["mma"] * 4),
])
def test_bf16_route_of_the_networks(net, want):
    layers = vgg16_layers() if net == "vgg16" else alexnet_layers()
    assert [bf16_route(l.in_channels // l.groups, l.groups)
            for l in layers] == want


def test_bf16_route_of_alexnet_conv1s_sub_kernels_and_depthwise():
    """AlexNet conv1's K 11 runs as rectangular sub-kernels of Cin 3, each
    on the fmaf chain; a depthwise layer (Cin/g 1) and other narrow
    groups take it too, and so does Cin/g 8 or 24; Cin/g 16, 32, 48 ...
    take the tensor cores."""
    c1 = alexnet_layers()[0]
    for _, _, kh, kw in subkernel_decomposition(c1.kernel, native_k=3):
        plan = ConvPlan.build((8, 227, 227, 3), (kh, kw, 3, 96), stride=4,
                              dtype_bytes=2)
        assert plan.bf16_route == "ffma" and plan.warps_n == 0
    assert bf16_route(1, 32) == "ffma"            # depthwise
    assert [bf16_route(c) for c in (3, 4, 8, 24, 40)] == ["ffma"] * 5
    assert [bf16_route(c) for c in (16, 32, 48, 64, 96, 512)] == \
        ["mma"] * 6
    assert bf16_route(64, 2) == "mma"             # Cin/g 64 of a group


@pytest.mark.parametrize("graph", ["resnet18", "unet"])
def test_bf16_route_of_the_graphs(graph):
    """ResNet-18's and U-Net's convs past their Cin-3 stems run on the
    tensor cores."""
    convs = [nd.layer for nd in graph_nodes(graph) if nd.op == "conv"]
    routes = [bf16_route(l.in_channels // l.groups, l.groups)
              for l in convs]
    assert routes[0] == "ffma" and convs[0].in_channels == 3
    assert routes[1:] == ["mma"] * (len(convs) - 1)


@pytest.mark.parametrize("net", ["vgg16", "alexnet"])
def test_bf16_route_of_the_input_gradient_convs(net):
    """``_TrimConv2dFn``'s dx is a stride-1 conv of the dilated cotangent
    with the transposed weights (Cin/g of it = Cout/g of the layer): its
    plan takes the route of that geometry, like any forward."""
    layers = vgg16_layers() if net == "vgg16" else alexnet_layers()
    for l in _native(layers):
        xs, ws, pads = _problem(l, 2)
        geo = input_grad_geometry(xs, ws, stride=l.stride, pad=pads,
                                  groups=l.groups)
        plan = ConvPlan.build(geo["g_dilated_shape"], geo["wt_shape"],
                              pad=(geo["pad_h"], geo["pad_w"]),
                              groups=l.groups, dtype_bytes=2)
        assert isinstance(plan, BF16ConvPlan)
        assert plan.bf16_route == bf16_route(geo["wt_shape"][2], l.groups)
        assert plan.bf16_route == "mma"        # every Cout is 16 k


# ---------------------------------------------------------------------------
# the per-layer plan
# ---------------------------------------------------------------------------

def _layer_cases():
    return [(net, l.name) for net, layers in (("vgg16", vgg16_layers()),
                                              ("alexnet", alexnet_layers()))
            for l in _native(layers)]


def _layer(net, name):
    layers = vgg16_layers() if net == "vgg16" else alexnet_layers()
    return next(l for l in layers if l.name == name)


@pytest.mark.parametrize("net,name", _layer_cases())
def test_bf16_plan_route_and_k_steps_depend_on_the_layer_alone(net, name):
    """At N 1, 2, 4, 8 and for carry or halo, a bf16 plan's route and
    k-steps are the same (the k-order depends on nothing but the
    element), no plan splits the k axis, and every mma plan has the pitch
    Cin/g + 8 (an odd count of 16-byte quads), fits the shared memory
    and holds its strip in its warps' fragments."""
    l = _layer(net, name)
    seen = set()
    for n in (1, 2, 4, 8):
        xs, ws, pads = _problem(l, n)
        for df in ("carry", "halo"):
            p = ConvPlan.build(xs, ws, stride=l.stride, pad=pads,
                               groups=l.groups, dataflow=df, dtype_bytes=2)
            assert type(p) is BF16ConvPlan and p.route == "bf16"
            seen.add((p.bf16_route, p.k_steps, p.warps_k))
            assert p.smem_bytes <= SMEM_PER_BLOCK
            if p.bf16_route == "mma":
                assert p.tensor_cores and p.warps_k == 1
                assert p.k_steps == l.kernel ** 2 * l.in_channels // 16
                assert p.cin_stride == l.in_channels + 8
                assert (2 * p.cin_stride // 16) % 2 == 1
                assert p.positions <= p.slots == 16 * p.m_frags * p.warps_m
                assert p.tile_cout <= 32 * p.warps_n
                assert p.col_slots % l.stride == 0
                assert p.row_elems % 8 == 0
    assert len(seen) == 1
    route, k_steps, warps_k = seen.pop()
    assert route == bf16_route(l.in_channels, l.groups)
    assert (k_steps, warps_k) == ((l.kernel ** 2 * l.in_channels // 16, 1)
                                  if route == "mma" else (0, 0))


def test_bf16_ffma_plans_are_the_fmaf_chains_plans():
    """Route ffma keeps the plan the fmaf chain had: the f32 planner's
    search at two bytes an element (the pitch Cin/g + 8 where Cin/g % 8 ==
    0, else Cin/g), no warps."""
    p = ConvPlan.build((8, 224, 224, 3), (3, 3, 3, 64), pad=1,
                       dtype_bytes=2)
    assert (p.bf16_route, p.cin_stride, p.warps_n, p.m_frags, p.k_steps) \
        == ("ffma", 3, 0, 0, 0)
    p = ConvPlan.build((2, 20, 20, 24), (3, 3, 24, 32), pad=1,
                       dtype_bytes=2)
    assert (p.bf16_route, p.cin_stride) == ("ffma", 32)
    assert p.smem_bytes == conv_plan._smem_bytes(
        p.ring_rows * p.window_cols * p.cin_stride, p.threads_cout, 2)


def test_bf16_plans_validate_their_route():
    base = ConvPlan.build((2, 12, 12, 16), (3, 3, 16, 32), pad=1,
                          dtype_bytes=2)
    assert base.bf16_route == "mma" and base.warps_k == 1
    import dataclasses
    for bad in (dict(warps_k=2), dict(warps_n=3), dict(m_frags=5),
                dict(tile_cout=64, warps_n=1)):
        with pytest.raises(ValueError, match="bf16 mma route"):
            dataclasses.replace(base, **bad)
    ffma = ConvPlan.build((2, 12, 12, 8), (3, 3, 8, 32), pad=1,
                          dtype_bytes=2)
    with pytest.raises(ValueError, match="ffma route takes no warps"):
        dataclasses.replace(ffma, warps_n=1, warps_k=1, m_frags=1)
    with pytest.raises(ValueError, match="dtype_bytes=2"):
        BF16ConvPlan(n=1, h=8, w=8, cin=16, cout=16, kh=3, kw=3, stride=1,
                     pads=((1, 1), (1, 1)), groups=1, tile_h=1, tile_w=8,
                     tile_cout=16)


def test_bf16_mma_plan_smem_and_row_padding():
    """The mma plan's shared memory is its window ring (rows padded so an
    ldmatrix phase crossing output rows continues the bank-quad sequence)
    + a 3-stage weight ring of 64 (tap, channel) rows + the warps'
    staging, in bf16."""
    p = ConvPlan.build((8, 56, 56, 256), (3, 3, 256, 256), pad=1,
                       dtype_bytes=2)
    assert p.bf16_route == "mma"
    cols = p.col_slots * p.cin_stride
    pad = p.row_elems - cols
    assert pad % 8 == 0 and 0 <= pad < 64
    if pad:
        assert (p.stride * (cols // 8 + pad // 8)
                - p.tile_w * (p.cin_stride // 8)) % 8 == 0
    wp = 32 * p.warps_n + conv_plan.BF16_MMA_ROW_PAD
    assert p.smem_bytes == 2 * (
        -(-p.ring_rows * p.row_elems // 8) * 8
        + conv_plan.BF16_MMA_STAGES * conv_plan.BF16_MMA_STAGE_STEPS * 16 * wp
        + 8 * 16 * conv_plan.BF16_MMA_STAGING_PITCH)
    assert p.row_bytes == 2 * p.row_elems


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("net", ["vgg16", "alexnet"])
def test_bf16_model_winner_is_the_default_plan(net, n):
    """The tuner's model ranks the bf16 plans by the planner's own
    objective, so its winner replays to ``ConvPlan.build``'s default on
    every layer (mma and ffma routes), and its record names the route."""
    layers = vgg16_layers() if net == "vgg16" else alexnet_layers()
    for l in _native(layers):
        xs, ws, pads = _problem(l, n)
        kw = dict(stride=l.stride, pad=pads, groups=l.groups)
        rec = autotune.tune(xs, ws, dtype="bfloat16", device="cpu",
                            write=False, **kw)
        default = ConvPlan.build(xs, ws, dtype_bytes=2, **kw)
        assert rec["route"] == default.bf16_route
        assert ConvPlan.build(xs, ws, tile_h=rec["tile_h"],
                              tile_cout=rec["tile_cout"],
                              dataflow=rec["dataflow"], dtype_bytes=2,
                              **kw) == default, l.name


def test_tuner_candidates_vary_tiles_never_the_k_order():
    xs, ws = (4, 28, 28, 256), (3, 3, 256, 512)
    cands = autotune.candidate_knobs(xs, ws, pad=1, dtype_bytes=2)
    assert len(cands) > 3
    assert {(p.bf16_route, p.k_steps, p.warps_k) for _, p in cands} == \
        {("mma", 9 * 16, 1)}
    assert len({(p.th_out, p.tile_w, p.tile_cout) for _, p in cands}) > 1


def test_bf16_records_name_their_route_and_old_ones_stay_ffma():
    """A bf16 ``conv2d:`` record names its route; one without (the fmaf
    chain's design, before the tensor-core route) is a miss, with a
    warning, on an mma layer, and read on an ffma layer."""
    mma = ((2, 12, 12, 16), (3, 3, 16, 32))
    ffma = ((2, 12, 12, 8), (3, 3, 8, 32))
    kw = dict(pad=1, dtype="bfloat16", device="cpu")
    rec = autotune.tune(*mma, **kw)
    assert rec["route"] == "mma"
    assert autotune.knobs_for(*mma, **kw)["route"] == "mma"
    assert autotune.tune(*ffma, **kw)["route"] == "ffma"
    # the f32 and int8 records are as they were: no route field
    assert "route" not in autotune.tune(*mma, pad=1, device="cpu")
    for shapes, kept in ((mma, False), (ffma, True)):
        key = autotune.make_key(*shapes, pad=1, dtype="bfloat16",
                                device="cpu")
        autotune.store(key, dict(tile_h=2, tile_cout=32, dataflow="halo"))
        autotune.reset_memory_cache()
        if kept:
            assert autotune.knobs_for(*shapes, **kw)["dataflow"] == "halo"
        else:
            with pytest.warns(RuntimeWarning, match="bf16 route 'ffma'"):
                assert autotune.knobs_for(*shapes, **kw) is None


def test_bf16_fused_records_name_their_routes():
    """A bf16 ``conv2d_fused:`` record names its stages' routes; a record
    of the fmaf chain's design on a group with a tensor-core stage is
    rejected and the plan keeps its own tile."""
    layers = [ConvLayer("a", 16, 16, 32, 3, padding=1),
              ConvLayer("b", 8, 32, 32, 3, padding=1)]
    plan = FusedGroupPlan.build(layers, n=2, dtype_bytes=2)
    (g,) = plan.fused_groups
    assert [lay.route for lay in g.layouts] == ["mma", "mma"]
    rec = autotune.tune_fused(layers, n=2, dtype="bfloat16", device="cpu")
    assert rec["routes"] == ["mma", "mma"]
    key = autotune.fused_key(g.signature, n=2, dtype="bfloat16",
                             device="cpu")
    other = 1 if g.strip_rows != 1 else 2
    autotune.store(key, dict(strip_rows=other, band_cols=other))
    autotune.reset_memory_cache()
    with pytest.warns(RuntimeWarning, match="bf16 routes"):
        tuned = FusedGroupPlan.build(layers, n=2, dtype_bytes=2,
                                     use_autotune_cache=True, device="cpu")
    assert tuned.fused_groups[0].strip_rows == g.strip_rows
    autotune.store(key, dict(strip_rows=other, band_cols=other,
                             routes=["mma", "mma"]))
    autotune.reset_memory_cache()
    tuned = FusedGroupPlan.build(layers, n=2, dtype_bytes=2,
                                 use_autotune_cache=True, device="cpu")
    assert tuned.fused_groups[0].strip_rows == other


# ---------------------------------------------------------------------------
# constants against the sources
# ---------------------------------------------------------------------------

def _constexprs(path, known=None) -> dict:
    """The namespace-scope ``constexpr int``s of a source, evaluated
    (``known``: those of the headers it includes)."""
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 path.read_text(), re.M):
        found[name] = eval(expr, {"__builtins__": {}},
                           {**(known or {}), **found})
    return found


def test_bf16_mma_constants_match_the_sources():
    """``bf16_mma.cuh``'s constants and ``trim_conv2d.cu``'s mma-route
    ones against their mirrors in ``core/conv_plan.py`` and
    ``core/fuse_plan.py``; a new constant needs a mirror here."""
    header = _constexprs(CSRC / "bf16_mma.cuh")
    assert header == {
        "kBf16MmaM": conv_plan.BF16_MMA_M,
        "kBf16MmaN": conv_plan.BF16_MMA_N,
        "kBf16MmaK": conv_plan.BF16_MMA_K,
        "kBf16WarpN": conv_plan.BF16_MMA_WARP_N,
        "kBf16RowPad": conv_plan.BF16_MMA_ROW_PAD,
        "kBf16FusedMFrags": fuse_plan.FUSED_MMA_M_FRAGS,
        "kBf16FusedChunk": fuse_plan.FUSED_MMA_CHUNK,
        "kBf16FusedRingSlots": fuse_plan.FUSED_MMA_RING_SLOTS,
    }
    conv = _constexprs(CSRC / "trim_conv2d.cu", header)
    mirrors = {
        "kMmaStagingPitch": conv_plan.BF16_MMA_STAGING_PITCH,
        "kThreads": conv_plan.CONV_THREADS,
        "kWarps": conv_plan.BF16_MMA_WARPS,
        "kMmaMaxMFrags": conv_plan.BF16_MMA_MAX_M_FRAGS,
        "kMmaMFragsTwo": conv_plan.BF16_MMA_M_FRAGS_TWO,
        "kMmaStageSteps": conv_plan.BF16_MMA_STAGE_STEPS,
        "kMmaStages": conv_plan.BF16_MMA_STAGES,
        "kMaxSmemBytes": conv_plan.SMEM_PER_BLOCK,
        "kSmemPerSm": conv_plan.SMEM_PER_SM,
        "kReservedSmem": conv_plan.SMEM_RESERVED_PER_BLOCK,
    }
    assert {k: conv[k] for k in mirrors} == mirrors
    assert conv_plan.BF16_ROUTES == ("ffma", "mma")
    text = (CSRC / "trim_conv2d.cu").read_text()
    assert "enum Bf16Route { kRouteFfma = 0, kRouteMma = 1 };" in text


def test_one_k_loop_for_both_kernels():
    """Both conv kernels include the one header that defines the k-order
    and call its loop; only it issues the mma instruction, and it has one
    shape (m16n8k16) and no k-split."""
    def code(name):        # the source without its comments
        return re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
    header = code("bf16_mma.cuh")
    assert re.findall(r"mma\.sync\.\S+", header) == [
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"]
    for name in ("trim_conv2d.cu", "trim_conv2d_fused.cu"):
        text = code(name)
        assert '#include "bf16_mma.cuh"' in text
        assert "bf16_mma_steps<" in text and "KStep" in text
        assert "mma.sync" not in text


# ---------------------------------------------------------------------------
# the fused plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_bf16_fused_group_pitches_and_smem(n):
    """Full-width VGG-16's bf16 plan still fuses groups; every stage on
    the tensor cores has 16-byte rows with an odd count of quads, whole
    pool windows a thread, warps along C_out 1, 2 or 4; both buffers and
    the ring start 16-byte aligned and everything fits 232,448 bytes."""
    plan = FusedGroupPlan.build("vgg16", n=n, dtype_bytes=2)
    assert plan.fused_groups
    for g in plan.fused_groups:
        assert isinstance(g, BF16FusedGroup)
        assert g.smem_bytes <= SMEM_PER_BLOCK
        assert all(b % 8 == 0 for b in g.buffer_elems)
        for st, lay in zip(g.stages, g.layouts):
            assert lay.route == bf16_route(st.cin)
            assert lay.ring_row <= g.ring_cout
            assert st.in_rows * st.in_cols * lay.pitch <= lay.in_tile_elems
            if lay.route == "ffma":
                assert lay == stage_layout(st, 4)
                continue
            assert lay.pitch == st.cin + 8
            assert (2 * lay.pitch) % 16 == 0 and (2 * lay.pitch // 16) % 2
            assert lay.per_thread == 8 // st.pool_window ** 2 >= 1
            wn = -(-lay.tile_cout // 32)
            assert lay.ring_row == 32 * (4 if wn == 3 else wn) + 8
        assert g.ring_elems == max(
            lay.ring_row * (2 * 64 if lay.route == "mma" else 2 * 32)
            for lay in g.layouts)
        assert g.smem_bytes == 2 * (sum(g.buffer_elems) + g.ring_elems)


def test_bf16_fused_geometry_carries_the_layouts():
    """``kernel_geometry`` of a bf16 group writes each stage's layout
    (tile, pitch); an f32 group's is unchanged (FusedStage's own)."""
    topo = [ConvLayer("c0", 12, 3, 16, 3, padding=1),
            ConvLayer("c1", 6, 16, 48, 3, padding=1),
            ConvLayer("c2", 6, 48, 24, 3, padding=1)]
    g2 = build_group(topo, 0, n=2, strip_rows=2, band_cols=3,
                     dtype_bytes=2)
    g4 = build_group(topo, 0, n=2, strip_rows=2, band_cols=3)
    hn, fn = tf.GEOM_HEADER, tf.GEOM_STAGE_FIELDS
    geo2, geo4 = tf.kernel_geometry(g2), tf.kernel_geometry(g4)
    assert [lay.route for lay in g2.layouts] == ["ffma", "mma", "mma"]
    for i, (st, lay) in enumerate(zip(g2.stages, g2.layouts)):
        assert geo2[hn + fn * i + fn - 2:hn + fn * (i + 1)] == \
            [lay.tile_cout, lay.pitch]
        assert geo4[hn + fn * i + fn - 2:hn + fn * (i + 1)] == \
            [st.tile_cout, st.cin_pitch]
    assert geo2[7:9] == list(g2.buffer_elems)


def test_bf16_fused_stage_with_a_3x3_pool_on_the_tensor_cores_does_not_fuse():
    """A thread's 8 fragment rows hold no 3 x 3 pool window: a route-mma
    stage that pools 3/2 (AlexNet's conv2, Cin 96) takes no tile, and the
    plan runs it per layer."""
    layers = alexnet_layers()[1:3]            # conv2 -> pool 3/2 -> conv3
    lay = build_group(layers, 1, n=1, pools=[(2, 3), (1, 1)],
                      dtype_bytes=2).layouts[0]
    assert lay.route == "mma" and lay.per_thread == 0
    assert FusedGroupPlan._tune_group(
        layers, [(2, 3), (1, 1)], 0, 2, n=1, dtype_bytes=2) is None
    plan = FusedGroupPlan.build("alexnet", n=8, dtype_bytes=2)
    assert all(g.stages[0].name != "conv2" for g in plan.fused_groups)
