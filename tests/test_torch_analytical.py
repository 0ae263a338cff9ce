"""The port's paper model against the JAX package's, on the same inputs,
compared with ``==``: Fig. 1's curve, Fig. 6 (VGG-16, AlexNet,
MobileNet), the per-layer access counts and Fig. 6 bar pairs of every
conv layer of the five topologies, Table I and the energy model, the
cycle-stepped slice simulator (outputs and every counter, both modes,
the Fig. 5 trace) over a seeded sweep of small shapes, and the core's
IRB sharing.  All pure Python and numpy, in milliseconds."""

import dataclasses

import numpy as np
import pytest

from repro.core import dataflow as jdf
from repro.core import energy as jen
from repro.core import model as jm
from repro.core import netplan as jnp_plan
from repro_torch.core import dataflow as tdf
from repro_torch.core import energy as ten
from repro_torch.core import model as tm
from repro_torch.core import netplan as tnp

NETS = ("vgg16", "alexnet", "mobilenet")
GRAPHS = ("resnet18", "unet")


def _conv_layers():
    """(network, port layer) for every conv layer of the five
    topologies."""
    out = [(net, l) for net in NETS for l in tnp.network_layers(net)]
    out += [(g, nd.layer) for g in GRAPHS for nd in tnp.graph_nodes(g)
            if nd.op == "conv"]
    return out


LAYERS = _conv_layers()


def _jax_layer(layer):
    return jm.ConvLayer(**dataclasses.asdict(layer))


def _hw(name):
    return {"3d-trim": (tm.TRIM_3D, jm.TRIM_3D),
            "trim": (tm.TRIM, jm.TRIM)}[name]


def test_configurations_and_topologies_are_jax_s():
    assert dataclasses.asdict(tm.TRIM_3D) == dataclasses.asdict(jm.TRIM_3D)
    assert dataclasses.asdict(tm.TRIM) == dataclasses.asdict(jm.TRIM)
    for t, j in ((tm.TRIM_3D, jm.TRIM_3D), (tm.TRIM, jm.TRIM)):
        assert (t.pes, t.peak_tops) == (j.pes, j.peak_tops)
    for net in NETS:
        assert [dataclasses.asdict(l) for l in tnp.network_layers(net)] == \
            [dataclasses.asdict(l) for l in jnp_plan.network_layers(net)]


@pytest.mark.parametrize("kernel", [2, 3, 5])
def test_fig1_curve_equals_jax(kernel):
    sizes = (7, 14, 28, 56, 112, 224)
    assert tm.fig1_curve(sizes, kernel) == jm.fig1_curve(sizes, kernel)
    assert tm.fig1_curve() == jm.fig1_curve()
    for s in sizes:
        for stride in (1, 2, 4):
            for shadow in (True, False):
                assert tm.ifmap_reads_per_channel(
                    s, s + 3, kernel, stride, shadow=shadow) == \
                    jm.ifmap_reads_per_channel(s, s + 3, kernel, stride,
                                               shadow=shadow)
            assert tm.ifmap_overhead_pct(s, kernel, stride) == \
                jm.ifmap_overhead_pct(s, kernel, stride)


@pytest.mark.parametrize("net", NETS)
def test_fig6_equals_jax(net):
    assert tm.fig6(net) == jm.fig6(net)


@pytest.mark.parametrize("net,layer", LAYERS,
                         ids=[f"{n}-{l.name}" for n, l in LAYERS])
def test_layer_accesses_and_compare_layer_equal_jax(net, layer):
    jl = _jax_layer(layer)
    assert (layer.out_size, layer.macs, layer.ops, layer.label()) == \
        (jl.out_size, jl.macs, jl.ops, jl.label())
    for name in ("3d-trim", "trim"):
        th, jh = _hw(name)
        a, b = tm.layer_accesses(layer, th), jm.layer_accesses(jl, jh)
        assert (a.ifmap_reads, a.weight_reads, a.total, a.ops_per_access,
                a.ops_per_access_per_slice) == \
            (b.ifmap_reads, b.weight_reads, b.total, b.ops_per_access,
             b.ops_per_access_per_slice)
    assert tm.compare_layer(layer) == jm.compare_layer(jl)
    assert tm.compare_layer(layer, tm.TRIM, tm.TRIM_3D) == \
        jm.compare_layer(jl, jm.TRIM, jm.TRIM_3D)
    assert tm.im2col_ifmap_reads(layer) == jm.im2col_ifmap_reads(jl)
    assert tm.gemm_accesses(layer) == jm.gemm_accesses(jl)
    assert tm.gemm_accesses(layer, 4) == jm.gemm_accesses(jl, 4)
    assert tm.num_subkernels(layer.kernel) == jm.num_subkernels(jl.kernel)


def test_table1_equals_jax():
    assert ten.table1() == jen.table1()
    assert [dataclasses.asdict(d) for d in ten.TABLE1_DESIGNS] == \
        [dataclasses.asdict(d) for d in jen.TABLE1_DESIGNS]
    assert ten.ENERGY_PJ == jen.ENERGY_PJ
    for pes, f in ((576, 1.0), (168, 0.2), (65536, 1.05)):
        assert ten.peak_tops(pes, f) == jen.peak_tops(pes, f)


@pytest.mark.parametrize("net,layer", LAYERS,
                         ids=[f"{n}-{l.name}" for n, l in LAYERS])
def test_energy_per_layer_equals_jax(net, layer):
    jl = _jax_layer(layer)
    for name in ("3d-trim", "trim"):
        th, jh = _hw(name)
        for db, mac in ((1, "mac_int8"), (4, "mac_fp32")):
            assert ten.energy_per_layer(layer, th, dtype_bytes=db,
                                        mac=mac) == \
                jen.energy_per_layer(jl, jh, dtype_bytes=db, mac=mac)


@pytest.mark.parametrize("net", NETS + GRAPHS)
def test_energy_per_inference_equals_jax(net):
    for name in ("3d-trim", "trim"):
        th, jh = _hw(name)
        assert ten.energy_per_inference(net, th) == \
            jen.energy_per_inference(net, jh)
        assert ten.energy_per_inference(net, th, dtype_bytes=4,
                                        mac="mac_fp32") == \
            jen.energy_per_inference(net, jh, dtype_bytes=4, mac="mac_fp32")


def test_energy_per_inference_refuses_an_unknown_network_as_jax():
    with pytest.raises(ValueError) as t:
        ten.energy_per_inference("resnet50")
    with pytest.raises(ValueError) as j:
        jen.energy_per_inference("resnet50")
    assert str(t.value) == str(j.value)


def _sim_cases():
    """A seeded sweep of small slices: K 2-4, H from K to K + 5, W from
    2K to 2K + 6 (the IRB layout's least width), both modes."""
    rng = np.random.default_rng(38)
    cases = []
    for k in (2, 3, 4):
        for _ in range(4):
            h = int(rng.integers(k, k + 6))
            w = int(rng.integers(2 * k, 2 * k + 7))
            cases.append((k, h, w, int(rng.integers(0, 2**31))))
    return cases


SIM_CASES = _sim_cases()


@pytest.mark.parametrize("mode", ["3dtrim", "trim"])
@pytest.mark.parametrize("k,h,w,seed", SIM_CASES,
                         ids=[f"k{c[0]}-{c[1]}x{c[2]}" for c in SIM_CASES])
def test_slice_sim_outputs_and_counters_equal_jax(mode, k, h, w, seed):
    rng = np.random.default_rng(seed)
    ifmap = rng.standard_normal((h, w))
    weights = rng.standard_normal((k, k))
    t_out, t_stats = tdf.TrimSliceSim(k, mode).run(ifmap, weights)
    j_out, j_stats = jdf.TrimSliceSim(k, mode).run(ifmap, weights)
    assert np.array_equal(t_out, j_out)
    assert dataclasses.asdict(t_stats) == dataclasses.asdict(j_stats)
    assert (t_stats.ops, t_stats.ops_per_memory_access) == \
        (j_stats.ops, j_stats.ops_per_memory_access)
    assert t_stats.memory_reads == \
        tdf.TrimSliceSim(k, mode).expected_memory_reads(h, w) == \
        jdf.TrimSliceSim(k, mode).expected_memory_reads(h, w)
    ref = tdf.reference_conv2d_valid(ifmap, weights)
    assert np.array_equal(ref, jdf.reference_conv2d_valid(ifmap, weights))
    np.testing.assert_allclose(t_out, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["3dtrim", "trim"])
def test_slice_sim_trace_equals_jax(mode):
    """The Fig. 5 schedule step by step: every PE register (NaN empty),
    each injection's source, the shift and shadow registers."""
    rng = np.random.default_rng(5)
    ifmap = rng.standard_normal((6, 9))
    weights = rng.standard_normal((3, 3))
    ts, js = tdf.TrimSliceSim(3, mode, True), jdf.TrimSliceSim(3, mode, True)
    ts.run(ifmap, weights)
    js.run(ifmap, weights)
    assert len(ts.trace) == len(js.trace) == 4 * 9
    for a, b in zip(ts.trace, js.trace):
        assert (a.band, a.step, a.sources, a.shift_regs, a.shadow_regs) == \
            (b.band, b.step, b.sources, b.shift_regs, b.shadow_regs)
        assert np.array_equal(a.pe_values, b.pe_values, equal_nan=True)


def test_slice_sim_refusals_match_jax():
    for sim in (tdf.TrimSliceSim, jdf.TrimSliceSim):
        with pytest.raises(ValueError, match="unknown mode"):
            sim(3, "eyeriss")


@pytest.mark.parametrize("shared", [None, True, False])
@pytest.mark.parametrize("mode", ["3dtrim", "trim"])
def test_core_conv_reads_and_outputs_equal_jax(mode, shared):
    rng = np.random.default_rng(7)
    ifmap = rng.standard_normal((7, 10))
    stack = rng.standard_normal((4, 3, 3))
    t_out, t_reads = tdf.core_conv(ifmap, stack, mode, shared)
    j_out, j_reads = jdf.core_conv(ifmap, stack, mode, shared)
    assert np.array_equal(t_out, j_out) and t_reads == j_reads
    one = tdf.TrimSliceSim(3, mode).run(ifmap, stack[0])[1].memory_reads
    share = mode == "3dtrim" if shared is None else shared
    assert t_reads == (one if share else 4 * one)
