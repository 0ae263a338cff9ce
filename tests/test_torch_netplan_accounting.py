"""The port's network accounting (``core/netplan.py``) against the JAX
package's and against its own plans.

* the paper's §V comparison (``arch_compare``) of ``NetworkPlan``
  (VGG-16, AlexNet, MobileNet) and ``NetworkGraph`` (ResNet-18, U-Net)
  equals JAX's exactly;
* at JAX's 8 MiB ``residency_budget`` (and under "never" / "always")
  every residency and pool decision equals JAX's;
* "auto" without a budget keeps exactly the fused groups' interior
  boundaries resident;
* "never" with ``fold_pooling=False`` is the sum of the port's
  ``ConvPlan.hbm_bytes()``; a linear name built as a graph is the chain;
* for every layer, ``"3dtrim"`` <= the plan's own bytes <= ``"trim"``,
  and ``"trim"`` is the halo plan's bytes at the same tiles;
* the topology checks of ``build`` raise as JAX's do.
"""

import dataclasses

import pytest

from repro.core import netplan as jnp_plan
from repro.core.model import ConvLayer as JConvLayer
from repro.core.model import GraphNode as JGraphNode
from repro_torch.core import netplan as tnp
from repro_torch.core.fuse_plan import FusedGroupPlan, graph_segments
from repro_torch.core.model import ConvLayer, GraphNode
from repro_torch.kernels.trim_conv2d import hbm_traffic_model

NETS = ("vgg16", "alexnet", "mobilenet")
GRAPHS = ("resnet18", "unet")
BUDGET = 8 << 20            # JAX's RESIDENCY_BUDGET (the TPU's VMEM)
MODES = (None, "3dtrim", "trim")


def _flags(steps):
    return [(s.name, s.resident_in, s.resident_out, getattr(s, "pool", 1),
             getattr(s, "pool_window", 1), s.out_size) for s in steps]


def _join_flags(steps):
    return [(s.name, s.resident_ins, s.in_bytes) for s in steps
            if getattr(s, "op", "conv") != "conv"]


def test_jax_budget_is_the_tpu_s():
    assert jnp_plan.RESIDENCY_BUDGET == BUDGET


@pytest.mark.parametrize("net", NETS)
def test_network_plan_arch_compare_equals_jax(net):
    assert tnp.NetworkPlan.build(net).arch_compare() == \
        jnp_plan.NetworkPlan.build(net).arch_compare()


@pytest.mark.parametrize("net", GRAPHS)
def test_network_graph_arch_compare_equals_jax(net):
    assert tnp.NetworkGraph.build(net).arch_compare() == \
        jnp_plan.NetworkGraph.build(net).arch_compare()


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("residency", ["auto", "never", "always"])
@pytest.mark.parametrize("net", NETS)
def test_chain_residency_equals_jax_at_its_budget(net, residency, n):
    kw = dict(n=n, residency=residency, residency_budget=BUDGET)
    t, j = tnp.NetworkPlan.build(net, **kw), jnp_plan.NetworkPlan.build(
        net, **kw)
    assert _flags(t.steps) == _flags(j.steps)
    assert (t.macs, t.ops, t.n_layers) == (j.macs, j.ops, j.n_layers)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("residency", ["auto", "never", "always"])
@pytest.mark.parametrize("net", GRAPHS)
def test_graph_residency_equals_jax_at_its_budget(net, residency, n):
    kw = dict(n=n, residency=residency, residency_budget=BUDGET)
    t, j = tnp.NetworkGraph.build(net, **kw), jnp_plan.NetworkGraph.build(
        net, **kw)
    assert [dataclasses.asdict(e) for e in t.edges] == \
        [dataclasses.asdict(e) for e in j.edges]
    assert t.edge_rows() == j.edge_rows()
    assert _flags(t.steps) == _flags(j.steps)
    assert _join_flags(t.steps) == _join_flags(j.steps)
    assert t.boundary_occupancy() == j.boundary_occupancy()
    assert t.spilled_edge_bytes == j.spilled_edge_bytes
    assert (t.macs, t.n_nodes) == (j.macs, j.n_nodes)
    if residency == "auto":
        assert max(t.boundary_occupancy()) <= BUDGET


@pytest.mark.parametrize("dtype_bytes", [4, 2, 1])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("net", NETS)
def test_auto_keeps_the_fused_groups_interior_resident(net, n,
                                                       dtype_bytes):
    """The card keeps an activation on chip only inside a fused group:
    "auto" marks exactly those boundaries resident (none at int8, which
    has no fused kernel)."""
    plan = tnp.NetworkPlan.build(net, n=n, dtype_bytes=dtype_bytes)
    want = set()
    if dtype_bytes != 1:
        groups = FusedGroupPlan.build(net, n=n, dtype_bytes=dtype_bytes)
        want = {i for g in groups.groups if g.fused
                for i in range(g.start, g.start + g.depth - 1)}
    assert {s.index for s in plan.steps if s.resident_out} == want
    if net == "vgg16" and dtype_bytes == 4:
        assert want        # the plan fuses conv1..conv2 at least


@pytest.mark.parametrize("net", GRAPHS)
def test_graph_auto_keeps_the_fused_groups_edges_resident(net):
    g = tnp.NetworkGraph.build(net, n=8)
    want = set()
    for names, layers in graph_segments(tnp.graph_nodes(net)):
        plan = FusedGroupPlan.build(list(layers), n=8)
        for grp in plan.groups:
            if grp.fused:
                a = names.index(layers[grp.start].name)
                b = names.index(layers[grp.start + grp.depth - 1].name)
                want |= set(zip(names[a:b], names[a + 1:b + 1]))
    assert {(e.producer, e.consumer) for e in g.edges if e.resident} == want
    assert g.residency_budget is None


@pytest.mark.parametrize("net", NETS + GRAPHS)
def test_never_unfolded_is_the_sum_of_the_plans(net):
    kw = dict(n=4, residency="never", fold_pooling=False)
    build = tnp.NetworkGraph.build if net in GRAPHS else \
        tnp.NetworkPlan.build
    plan = build(net, **kw)
    for mode in MODES:
        tot = dict(input=0, weights=0, output=0)
        for s in plan.steps:
            if s.plan is None:
                continue
            b = s.plan.hbm_bytes(mode)
            for k in tot:
                tot[k] += b[k]
        joins = sum(s.hbm_bytes(mode)["total"] for s in plan.steps
                    if s.plan is None)
        got = plan.hbm_bytes(mode)
        assert got["weights"] == tot["weights"]
        assert got["total"] == sum(tot.values()) + joins
        assert sorted(got) == ["input", "output", "total", "weights"]


@pytest.mark.parametrize("budget", [None, BUDGET, 0])
@pytest.mark.parametrize("net", NETS)
def test_linear_name_as_a_graph_is_the_chain(net, budget):
    chain = tnp.NetworkPlan.build(net, n=2, residency_budget=budget)
    graph = tnp.NetworkGraph.build(net, n=2, residency_budget=budget)
    assert _flags(chain.steps) == _flags(graph.steps)
    for mode in MODES:
        assert chain.hbm_bytes(mode) == graph.hbm_bytes(mode)
        assert chain.accesses(mode) == graph.accesses(mode)
        assert chain.as_rows(mode) == graph.as_rows(mode)
    assert chain.arch_compare() == dict(graph.arch_compare(), network=net)
    assert chain.compare()["layers"] == graph.compare()["layers"]


def _every_layer():
    out = [(net, l) for net in NETS for l in tnp.network_layers(net)]
    out += [(g, nd.layer) for g in GRAPHS for nd in tnp.graph_nodes(g)
            if nd.op == "conv"]
    return out


LAYERS = _every_layer()


@pytest.mark.parametrize("net,layer", LAYERS,
                         ids=[f"{n}-{l.name}" for n, l in LAYERS])
def test_modes_bracket_the_plan_and_trim_is_halo(net, layer):
    for n in (1, 8):
        for db in (4, 2):
            plan = layer.plan(n=n, dtype_bytes=db)
            lo, own, hi = (plan.hbm_bytes(m)["total"]
                           for m in ("3dtrim", None, "trim"))
            assert lo <= own <= hi
            assert plan.hbm_bytes() == plan.hbm_bytes(None)
            assert plan.halo_rows("3dtrim") == 0
            halo = dataclasses.replace(plan, dataflow="halo")
            assert plan.hbm_bytes("trim") == halo.hbm_bytes()
            assert halo.traffic_mode() == "trim" or plan.n_strips == 1
            assert plan.arithmetic_intensity("3dtrim") >= \
                plan.arithmetic_intensity("trim")


def test_hbm_traffic_model_is_the_plans():
    for mode in MODES:
        assert hbm_traffic_model(2, 28, 28, 64, 128, 3, pad=1,
                                 mode=mode) == \
            ConvLayer("x", 28, 64, 128, 3, padding=1).plan(n=2).hbm_bytes(
                mode)
    with pytest.raises(ValueError, match="mode"):
        hbm_traffic_model(1, 8, 8, 4, 4, 3, mode="eyeriss")


def _broken_chains(C):
    return [
        "resnet50",
        [C("a", 16, 3, 8, kernel=3, padding=1),
         C("b", 16, 4, 8, kernel=3, padding=1)],
        [C("a", 16, 3, 8, kernel=3, padding=1),
         C("b", 32, 8, 8, kernel=3, padding=1)],
        [],
    ]


def _broken_graphs(C, G):
    l = C("x", 8, 3, 4, kernel=3, padding=1)
    l4 = C("y", 8, 4, 4, kernel=3, padding=1)
    return [
        [G("a", "conv", (), l), G("a", "conv", ("a",), l4)],
        [G("a", "conv", ("missing",), l)],
        [G("a", "conv", (), l), G("b", "conv", ("a", "a"), l4)],
        [G("a", "conv", (), l), G("b", "conv", ("a",), l)],
        [G("a", "conv", (), l), G("p", "pool", ("a",), pool=2,
                                   pool_window=9)],
        [G("a", "conv", (), l), G("s", "add", ("a",))],
        [G("a", "conv", (), l), G("p", "pool", ("a",), pool=2,
                                   pool_window=2),
         G("s", "concat", ("a", "p"))],
        [G("a", "conv", (), l), G("b", "conv", ("a",), C(
            "z", 8, 4, 3, kernel=3, padding=1)),
         G("s", "add", ("a", "b"))],
        [G("a", "conv", (), l), G("b", "conv", (), l)],
        "vgg19",
        [],
    ]


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_chain_build_checks_raise_as_jax():
    for t, j in zip(_broken_chains(ConvLayer), _broken_chains(JConvLayer)):
        assert _raised(lambda: tnp.NetworkPlan.build(t)) == \
            _raised(lambda: jnp_plan.NetworkPlan.build(j))
    assert _raised(lambda: tnp.NetworkPlan.build(
        "vgg16", residency="sometimes")) == _raised(
        lambda: jnp_plan.NetworkPlan.build("vgg16", residency="sometimes"))


def test_graph_build_checks_raise_as_jax():
    cases = zip(_broken_graphs(ConvLayer, GraphNode),
                _broken_graphs(JConvLayer, JGraphNode))
    for t, j in cases:
        assert _raised(lambda: tnp.NetworkGraph.build(t)) == \
            _raised(lambda: jnp_plan.NetworkGraph.build(j))
    assert _raised(lambda: tnp.NetworkGraph.build(
        "unet", residency="x")) == _raised(
        lambda: jnp_plan.NetworkGraph.build("unet", residency="x"))


def test_compare_reports_the_card_s_schedule():
    """The card's strip-level image of the trade: per layer 3dtrim
    moves no more than trim, so every ratio is >= 1."""
    for net in NETS + GRAPHS:
        build = tnp.NetworkGraph.build if net in GRAPHS else \
            tnp.NetworkPlan.build
        c = build(net, n=8).compare()
        assert c["improvement"] >= 1.0
        assert all(r["improvement"] >= 1.0 for r in c["layers"])
        assert all(r["segments"] <= r["strips"] for r in c["layers"])
