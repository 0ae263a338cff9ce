"""DAG topologies (ResNet-18, U-Net) in the port against the JAX package
on the CPU: the graph builders, ``scale_graph`` and ``graph_segments``
node for node; the graph executor ``cnn_apply_from_graph`` per node
(carry and halo), fused (by segment, and on a prebuilt
``GraphFusePlan``), packed, with its head and under grad; ``tune_graph``;
``TrimCNN`` on a graph.

The graphs are sized as ``tests/test_netgraph.py``'s ``tiny_graph``:
ResNet-18 at a 32 x 32 image and base 8, channels scaled by 2, and U-Net
at 16 x 16, base 4, depth 2; batch 2, inputs from a numpy seed, params
from the JAX ``init_params`` carried over by ``params_from_jax``.  The
JAX outputs are made once per module: the forward on the Pallas carry
kernel in interpret mode (``guard.events()`` stays empty; the JAX fused
and halo kernels fail here with ``pl.unblocked``), the head and the
gradients on ``impl="ref"``.  Tolerance: 1e-5 of max|JAX| (f32 sums in
another order).  Fused, prebuilt-plan, halo and packed outputs are held
to the per-node output bitwise: on the CPU every wrapper runs its plain
version, and the fused one takes each tap's product as the per-layer one
does.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guard
from repro.core import autotune as jautotune
from repro.core import fuse_plan as jfuse_plan
from repro.core import model as jmodel
from repro.core import netplan as jnetplan
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro_torch.convert import params_from_jax
import repro_torch.core.model as pmodel
import repro_torch.core.netplan as pnetplan
from repro_torch.core import autotune
from repro_torch.core.fuse_plan import (FusedGroupPlan, GraphFusePlan,
                                        build_group, graph_segments)
from repro_torch.core.model import (ConvLayer, GraphNode, resnet18_graph,
                                    unet_graph)
from repro_torch.core.netplan import (GRAPHS, graph_nodes,
                                      linear_graph_nodes, scale_graph)
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.models import layers

TOL = 1e-5
NETS = ("resnet18", "unet")
CLASSES = 5


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a per-test temp file: no test reads
    or writes a cache outside it."""
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


def tiny(net, pkg):
    """``tests/test_netgraph.py``'s execution-sized graphs, from either
    package (``pkg`` its ``(model, netplan)`` modules)."""
    model, netplan = pkg
    if net == "resnet18":
        return netplan.scale_graph(model.resnet18_graph(image=32, base=8), 2)
    return model.unet_graph(image=16, base=4, depth=2)


JAX = (jmodel, jnetplan)
PORT = (pmodel, pnetplan)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _loss_weights(net):
    return np.random.default_rng(11).standard_normal((2, CLASSES)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Per net: the JAX tiny graph, its params (with a 5-class head), the
    input, the headless forward on the Pallas carry kernel (interpret),
    the logits on ``impl="ref"`` and ``jax.grad`` of ``sum(logits * c)``
    in x and the params (gelu, ``impl="ref"``)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(jautotune.CACHE_ENV,
                  str(tmp_path_factory.mktemp("jax") / "convtune.json"))
        jautotune.reset_memory_cache()
        for i, net in enumerate(NETS):
            jnodes = tiny(net, JAX)
            params = jax.tree.map(np.asarray, jinit(
                jlayers.cnn_params_from_graph(jnodes, n_classes=CLASSES),
                jax.random.PRNGKey(i)))
            src = jnodes[0].layer
            x = np.random.default_rng(i).standard_normal(
                (2, src.ifmap, src.ifmap, src.in_channels)).astype(np.float32)
            jp = jax.tree.map(jnp.asarray, params)
            headless = {k: v for k, v in jp.items() if k != "head"}
            guard.reset()
            feat = np.asarray(jlayers.cnn_apply_from_graph(
                headless, jnodes, jnp.asarray(x), impl="pallas"))
            events = list(guard.events())
            logits = np.asarray(jlayers.cnn_apply_from_graph(
                jp, jnodes, jnp.asarray(x), impl="ref"))
            c = jnp.asarray(_loss_weights(net))

            def loss(p, xx):
                return jnp.sum(jlayers.cnn_apply_from_graph(
                    p, jnodes, xx, impl="ref", activation="gelu") * c)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                jp, jnp.asarray(x))
            out[net] = dict(jnodes=jnodes, params=params, x=x, feat=feat,
                            events=events, logits=logits,
                            gp=jax.tree.map(np.asarray, gp),
                            gx=np.asarray(gx))
        jautotune.reset_memory_cache()
    return out


def _asdict(nodes):
    return [dataclasses.asdict(nd) for nd in nodes]


def _headless(tree):
    return {k: v for k, v in tree.items() if k != "head"}


# ---------------------------------------------------------------------------
# (a) topology, (b) segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("net", NETS)
def test_graphs_equal_jax_node_for_node(net, size):
    if size == "full":
        mine, theirs = graph_nodes(net), jnetplan.graph_nodes(net)
    else:
        mine, theirs = tiny(net, PORT), tiny(net, JAX)
    assert [nd.name for nd in mine] == [nd.name for nd in theirs]
    assert _asdict(mine) == _asdict(theirs)
    assert _asdict(scale_graph(mine, 4)) == _asdict(
        jnetplan.scale_graph(theirs, 4))
    assert _asdict(GRAPHS[net]()) == _asdict(jnetplan.GRAPHS[net]())


def test_graph_defaults_and_linear_chains_equal_jax():
    r18, unet = resnet18_graph(), unet_graph()
    assert len(r18) == 29 and sum(nd.op == "conv" for nd in r18) == 20
    assert len(unet) == 19 and sum(nd.op == "conv" for nd in unet) == 13
    assert sum(nd.layer.macs for nd in r18 if nd.op == "conv") \
        == 1_813_561_344          # 1.814 GMAC an image
    for net in ("vgg16", "alexnet", "mobilenet"):
        assert _asdict(linear_graph_nodes(net)) == _asdict(
            jnetplan.linear_graph_nodes(net))
        assert _asdict(graph_nodes(net)) == _asdict(jnetplan.graph_nodes(net))
    with pytest.raises(ValueError, match="unknown network"):
        graph_nodes("resnet50")


def test_graph_node_checks():
    l = ConvLayer("c", 8, 3, 4, 3, padding=1)
    with pytest.raises(ValueError, match="unknown op"):
        GraphNode("x", "mul", ("c",))
    with pytest.raises(ValueError, match="requires"):
        GraphNode("c", "conv")
    with pytest.raises(ValueError, match="forbids"):
        GraphNode("p", "pool", ("c",), l)
    with pytest.raises(ValueError, match="needs inputs"):
        GraphNode("a", "add")
    with pytest.raises(ValueError, match="divisible"):
        unet_graph(image=18, depth=2)


def _segments_as_dicts(segs):
    return [(names, [dataclasses.asdict(l) for l in ls])
            for names, ls in segs]


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("net", NETS)
def test_graph_segments_equal_jax(net, size):
    if size == "full":
        mine, theirs = graph_nodes(net), jnetplan.graph_nodes(net)
    else:
        mine, theirs = tiny(net, PORT), tiny(net, JAX)
    segs = graph_segments(mine)
    assert _segments_as_dicts(segs) == _segments_as_dicts(
        jfuse_plan.graph_segments(theirs))
    covered = [nm for names, _ in segs for nm in names]
    convs = [nd.name for nd in mine if nd.op == "conv"]
    assert len(covered) == len(set(covered)) and set(convs) <= set(covered)


def test_graph_segments_break_on_unrecoverable_pool():
    """``tests/test_netgraph.py``'s case: a 2x2/s3 pool between convs
    (re-inferred as 4x4/s3) bounds the segment; a 2x2/s2 pool is
    absorbed.  Both packages agree."""
    def case(m, pool):
        a = m.ConvLayer("a", 10, 3, 4, kernel=3, padding=1)
        b = m.ConvLayer("b", 3 if pool == 3 else 5, 4, 4, kernel=3,
                        padding=1)
        return [m.GraphNode("a", "conv", (), a),
                m.GraphNode("p", "pool", ("a",), pool=pool, pool_window=2),
                m.GraphNode("b", "conv", ("p",), b)]

    for pool, want in ((3, [("a",), ("b",)]), (2, [("a", "p", "b")])):
        segs = graph_segments(case(pmodel, pool))
        assert [names for names, _ in segs] == want
        assert _segments_as_dicts(segs) == _segments_as_dicts(
            jfuse_plan.graph_segments(case(jmodel, pool)))
    nodes = case(pmodel, 2)
    tree = params_from_jax(jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_graph(case(jmodel, 2)),
        jax.random.PRNGKey(4))))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 10, 10, 3)).astype(np.float32))
    per_node = layers.cnn_apply_from_graph(tree, nodes, x)
    plan = GraphFusePlan.build(nodes, n=2, max_depth=1)
    assert torch.equal(per_node, layers.cnn_apply_from_graph(
        tree, nodes, x, fused=True))
    assert torch.equal(per_node, layers.cnn_apply_from_graph(
        tree, nodes, x, fuse_plan=plan))


@pytest.mark.parametrize("n", [1, 8])
def test_full_width_plans_fuse_resnet_layer1_and_unet_groups(n):
    """Full-width ResNet-18 fuses only layer1's two no-pool pairs (3x3,
    64 channels, 56 x 56); the stride-2 blocks run per layer.  U-Net at
    the JAX defaults fuses four segments, one of them dec0a..out, whose
    last stage is the 1x1 head."""
    plan = GraphFusePlan.build("resnet18", n=n)
    assert plan.n_segments == 12
    assert sum(len(names) == 2 for names, _ in plan.segments) == 8
    fused = [g for g in plan.groups if g.fused]
    assert [g.label for g in fused] == ["l1b0_conv1..l1b0_conv2",
                                        "l1b1_conv1..l1b1_conv2"]
    assert all(not st.pooled and st.cin == 64 and st.h_in == 56
               for g in fused for st in g.stages)
    s = plan.summary()
    assert s["fused_layers"] == 4 and s["executed_ratio"] > 1.0
    assert plan.flops == 2 * plan.macs == sum(g.flops for g in plan.groups)
    assert len(plan.as_rows()) == len(plan.groups)
    unet = GraphFusePlan.build("unet", n=n)
    fused = [g for g in unet.groups if g.fused]
    assert [g.label for g in fused] == ["enc0a..enc0b", "enc1a..enc1b",
                                        "mid_a..mid_b", "dec0a..out"]
    assert fused[-1].depth == 3 and fused[-1].last.kernel == 1
    assert unet.executed_hbm_bytes()["total"] < unet.never_hbm_bytes()


# ---------------------------------------------------------------------------
# (c) forward, (d) fused / prebuilt plan / halo, (f) head and packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
def test_forward_matches_jax_pallas(jax_side, net):
    js = jax_side[net]
    assert js["events"] == [], "JAX side fell back from the Pallas kernel"
    tree = _headless(params_from_jax(js["params"]))
    with torch.no_grad():
        got = layers.cnn_apply_from_graph(tree, tiny(net, PORT),
                                          torch.from_numpy(js["x"]))
    _close(got.numpy(), js["feat"])


def _resnet_plan_with_layer1_fused(nodes, n):
    """The tiny ResNet's plan with each layer1 pair forced into one fused
    group (2 x 3 tiles): the no-pool pairs of full-width ResNet-18."""
    plan = GraphFusePlan.build(nodes, n=n)
    segs = []
    for names, p in plan.segments:
        if names[0].startswith("l1b"):
            seg_layers = [nd.layer for nd in nodes if nd.name in names]
            g = build_group(seg_layers, 0, n=n, strip_rows=2, band_cols=3)
            p = dataclasses.replace(p, groups=(g,))
        segs.append((names, p))
    return dataclasses.replace(plan, segments=tuple(segs))


@pytest.mark.parametrize("net", NETS)
def test_fused_plan_and_halo_equal_per_node_bitwise(jax_side, net):
    js = jax_side[net]
    nodes = tiny(net, PORT)
    tree = params_from_jax(js["params"])
    x = torch.from_numpy(js["x"])
    with torch.no_grad():
        per_node = layers.cnn_apply_from_graph(tree, nodes, x)
        outs = {
            "fused": layers.cnn_apply_from_graph(tree, nodes, x, fused=True),
            "plan": layers.cnn_apply_from_graph(
                tree, nodes, x, fuse_plan=GraphFusePlan.build(nodes, n=2)),
            "halo": layers.cnn_apply_from_graph(tree, nodes, x,
                                                dataflow="halo"),
        }
        if net == "resnet18":
            outs["layer1 fused"] = layers.cnn_apply_from_graph(
                tree, nodes, x,
                fuse_plan=_resnet_plan_with_layer1_fused(nodes, 2))
    for name, y in outs.items():
        assert torch.equal(y, per_node), name
    _close(per_node.numpy(), js["logits"])


def test_unet_fused_runs_its_groups_including_the_1x1_stage(jax_side,
                                                            monkeypatch):
    """On the tiny U-Net the plan fuses five groups; each segment of two
    or more convs goes through ``cnn_apply_from_layers`` with its plan
    (the last, dec0a..out, ends in the 1x1 'valid' head)."""
    from repro_torch.kernels import trim_conv2d_fused as tfu
    js = jax_side["unet"]
    nodes = tiny("unet", PORT)
    plan = GraphFusePlan.build(nodes, n=2)
    assert [g.label for g in plan.groups if g.fused][-1] == "dec0a..out"
    seen = []
    real = tfu.trim_conv2d_fused_plain

    def spy(x, weights, biases, *, group, activation):
        seen.append(group.label)
        return real(x, weights, biases, group=group, activation=activation)
    monkeypatch.setattr(tfu, "trim_conv2d_fused_plain", spy)
    with torch.no_grad():
        layers.cnn_apply_from_graph(params_from_jax(js["params"]), nodes,
                                    torch.from_numpy(js["x"]),
                                    fuse_plan=plan)
    assert seen == [g.label for g in plan.groups if g.fused]


@pytest.mark.parametrize("net", NETS)
def test_head_and_jax_packed_tree_match_jax(jax_side, net):
    js = jax_side[net]
    nodes = tiny(net, PORT)
    x = torch.from_numpy(js["x"])
    jpacked = jlayers.cnn_pack_params_from_graph(
        jax.tree.map(jnp.asarray, js["params"]), js["jnodes"], n=2)
    packed = params_from_jax(jax.tree.map(np.asarray, jpacked))
    first = next(nd.name for nd in nodes if nd.op == "conv")
    assert "packed" in packed[first]
    with torch.no_grad():
        logits = layers.cnn_apply_from_graph(params_from_jax(js["params"]),
                                             nodes, x)
        from_packed = layers.cnn_apply_from_graph(packed, nodes, x)
    assert logits.shape == (2, CLASSES)
    _close(logits.numpy(), js["logits"])
    _close(from_packed.numpy(), js["logits"])


# ---------------------------------------------------------------------------
# (e) gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
def test_gradients_match_jax_grad(jax_side, net):
    js = jax_side[net]
    nodes = tiny(net, PORT)
    tree = params_from_jax(js["params"])
    names = [(k, n) for k in tree for n in tree[k]]
    leaves = [tree[k][n].requires_grad_() for k, n in names]
    x = torch.from_numpy(js["x"]).requires_grad_()
    before = dict(tc.LAUNCHES)
    out = layers.cnn_apply_from_graph(tree, nodes, x, activation="gelu")
    loss = (out * torch.from_numpy(_loss_weights(net))).sum()
    gx, *gp = torch.autograd.grad(loss, [x] + leaves)
    assert tc.LAUNCHES == before          # the CPU runs the plain versions
    _close(gx.numpy(), js["gx"])
    for (k, n), g in zip(names, gp):
        _close(g.numpy(), js["gp"][k][n])


# ---------------------------------------------------------------------------
# (g) tune_graph
# ---------------------------------------------------------------------------

def _cache_entries():
    with open(autotune.cache_path()) as f:
        return json.load(f)["entries"]


@pytest.mark.parametrize("net", NETS)
def test_tune_graph_records_and_packed_forward(jax_side, net):
    js = jax_side[net]
    nodes = tiny(net, PORT)
    convs = [nd for nd in nodes if nd.op == "conv"]
    recs = autotune.tune_graph(nodes, n=2, fused=True, device="cpu")
    assert sorted(recs["layers"]) == sorted(nd.name for nd in convs)
    keys = set()
    for nd in convs:
        xs, pads, ws = autotune.layer_problem(nd.layer, n=2)
        keys.add(autotune.make_key(xs, ws, stride=nd.layer.stride, pad=pads,
                                   groups=nd.layer.groups, device="cpu"))
        assert recs["layers"][nd.name]["key"] in keys
    want_fused = [g for names, seg in graph_segments(nodes) if len(seg) > 1
                  for g in FusedGroupPlan.build(list(seg), n=2).fused_groups]
    assert sorted(recs["fused"]) == sorted(g.label for g in want_fused)
    entries = _cache_entries()
    assert sum(k.startswith("conv2d:") for k in entries) == len(keys)
    assert sum(k.startswith("conv2d_fused:") for k in entries) \
        == len(want_fused)
    # a node's record is tune_network's for the same layer
    nd = convs[-1]
    assert recs["layers"][nd.name] == autotune.tune_network(
        [nd.layer], n=2, device="cpu", write=False)[nd.name]
    tree = params_from_jax(js["params"])
    x = torch.from_numpy(js["x"])
    packed = layers.cnn_pack_params_from_graph(tree, nodes, n=2)
    assert all("packed" in packed[nd.name] for nd in convs)
    with torch.no_grad():
        assert torch.equal(layers.cnn_apply_from_graph(packed, nodes, x),
                           layers.cnn_apply_from_graph(tree, nodes, x))


def test_tune_graph_tunes_resnet_repeated_blocks_once():
    recs = autotune.tune_graph("resnet18", n=1, device="cpu", write=False)
    layers_ = recs["layers"]
    assert len(layers_) == 20
    assert layers_["l1b0_conv1"]["key"] == layers_["l1b1_conv2"]["key"]
    assert len({r["key"] for r in layers_.values()}) == 11
    # model records are the planner's defaults: every plan stays
    from repro_torch.core.conv_plan import ConvPlan
    for nd in graph_nodes("resnet18"):
        if nd.op != "conv":
            continue
        xs, pads, ws = autotune.layer_problem(nd.layer, n=1)
        plan = ConvPlan.build(xs, ws, stride=nd.layer.stride, pad=pads)
        rec = layers_[nd.name]
        assert (rec["tile_h"], rec["tile_cout"], rec["dataflow"]) == \
            (plan.tile_h, plan.tile_cout, "carry"), nd.name


# ---------------------------------------------------------------------------
# (h) reserved names, refusals; (i) TrimCNN on a graph
# ---------------------------------------------------------------------------

def test_head_is_a_reserved_node_name():
    l = ConvLayer("head", 8, 3, 4, 3, padding=1)
    with pytest.raises(ValueError, match="reserved"):
        layers.cnn_params_from_graph([GraphNode("head", "conv", (), l)])


def test_fused_path_refuses_packed_entries_and_ref(jax_side):
    js = jax_side["unet"]
    nodes = tiny("unet", PORT)
    tree = params_from_jax(js["params"])
    x = torch.from_numpy(js["x"])
    packed = layers.cnn_pack_params_from_graph(tree, nodes, n=2)
    with pytest.raises(ValueError, match="raw conv params"):
        layers.cnn_apply_from_graph(packed, nodes, x, fused=True)
    with pytest.raises(ValueError, match="TrIM kernels"):
        layers.cnn_apply_from_graph(tree, nodes, x, fused=True, impl="ref")


def test_trim_cnn_on_a_graph(jax_side, monkeypatch):
    js = jax_side["resnet18"]
    nodes = tiny("resnet18", PORT)
    x = torch.from_numpy(js["x"])
    model = layers.TrimCNN(nodes, params_from_jax(js["params"]),
                           trainable=True)
    assert model.graph is not None and model.layers_list is None
    out = model(x)
    loss = (out * torch.from_numpy(_loss_weights("resnet18"))).sum()
    loss.backward()
    params = dict(model.named_parameters())
    assert len(params) == 2 * 20 + 2
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in params.values())
    with torch.no_grad():
        _close(model(x).numpy(), js["logits"])
    served = layers.TrimCNN.random("unet", device="cpu", fused=True)
    assert served.graph[0].name == "enc0a"
    y = served(torch.zeros((1, 64, 64, 3)))
    assert y.shape == (1, 64, 64, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        layers.TrimCNN.random("resnet18", n_classes=CLASSES)
