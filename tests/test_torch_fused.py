"""Fused residency groups of the port against the JAX package (CPU).

The chains are ``tests/test_fused.py``'s: a 'same' stack with an even
pool, a 'valid' strided head with an overlapping 3/2 pool and a
pointwise stage, and a pool-free stack (``alexnet_x32`` is left out: its
K=11 conv1 raises in the port).  Inputs are numpy from a seed; params are
the JAX ``init_params``, carried over by ``convert.params_from_jax``.

* Geometry: the port's row ranges equal the JAX ``build_group``'s.
* Forward: ``fused_group_apply`` (on the CPU the plain version, which
  walks the kernel's tiles) against JAX ``reference_chain`` on the
  Pallas carry kernel (interpret mode, ``guard.events()`` empty) within
  1e-5 of max|ref| (DESIGN.md §5), for every strip height and several
  band widths; the JAX fused kernel itself fails here (``pl.unblocked``).
* Gradients: through ``_FusedGroupFn`` bitwise equal to the port's
  per-layer chain, and within 1e-4 of ``jax.grad`` of the JAX
  ``reference_chain`` on ``impl="ref"`` (the JAX Pallas backward fails
  here too).
* The plan: ``max_depth=1`` is per-layer; VGG-16 at 1/16 width and at
  full width fuses under 227 KB, each group moving no more bytes than its
  layers' per-layer schedule.
* The kernel's schedule: the ``constexpr``s of ``trim_conv2d_fused.cu``
  equal their Python mirrors; ``kernel_geometry`` is read field by field
  as ``make_args`` reads it; channel pitch, buffers and weight ring,
  whole pool windows per thread, C_out tiles and passes (a ragged last
  pass), bytes; a tile at exactly 227 KB, ``cout % 4 != 0`` and
  ``cin = 3`` groups against the per-layer chain.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guard
from repro.core.fuse_plan import build_group as jbuild_group
from repro.core.model import ConvLayer as JConvLayer
from repro.kernels.trim_conv2d_fused import reference_chain as jreference
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro_torch.convert import params_from_jax
from repro_torch.core import fuse_plan
from repro_torch.core.conv_plan import SMEM_PER_BLOCK, ConvPlan
from repro_torch.core.fuse_plan import FusedGroupPlan, build_group
from repro_torch.core.model import ConvLayer
from repro_torch.core.netplan import infer_pools, network_layers
from repro_torch.core.serving import ServingEngine, replay
from repro_torch.kernels import trim_conv2d_fused as tf
from repro_torch.models import layers
from repro_torch.testing.load import poisson_arrivals

TOL = 1e-5
GRAD_TOL = 1e-4
CHAINS = {
    "same_pool": [("c0", 12, 3, 4, 3, 1, 1), ("c1", 12, 4, 6, 3, 1, 1),
                  ("c2", 6, 6, 8, 3, 1, 1)],
    "strided_valid": [("s0", 17, 3, 4, 5, 2, 0), ("s1", 3, 4, 8, 1, 1, 0),
                      ("s2", 3, 8, 8, 3, 1, 1)],
    "nopool": [("p0", 9, 2, 4, 3, 1, 1), ("p1", 9, 4, 4, 3, 1, 1),
               ("p2", 9, 4, 6, 3, 1, 1)],
}
# (chain, strip_rows, band_cols); None is the full extent
TILES = [(c, t, b) for c in CHAINS for t in (1, 2, None)
         for b in (1, 3, None)]
# Edge groups of the kernel's schedule: (layers, tile).  "limit": its
# shared memory is exactly 227 KB; a ragged last pass and a ragged C_out
# tile in e0 (60 = 32 + 28), cout % 4 != 0 in e1.  "cin3": VGG-16's
# conv1..conv2 at 32 x 32, cin = 3 (the scalar route) into a 2x2 pool.
EDGES = {
    "limit": ([("e0", 20, 44, 60, 3, 1, 1), ("e1", 20, 60, 6, 3, 1, 1)],
              (19, 20)),
    "cin3": ([("v1", 32, 3, 64, 3, 1, 1), ("v2", 32, 64, 64, 3, 1, 1),
              ("v3", 16, 64, 32, 3, 1, 1)], (2, 3)),
}
CU = Path(tf.__file__).parent / "csrc" / "trim_conv2d_fused.cu"


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a per-test temp file: no test reads
    or writes a cache outside it."""
    from repro_torch.core import autotune
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


def _topos(name):
    spec = CHAINS[name]
    return [ConvLayer(*a) for a in spec], [JConvLayer(*a) for a in spec]


@functools.lru_cache(maxsize=None)
def _setup(name, n=2, seed=0):
    """(port topo, JAX topo, numpy params, numpy x) of a chain."""
    topo, jtopo = _topos(name)
    params = jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(
        (n, topo[0].ifmap, topo[0].ifmap, topo[0].in_channels)).astype(
            np.float32)
    return topo, jtopo, params, x


def _stage_params(params, depth):
    ws = [params[f"conv{i}"]["w"] for i in range(depth)]
    bs = [params[f"conv{i}"]["b"] for i in range(depth)]
    return ws, bs


def _torch(arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_chain(name):
    """JAX ``reference_chain`` on the Pallas carry kernel (interpret)."""
    _, jtopo, params, x = _setup(name)
    ws, bs = _stage_params(params, len(jtopo))
    g = jbuild_group(jtopo, 0, n=x.shape[0])
    out = np.asarray(jreference(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                [jnp.asarray(b) for b in bs], group=g))
    assert guard.events() == [], "JAX side fell back from the Pallas kernel"
    return out


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("strip_rows", [1, 2, 3, None])
def test_row_geometry_matches_jax(name, strip_rows):
    topo, jtopo = _topos(name)
    t = strip_rows or build_group(topo, 0).last.h_pool
    g = build_group(topo, 0, n=2, strip_rows=t)
    jg = jbuild_group(jtopo, 0, n=2, strip_rows=t)
    assert g.band_cols == g.last.w_pool          # full width by default
    assert (g.n_strips, g.depth, g.out_shape) == (jg.n_strips, jg.depth,
                                                  jg.out_shape)
    for st, jst in zip(g.stages, jg.stages):
        for f in dataclasses.fields(jst):
            assert getattr(st, f.name) == getattr(jst, f.name), (st.name,
                                                                 f.name)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_column_geometry_is_the_row_recursion_on_w(name):
    topo, _ = _topos(name)
    for t in (1, 2):
        rows = build_group(topo, 0, strip_rows=t, band_cols=1).stages
        cols = build_group(topo, 0, strip_rows=1, band_cols=t).stages
        for r, c in zip(rows, cols):
            for a in ("in", "conv", "pool"):
                row_key = "in_rows" if a == "in" else f"{a}_rows"
                col_key = "in_cols" if a == "in" else f"{a}_cols"
                start = "in_start" if a == "in" else f"{a}_start"
                cstart = ("in_col_start" if a == "in"
                          else f"{a}_col_start")
                step = "in_step" if a == "in" else f"{a}_step"
                cstep = "in_col_step" if a == "in" else f"{a}_col_step"
                assert (getattr(r, start), getattr(r, step),
                        getattr(r, row_key)) == (
                    getattr(c, cstart), getattr(c, cstep),
                    getattr(c, col_key))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,strip_rows,band_cols", TILES)
def test_group_apply_matches_jax_reference_chain(name, strip_rows,
                                                 band_cols):
    topo, _, params, x = _setup(name)
    probe = build_group(topo, 0, n=x.shape[0])
    g = build_group(topo, 0, n=x.shape[0],
                    strip_rows=strip_rows or probe.last.h_pool,
                    band_cols=band_cols or probe.last.w_pool)
    ws, bs = _stage_params(params, len(topo))
    got = tf.fused_group_apply(torch.from_numpy(x), _torch(ws), _torch(bs),
                               group=g)
    _close(got.numpy(), _jax_chain(name))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_network_fused_matches_jax_per_layer(name):
    topo, jtopo, _, x = _setup(name)
    params = jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo, n_classes=5),
        jax.random.PRNGKey(1)))
    want = np.asarray(jlayers.cnn_apply_from_layers(
        jax.tree.map(jnp.asarray, params), jtopo, jnp.asarray(x)))
    assert guard.events() == []
    plan = FusedGroupPlan.build(topo, n=x.shape[0])
    assert plan.fused_groups, plan.describe()
    with torch.no_grad():
        got = layers.cnn_apply_from_layers(
            params_from_jax(params), topo, torch.from_numpy(x), fused=True)
    _close(got.numpy(), want)


def test_vgg16_scaled_fused_matches_jax_ref():
    from repro.core import netplan as jnetplan
    from repro_torch.core.netplan import scale_layers
    jtopo = jnetplan.scale_layers(jnetplan.network_layers("vgg16"), 16)
    topo = scale_layers(network_layers("vgg16"), 16)
    params = jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo, n_classes=10),
        jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal((1, 224, 224, 3)).astype(
        np.float32)
    want = np.asarray(jlayers.cnn_apply_from_layers(
        jax.tree.map(jnp.asarray, params), jtopo, jnp.asarray(x),
        impl="ref"))
    plan = FusedGroupPlan.build(topo, n=1)
    assert plan.fused_groups, plan.describe()
    with torch.no_grad():
        got = layers.cnn_apply_from_layers(
            params_from_jax(params), topo, torch.from_numpy(x),
            fused=True).numpy()
    _close(got, want)


def test_none_biases_are_zeros():
    topo, _, params, x = _setup("same_pool")
    g = build_group(topo, 0, n=x.shape[0], strip_rows=2, band_cols=3)
    ws, _ = _stage_params(params, 3)
    zeros = [torch.zeros(l.out_channels) for l in topo]
    a = tf.fused_group_apply(torch.from_numpy(x), _torch(ws),
                             [None] * 3, group=g)
    b = tf.fused_group_apply(torch.from_numpy(x), _torch(ws), zeros,
                             group=g)
    assert torch.equal(a, b)


@pytest.mark.parametrize("activation", [None, "gelu", "silu"])
def test_activations_match_the_per_layer_chain(activation):
    topo, _, params, x = _setup("nopool")
    g = build_group(topo, 0, n=x.shape[0], strip_rows=2, band_cols=4)
    ws, bs = _stage_params(params, 3)
    args = (torch.from_numpy(x), _torch(ws), _torch(bs))
    got = tf.fused_group_apply(*args, group=g, activation=activation)
    with torch.no_grad():
        want = tf.reference_chain(*args, group=g, activation=activation)
    _close(got.numpy(), want.numpy())


def test_group_apply_validates_its_operands():
    topo, _, params, x = _setup("same_pool")
    g = build_group(topo, 0, n=x.shape[0])
    ws, bs = _torch(_stage_params(params, 3)[0]), \
        _torch(_stage_params(params, 3)[1])
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="depth"):
        tf.fused_group_apply(xt, ws[:2], bs[:2], group=g)
    with pytest.raises(ValueError, match="stage-0"):
        tf.fused_group_apply(xt[:1], ws, bs, group=g)
    with pytest.raises(ValueError, match="planned"):
        tf.fused_group_apply(xt, [ws[0], ws[0], ws[2]], bs, group=g)
    with pytest.raises(ValueError, match="bias"):
        tf.fused_group_apply(xt, ws, [bs[0], bs[0], bs[2]], group=g)
    with pytest.raises(ValueError, match="activation"):
        tf.fused_group_apply(xt, ws, bs, group=g, activation="tanh")


def test_packed_params_are_rejected():
    topo, _, params, x = _setup("same_pool")
    p = params_from_jax(params)
    p["conv1"]["packed"] = p["conv1"]["w"]
    with pytest.raises(ValueError, match="raw conv params"):
        layers.cnn_apply_from_layers(p, topo, torch.from_numpy(x),
                                     fused=True)


def test_fused_runs_the_trim_kernels_only():
    topo, _, params, x = _setup("same_pool")
    with pytest.raises(ValueError, match="impl"):
        layers.cnn_apply_from_layers(params_from_jax(params), topo,
                                     torch.from_numpy(x), fused=True,
                                     impl="ref")


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["same_pool", "strided_valid"])
def test_group_gradients_equal_per_layer_and_match_jax(name):
    topo, jtopo, params, x = _setup(name)
    ws, bs = _stage_params(params, len(topo))
    g = build_group(topo, 0, n=x.shape[0], strip_rows=2, band_cols=2)
    out_shape = g.out_shape
    gy = np.random.default_rng(5).standard_normal(out_shape).astype(
        np.float32)

    def port_grads(fn):
        leaves = [t.requires_grad_() for t in _torch([x, *ws, *bs])]
        d = len(ws)
        y = fn(leaves[0], leaves[1:1 + d], leaves[1 + d:])
        return torch.autograd.grad(y, leaves, torch.from_numpy(gy))

    fused = port_grads(lambda a, w, b: tf.fused_group_apply(a, w, b,
                                                            group=g))
    chain = port_grads(lambda a, w, b: tf.reference_chain(a, w, b,
                                                          group=g))
    for a, b in zip(fused, chain):
        assert torch.equal(a, b)

    jg = jbuild_group(jtopo, 0, n=x.shape[0])

    def jloss(x_, ws_, bs_):
        y = jreference(x_, ws_, bs_, group=jg, impl="ref")
        return (y * jnp.asarray(gy)).sum()

    jgr = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs])
    for got, want in zip(fused, jax.tree_util.tree_leaves(jgr)):
        _close(got.numpy(), np.asarray(want), GRAD_TOL)


def test_group_backward_skips_what_needs_no_grad():
    topo, _, params, x = _setup("same_pool")
    ws, bs = _stage_params(params, 3)
    g = build_group(topo, 0, n=x.shape[0], strip_rows=2)
    w = _torch(ws)
    w[1].requires_grad_()
    y = tf.fused_group_apply(torch.from_numpy(x), w, _torch(bs), group=g)
    (dw,) = torch.autograd.grad(y.sum(), [w[1]])
    assert dw.shape == w[1].shape and torch.isfinite(dw).all()


def test_network_fused_gradients_match_per_layer():
    topo, jtopo, _, x = _setup("same_pool")
    params = params_from_jax(jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo, n_classes=5),
        jax.random.PRNGKey(2))))

    def grads(fused):
        model = layers.TrimCNN(topo, params, trainable=True, fused=fused)
        loss = (model(torch.from_numpy(x)) ** 2).sum()
        return torch.autograd.grad(loss, list(model.parameters()))

    for got, want in zip(grads(True), grads(False)):
        _close(got.numpy(), want.numpy(), GRAD_TOL)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["vgg16", "mobilenet"])
def test_max_depth_one_is_per_layer_execution(net):
    plan = FusedGroupPlan.build(net, n=2, max_depth=1)
    assert all(g.depth == 1 and not g.fused for g in plan.groups)
    assert [g.start for g in plan.groups] == list(range(len(plan.groups)))
    assert plan.executed_hbm_bytes()["total"] == plan.never_hbm_bytes()


@pytest.mark.parametrize("n", [1, 8])
def test_vgg16_plan_fuses_within_shared_memory(n):
    """VGG-16 at 1/16 width (the JAX parity tests' model) and at full
    width both fuse under 227 KB, every fused group moving no more bytes
    than its layers' per-layer schedule.  At full width the plan fuses
    conv1..conv2 at 8 x 16, at under a third of its layers' bytes, and
    takes a conv3..conv4 tile of no more bytes than 4 x 8 (the fixed
    tiles the smoke times)."""
    from repro_torch.core.netplan import scale_layers
    for topo in (scale_layers(network_layers("vgg16"), 16),
                 network_layers("vgg16")):
        plan = FusedGroupPlan.build(topo, n=n)
        assert plan.fused_groups, plan.describe()
        assert sum(g.depth for g in plan.groups) == 13
        for g in plan.fused_groups:
            assert g.smem_bytes <= SMEM_PER_BLOCK
            assert g.executed_flops >= g.flops
            assert g.hbm_bytes()["total"] <= sum(
                plan.layer_exec_bytes[g.start + i]["total"]
                for i in range(g.depth))
        assert plan.executed_hbm_bytes()["total"] < plan.never_hbm_bytes()
    full, pools = plan, infer_pools(network_layers("vgg16"))
    pairs = [build_group(network_layers("vgg16")[s:s + 2], s, n=n,
                        strip_rows=t, band_cols=b, pools=pools[s:s + 2])
            for s, t, b in ((0, 8, 16), (2, 4, 8))]
    first, second = full.groups[:2]
    assert (first.label, first.strip_rows, first.band_cols) == (
        "conv1..conv2", 8, 16)
    assert 3 * pairs[0].hbm_bytes()["total"] < sum(
        full.layer_exec_bytes[i]["total"] for i in range(2))
    assert second.label == "conv3..conv4"
    assert second.hbm_bytes()["total"] <= pairs[1].hbm_bytes()["total"]
    assert all(g.smem_bytes <= SMEM_PER_BLOCK for g in pairs)


def test_plan_picks_the_least_byte_tile_within_the_budget(monkeypatch):
    topo, _ = _topos("same_pool")
    pools = infer_pools(topo)
    g = FusedGroupPlan._tune_group(topo, pools, 0, 3, n=2)
    cands = [build_group(topo, 0, n=2, strip_rows=t, band_cols=b)
             for t in fuse_plan._strip_candidates(g.last.h_pool)
             for b in fuse_plan._strip_candidates(g.last.w_pool)]
    assert g.smem_bytes <= SMEM_PER_BLOCK
    assert (g.hbm_bytes()["total"], g.executed_flops) == min(
        (c.hbm_bytes()["total"], c.executed_flops) for c in cands)
    monkeypatch.setattr(fuse_plan, "SMEM_PER_BLOCK", 1024)
    assert FusedGroupPlan._tune_group(topo, pools, 0, 3, n=2) is None


def test_layer_eligibility():
    # grouped (depthwise) layers, K > 8 and a strided stage collapsing to
    # one row never join a group, as in the JAX plan
    for l in network_layers("mobilenet"):
        assert fuse_plan._layer_eligible(l) == (l.groups == 1), l.name
    assert not fuse_plan._layer_eligible(network_layers("alexnet")[0])
    assert not fuse_plan._layer_eligible(ConvLayer("one", 3, 4, 4, 3, 2, 0))
    assert all(map(fuse_plan._layer_eligible, network_layers("vgg16")))


def test_per_layer_bytes_are_the_conv_plan_schedule_and_the_pool():
    topo = network_layers("vgg16")[:2]
    pools = infer_pools(network_layers("vgg16"))[:2]
    b = fuse_plan.per_layer_exec_bytes(topo, pools, n=2)
    plan = ConvPlan.build((2, 224, 224, 64), (3, 3, 64, 64), pad=1)
    assert b[1]["output"] == 4 * 2 * 224 * 224 * 64
    assert b[1]["pool"] == 4 * 2 * 64 * (224 ** 2 + 112 ** 2)
    assert b[1]["weights"] == 4 * 2 * plan.n_bands * plan.n_strips \
        * 9 * 64 * 64
    assert b[0]["pool"] == 0
    halo = ConvPlan.build((2, 224, 224, 64), (3, 3, 64, 64), pad=1,
                          dataflow="halo")
    assert halo.hbm_bytes()["input"] > plan.hbm_bytes()["input"]


def test_describe_lists_the_groups():
    from repro_torch.core.netplan import scale_layers
    plan = FusedGroupPlan.build(scale_layers(network_layers("vgg16"), 16),
                                n=1)
    text = plan.describe()
    assert text.startswith("conv1..") and "(T=" in text
    assert text.count("|") == len(plan.groups) - 1


def _make_args_fields(name):
    """``make_args``'s reads of one array (``g`` header, ``f`` stage
    fields): {field: index}."""
    body = CU.read_text().split("bool make_args(")[1].split("\n}\n")[0]
    who = "a->" if name == "g" else "st."
    return {f: int(i) for f, i in re.findall(
        rf"{re.escape(who)}(\w+) = {name}\[(\d+)\]", body)}


def test_kernel_geometry_layout():
    """``kernel_geometry`` against ``make_args`` of the ``.cu``, read
    field by field: every header and stage field it reads holds the
    plan's value, and the layout has no field it does not read; what
    ``make_args`` derives (threads along C_out, positions a thread, the
    ring's row) follows the plan's rules."""
    topo, _ = _topos("strided_valid")
    g = build_group(topo, 0, n=2, strip_rows=2, band_cols=3)
    geom = tf.kernel_geometry(g)
    hn, fn = tf.GEOM_HEADER, tf.GEOM_STAGE_FIELDS
    assert len(geom) == hn + fn * g.depth
    s0 = g.stages[0]
    header = dict(n=g.n, h=s0.h_in, w=s0.w_in, cin=s0.cin, depth=g.depth,
                  n_strips=g.n_strips, n_bands=g.n_bands,
                  buf0=g.buffer_elems[0], buf1=g.buffer_elems[1])
    read = _make_args_fields("g")
    assert sorted(read.values()) == list(range(hn))
    assert {f: geom[i] for f, i in read.items()} == header
    plan_name = dict(k="kernel", ps="pool_stride", pw="pool_window",
                     in_row_start="in_start", in_row_step="in_step",
                     pool_row_start="pool_start", pool_row_step="pool_step",
                     in_pitch="cin_pitch")
    read = _make_args_fields("f")
    assert sorted(read.values()) == list(range(fn))
    for i, st in enumerate(g.stages):
        f = geom[hn + fn * i:hn + fn * (i + 1)]
        for field, j in read.items():
            assert f[j] == getattr(st, plan_name.get(field, field)), field
        assert st.threads_cout == -(-st.tile_cout // fuse_plan.FUSED_COUT)
        assert st.per_thread == (
            fuse_plan.FUSED_POOL3_POSITIONS if st.pool_window == 3
            else fuse_plan.FUSED_POSITIONS) // st.pool_window ** 2
        assert st.in_rows * st.in_cols * st.cin_pitch <= \
            g.buffer_elems[i % 2]
    assert g.ring_cout == fuse_plan.FUSED_COUT * max(
        st.threads_cout for st in g.stages)
    assert 4 * (geom[7] + geom[8] + fuse_plan.FUSED_WEIGHT_STAGES
                * fuse_plan.FUSED_WEIGHT_CHUNK * g.ring_cout) == g.smem_bytes


def test_plan_constants_match_the_kernel():
    """The namespace-scope ``constexpr``s of ``trim_conv2d_fused.cu``
    against their Python mirrors (the plan's schedule and the wrapper's
    geometry layout), so the two cannot drift; a new constant needs a
    mirror here."""
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 CU.read_text(), re.M):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    assert found == {
        "kThreads": fuse_plan.FUSED_THREADS,
        "kMaxStages": fuse_plan.MAX_FUSED_STAGES,
        "kPositions": fuse_plan.FUSED_POSITIONS,
        "kPool3Positions": fuse_plan.FUSED_POOL3_POSITIONS,
        "kCout": fuse_plan.FUSED_COUT,
        "kMaxTileCout": fuse_plan.FUSED_MAX_TILE_COUT,
        "kChunk": fuse_plan.FUSED_WEIGHT_CHUNK,
        "kStages": fuse_plan.FUSED_WEIGHT_STAGES,
        "kMaxSmemBytes": SMEM_PER_BLOCK,
        "kHeader": tf.GEOM_HEADER,
        "kStageFields": tf.GEOM_STAGE_FIELDS,
    }


def _edge_group(name, n=2):
    spec, (t, b) = EDGES[name]
    topo = [ConvLayer(*a) for a in spec]
    return topo, build_group(topo, 0, n=n, strip_rows=t, band_cols=b)


def test_channel_pitch_buffers_and_weight_ring():
    _, g = _edge_group("limit")
    e0, e1 = g.stages
    assert (e0.cin_pitch, e1.cin_pitch) == (44 + 4, 60 + 4)
    assert build_group(*_topos("same_pool")[:1], 0).stages[0].cin_pitch == 3
    assert g.buffer_elems == tuple(
        -(-st.in_rows * st.in_cols * st.cin_pitch // 4) * 4
        for st in g.stages)
    assert g.ring_cout == 4 * max(e0.threads_cout, e1.threads_cout) == 32
    ring = fuse_plan.FUSED_WEIGHT_STAGES * fuse_plan.FUSED_WEIGHT_CHUNK \
        * g.ring_cout
    assert g.smem_bytes == 4 * (sum(g.buffer_elems) + ring)


def test_a_tile_at_exactly_the_shared_memory_limit():
    """The "limit" group takes exactly 227 KB and is planned (<=); one
    row more does not fit, so the plan never picks a tile above it."""
    topo, g = _edge_group("limit", n=1)
    assert g.smem_bytes == SMEM_PER_BLOCK
    assert build_group(topo, 0, n=1, strip_rows=20,
                       band_cols=20).smem_bytes > SMEM_PER_BLOCK
    best = FusedGroupPlan._tune_group(topo, infer_pools(topo), 0, 2, n=1)
    assert best.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("ps,pw,per_thread", [(1, 1, 8), (2, 2, 2),
                                              (2, 3, 1), (4, 4, 0)])
def test_whole_pool_windows_per_thread(ps, pw, per_thread):
    """A thread holds whole pool windows: 8 conv outputs (8 positions,
    two 2x2 windows) or one 3x3 window of 9; the kernel takes no larger
    window, and no group with one is planned."""
    h_pool = (16 - pw) // ps + 1 if pw > 1 else 16
    topo = [ConvLayer("q0", 16, 4, 8, 3, 1, 1),
            ConvLayer("q1", h_pool, 8, 8, 3, 1, 1)]
    pools = [(ps, pw), (1, 1)]
    st = build_group(topo, 0, pools=pools).stages[0]
    assert st.per_thread == per_thread
    slots = (fuse_plan.FUSED_POOL3_POSITIONS if pw == 3
             else fuse_plan.FUSED_POSITIONS)
    assert per_thread * pw ** 2 <= slots
    if per_thread:
        assert st.positions_per_pass == \
            fuse_plan.FUSED_THREADS // st.threads_cout * per_thread
    else:
        assert FusedGroupPlan._tune_group(topo, pools, 0, 2, n=1) is None


@pytest.mark.parametrize("case", ["vgg12", "vgg34", "limit"])
def test_tile_cout_takes_the_fewest_pass_tiles(case):
    """Each stage's C_out tile (of 128, 64, 32, capped at C_out) has the
    fewest C_out tiles x passes, then the fewest passes; a pass holds
    256 / threads_cout threads' whole pool windows, and the last may be
    ragged."""
    if case == "limit":
        _, g = _edge_group("limit")
    else:
        s, t, b = (0, 8, 16) if case == "vgg12" else (2, 4, 8)
        g = build_group(network_layers("vgg16")[s:s + 2], s, n=1,
                        strip_rows=t, band_cols=b,
                        pools=infer_pools(network_layers("vgg16"))[s:s + 2])
    for st in g.stages:
        positions = st.pool_rows * st.pool_cols

        def cost(tc):
            ppp = fuse_plan.FUSED_THREADS // -(-tc // 4) * st.per_thread
            return -(-st.cout // tc) * -(-positions // ppp), \
                -(-positions // ppp)
        cands = {min(st.cout, c) for c in (128, 64, 32)}
        assert cost(st.tile_cout) == min(map(cost, cands))
        assert st.passes == -(-positions // st.positions_per_pass)
    want = {"vgg12": [64, 32], "vgg34": [128, 64], "limit": [32, 6]}[case]
    assert [st.tile_cout for st in g.stages] == want
    if case == "limit":   # 21 x 22 positions in passes of 256
        e0 = g.stages[0]
        assert (e0.positions_per_pass, e0.passes) == (256, 2)
        assert e0.pool_rows * e0.pool_cols % e0.positions_per_pass


def test_bytes_are_the_kernels_schedule():
    g = build_group(network_layers("vgg16")[:2], 0, n=2, strip_rows=8,
                    band_cols=16, pools=infer_pools(
                        network_layers("vgg16"))[:2])
    b = g.hbm_bytes()
    s0, lt = g.stages[0], g.last
    assert b["input"] == 4 * g.n_tiles * s0.in_rows * s0.in_cols * s0.cin
    assert b["weights"] == g.n_tiles * sum(st.passes * st.weight_bytes
                                           for st in g.stages)
    assert b["output"] == 4 * 2 * 112 * 112 * 64
    assert b["total"] == b["input"] + b["weights"] + b["output"]


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_groups_match_the_per_layer_chain(name):
    """The edge groups at their tiles against the JAX package's
    ``reference_chain`` (its per-layer chain on the Pallas carry kernel,
    interpret mode) on the same inputs."""
    topo, g = _edge_group(name)
    jtopo = [JConvLayer(*a) for a in EDGES[name][0]]
    rng = np.random.default_rng(7)
    s0 = g.stages[0]
    x = rng.standard_normal((2, s0.h_in, s0.w_in, s0.cin)).astype(np.float32)
    ws = [(rng.standard_normal(st.weight_shape)
           / np.sqrt(9 * st.cin)).astype(np.float32) for st in g.stages]
    bs = [rng.standard_normal(st.cout).astype(np.float32)
          for st in g.stages]
    got = tf.fused_group_apply(torch.from_numpy(x), _torch(ws), _torch(bs),
                               group=g)
    want = jreference(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                      [jnp.asarray(b) for b in bs],
                      group=jbuild_group(jtopo, 0, n=2))
    assert guard.events() == [], "JAX side fell back from the Pallas kernel"
    _close(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_fused_serving_rows_bit_match_forward_one():
    topo, _ = _topos("same_pool")
    model = layers.TrimCNN.random(topo, n_classes=5, device="cpu")
    eng = ServingEngine.for_topology(topo, model, buckets=(1, 2, 4),
                                     device="cpu", fused=True)
    eng.prewarm()
    xs = np.random.default_rng(4).standard_normal((6, 12, 12, 3)).astype(
        np.float32)
    results, rejected = replay(eng, [
        (t, i, xs[i]) for i, t in enumerate(poisson_arrivals(500.0, 6,
                                                              seed=1))])
    assert not rejected and len(results) == 6
    per_layer = ServingEngine.for_topology(topo, model, buckets=(1,),
                                           device="cpu")
    for i in range(6):
        assert np.array_equal(results[i], eng.forward_one(xs[i])), i
        _close(results[i], per_layer.forward_one(xs[i]))


def test_serve_conv_cli_fused_smoke(capsys):
    from repro_torch.launch import serve_conv
    serve_conv.main(["--smoke", "--fused", "--device", "cpu",
                     "--requests", "4"])
    out = capsys.readouterr().out
    assert "fused groups at batch 1: s0..s2 (T=" in out
    assert "served 4/4" in out
    with pytest.raises(SystemExit):
        serve_conv.main(["--smoke", "--fused", "--dataflow", "halo",
                         "--device", "cpu"])
