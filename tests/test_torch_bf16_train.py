"""bf16 CNN training in the port against the JAX package on the CPU.

The weight-gradient kernel's bf16 route widens bf16 x and cotangent to
f32, sums their exact products in f32 and rounds dw to bf16 once, as
JAX's ``_weight_grad_kernel`` does (``preferred_element_type=f32``, one
cast at the end).  JAX's Pallas weight gradient and its custom-vjp
backward do not run on this JAX version (``pl.unblocked`` is gone), so
the oracles are ``jax.vjp`` / ``jax.grad`` of JAX's ``ref.conv2d`` and
``simple_cnn_apply(..., impl="ref")``.  The same numpy inputs, rounded to
bf16 once, go through both packages.

* (a) The plain bf16 weight gradient (the wrapper on CPU tensors) on
  K 3 at stride 1 and 2, 'same' and 'valid', groups 2, depthwise, Cin 3
  and the rectangular sub-kernels of K 11 (3x2, 2x3, 2x2 at stride 4):
  the wrapper's f32 sums within 1e-5 of max|oracle| of JAX's f32 weight
  gradient on the widened operands (f32 sums in another order); rounded
  once to bf16, each element within one bf16 ulp plus the two f32 sums'
  own error bound (2 n u32 sum|x g|) of the oracle.
* (b) One bf16 ``ops.conv2d`` under autograd with bias and relu / gelu /
  silu, at ``tests/test_grad.py::test_grad_bf16_tolerance_policy``'s
  geometry and at a K 11 conv through the adder tree: dx, dw and db are
  bf16 and within 3e-2 of max|oracle| (DESIGN.md §5) of ``jax.vjp`` of
  JAX's ``ref.conv2d`` on the bf16 operands and of the f32 oracle.
* (c) JAX's example CNN (``simple_cnn_params``, ``init_params`` at
  PRNGKey(0), batch 4 at 32 x 32), carried across by ``params_from_jax``
  and cast to bf16, one ``train_step``: per leaf the port's gradient lies
  no farther from JAX's f32 gradient than twice JAX's own bf16
  ``impl="ref"`` gradient does (that distance reaches 9.1e-2 of max|f32|
  at ``down1.b``: a network's bf16 gradient is not held at 3e-2, ROADMAP
  Queue 3); against JAX's bf16 gradient, each weight element within one
  bf16 ulp and each bias within 5e-2 of max (XLA sums a bf16 bias
  cotangent in bf16, the port in f32 rounded once); the updated bf16 params within one bf16 ulp and the f32
  moments within 1e-6 of max of JAX's ``adamw.apply_updates`` on the
  port's gradient.
* (d) VGG-16 at 1/16 width in bf16 with ``fused=True`` under grad: the
  gradient bitwise the per-layer one (the backward recomputes each group
  per layer).
* (e) A bf16 backward reads the ``:bfloat16:`` records of its cotangent
  kernels, never the ``float32`` ones.
* (f) ``WeightGradPlan.build(..., dtype_bytes=2)`` has the f32 geometry
  and half the bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.core import autotune
from repro_torch.core import conv_plan as cp
from repro_torch.core.conv_plan import (BF16WeightGradPlan, WeightGradPlan,
                                        input_grad_geometry)
from repro_torch.core.fuse_plan import FusedGroupPlan
from repro_torch.core.model import vgg16_layers
from repro_torch.core.netplan import scale_layers
from repro_torch.kernels import ops
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.kernels.ref import conv_pads
from repro_torch.launch import train_cnn
from repro_torch.models import layers
from repro_torch.optim import adamw

BF16 = torch.bfloat16
F32_TOL = 1e-5        # f32 sums in another order
BF16_TOL = 3e-2       # DESIGN.md §5: one bf16 conv against its oracles
BIAS_TOL = 5e-2       # (c): a bias gradient against JAX's bf16 one
U32 = 2.0 ** -24      # f32 unit roundoff


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a per-test temp file: no test reads
    or writes a cache outside it."""
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


def _bf16(a) -> torch.Tensor:
    """A numpy array rounded to bf16 once (round to nearest even)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _rel(got, want) -> float:
    """max|got - want| / max|want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude (of the normal range)."""
    m = np.maximum(np.abs(a), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


# ---------------------------------------------------------------------------
# (a) the plain bf16 weight gradient against JAX
# ---------------------------------------------------------------------------

# (name, x shape, (KH, KW, Cout), stride, groups, padding)
WGRAD_CASES = [
    ("k3_s1_same", (2, 11, 12, 8), (3, 3, 16), 1, 1, "same"),
    ("k3_s1_valid", (2, 11, 12, 8), (3, 3, 16), 1, 1, "valid"),
    ("k3_s2_same", (2, 11, 12, 8), (3, 3, 16), 2, 1, "same"),
    ("k3_s2_valid", (2, 11, 12, 8), (3, 3, 16), 2, 1, "valid"),
    ("groups2", (2, 10, 9, 8), (3, 3, 12), 1, 2, "same"),
    ("depthwise", (2, 10, 10, 8), (3, 3, 8), 2, 8, "same"),
    ("cin3", (2, 13, 12, 3), (3, 3, 16), 1, 1, "same"),
    # the rectangular sub-kernels of K 11 at stride 4: 'valid' slices
    ("k11_3x2", (2, 19, 18, 3), (3, 2, 16), 4, 1, "valid"),
    ("k11_2x3", (2, 18, 19, 3), (2, 3, 16), 4, 1, "valid"),
    ("k11_2x2", (2, 18, 18, 3), (2, 2, 16), 4, 1, "valid"),
]


@pytest.mark.parametrize("case", WGRAD_CASES, ids=[c[0] for c in WGRAD_CASES])
def test_plain_bf16_weight_grad_matches_jax(case):
    name, xs, (kh, kw, cout), s, g, padding = case
    rng = np.random.default_rng(len(name))
    n, h, w, cin = xs
    pads = conv_pads(h, w, kh, s, padding) if kh == kw else \
        ((0, 0), (0, 0))
    ho = (h + sum(pads[0]) - kh) // s + 1
    wo = (w + sum(pads[1]) - kw) // s + 1
    xb = _bf16(rng.standard_normal(xs))
    gb = _bf16(rng.standard_normal((n, ho, wo, cout)))
    wshape = (kh, kw, cin // g, cout)
    _, want = jref.conv2d_grads(
        jnp.asarray(xb.float().numpy()), jnp.zeros(wshape, jnp.float32),
        jnp.asarray(gb.float().numpy()), stride=s, padding=padding,
        feature_group_count=g)
    want = _np(want)
    kw_ = dict(kernel_size=(kh, kw), stride=s, pad=pads, groups=g)
    f32 = tc.trim_conv2d_weight_grad(xb, gb, **kw_)
    assert f32.dtype == torch.float32 and tuple(f32.shape) == wshape
    assert torch.equal(f32, tc.trim_conv2d_weight_grad_plain(xb, gb, **kw_))
    assert _rel(f32, want) <= F32_TOL
    got = f32.to(BF16)       # the one rounding _TrimConv2dFn.backward makes
    sums = _np(tc.trim_conv2d_weight_grad_plain(xb.abs(), gb.abs(), **kw_))
    bound = _ulp(np.maximum(np.abs(_np(got)), np.abs(want))) \
        + 2 * n * ho * wo * U32 * sums
    assert (np.abs(_np(got) - want) <= bound).all()


def test_weight_grad_refuses_mixed_and_other_dtypes():
    x = torch.zeros((1, 6, 6, 4), dtype=BF16)
    with pytest.raises(TypeError, match="mixed"):
        tc.trim_conv2d_weight_grad(x, x.float(), kernel_size=3, pad=1)
    with pytest.raises(TypeError):
        tc.trim_conv2d_weight_grad(x.half(), x.half(), kernel_size=3, pad=1)
    # bf16 operands give the f32 sums; f32 operands their f32 dw as before
    assert tc.trim_conv2d_weight_grad(
        x, x, kernel_size=3, pad=1).dtype == torch.float32
    xf = torch.randn((1, 6, 6, 4))
    assert torch.equal(
        tc.trim_conv2d_weight_grad(xf, xf, kernel_size=3, pad=1),
        tc.trim_conv2d_weight_grad_plain(xf, xf, kernel_size=3, pad=1))


# ---------------------------------------------------------------------------
# (b) one bf16 conv under autograd against jax.vjp of JAX's ref.conv2d
# ---------------------------------------------------------------------------

# (x shape, w shape, stride, padding): test_grad_bf16_tolerance_policy's
# geometry, and a K 11 conv (stride 4, 'valid') through the adder tree
GEOMS = {"policy": ((1, 12, 12, 6), (3, 3, 6, 8), 2, "same"),
         "k11_tree": ((2, 35, 35, 3), (11, 11, 3, 8), 4, "valid")}


@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_bf16_conv_gradients_match_jax(geom, activation):
    xs, ws, s, padding = GEOMS[geom]
    rng = np.random.default_rng(188)
    x32 = rng.standard_normal(xs).astype(np.float32)
    w32 = (rng.standard_normal(ws) * .3).astype(np.float32)
    b32 = (rng.standard_normal(ws[3]) * .1).astype(np.float32)
    leaves = [_bf16(a).requires_grad_() for a in (x32, w32, b32)]
    out = ops.conv2d(leaves[0], leaves[1], stride=s, padding=padding,
                     bias=leaves[2], activation=activation)
    assert out.dtype == BF16
    got = torch.autograd.grad((out.float() ** 2).sum(), leaves)

    def loss(x, w, b):
        y = jref.conv2d(x, w, stride=s, padding=padding, bias=b,
                        activation=activation)
        return (y.astype(jnp.float32) ** 2).sum()
    grad = jax.grad(loss, argnums=(0, 1, 2))
    want_bf16 = grad(*(jnp.asarray(t.detach().float().numpy(),
                                   jnp.bfloat16) for t in leaves))
    want_f32 = grad(*(jnp.asarray(a) for a in (x32, w32, b32)))
    for name, a, jb, jf in zip(("dx", "dw", "db"), got, want_bf16,
                               want_f32):
        assert a.dtype == BF16, name
        assert _rel(a, jb) < BF16_TOL, (name, _rel(a, jb))
        assert _rel(a, jf) < BF16_TOL, (name, _rel(a, jf))


# ---------------------------------------------------------------------------
# (c) the example CNN: one bf16 train_step against JAX
# ---------------------------------------------------------------------------

def _jax_nll(p, x, y):
    """The example's loss on f32-cast logits."""
    logits = jlayers.simple_cnn_apply(p, x, impl="ref").astype(jnp.float32)
    return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None],
                                axis=1).mean()


def test_example_cnn_bf16_train_step_against_jax():
    cfg = train_cnn.OPT
    jcfg = JAdamWConfig(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                        decay_steps=cfg.decay_steps,
                        weight_decay=cfg.weight_decay)
    p32 = jinit(jlayers.simple_cnn_params(cin=3, channels=(8, 16),
                                          n_classes=10),
                jax.random.PRNGKey(0))
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p32)
    rng = np.random.default_rng(0)
    x32 = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=4)
    xb = _bf16(x32)
    jy = jnp.asarray(y, jnp.int32)
    g32 = jax.grad(_jax_nll)(p32, jnp.asarray(x32), jy)
    gbf = jax.grad(_jax_nll)(pb, jnp.asarray(xb.float().numpy(),
                                             jnp.bfloat16), jy)

    tree = params_from_jax(jax.tree.map(np.asarray, pb))
    assert all(t.dtype == BF16 for t in adamw.tree_leaves(tree))
    live = [t.detach().requires_grad_() for t in adamw.tree_leaves(tree)]
    loss = train_cnn.nll_loss(layers.simple_cnn_apply(
        adamw.tree_unflatten(tree, live), xb), torch.from_numpy(y))
    got = torch.autograd.grad(loss, live)
    names = [f"{k}.{n}" for k in sorted(tree) for n in sorted(tree[k])]
    for name, a, want, jb in zip(names, got, jax.tree.leaves(g32),
                                 jax.tree.leaves(gbf)):
        assert a.dtype == BF16, name
        port, ref_bf16 = _rel(a, want), _rel(jb, want)
        print(f"{name}: port {port:.2e}, JAX bf16 {ref_bf16:.2e} of "
              f"max|f32 grad| from JAX's f32 gradient; port vs JAX bf16 "
              f"{_rel(a, jb):.2e}")
        assert port <= 2 * ref_bf16, (name, port, ref_bf16)
        if name.endswith(".w"):
            # the same bf16 cotangents into the same exact products, f32
            # sums rounded once on both sides: measured 0 ulps on five of
            # the six weight leaves, one element at 1 ulp at down1.w
            want_b = _np(jb)
            assert (np.abs(_np(a) - want_b)
                    <= _ulp(np.maximum(np.abs(_np(a)), np.abs(want_b)))
                    ).all(), name
        else:
            # db: XLA's transpose of the bias add sums the bf16 cotangent
            # in bf16, the port in f32 rounded once; measured up to
            # 3.8e-2 of max (conv0.b)
            assert _rel(a, jb) <= BIAS_TOL, (name, _rel(a, jb))

    moments = adamw.init_moments(tree, cfg)
    new_p, new_m, step_loss, _ = train_cnn.train_step(
        tree, moments, 0, xb, torch.from_numpy(y),
        apply_fn=layers.simple_cnn_apply, cfg=cfg)
    assert torch.equal(step_loss, loss.detach())
    jgrads = jax.tree.unflatten(jax.tree.structure(pb), [
        jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in got])
    jp, jm, _ = jadamw.apply_updates(pb, jgrads,
                                     jadamw.init_moments(pb, jcfg),
                                     jnp.int32(0), jcfg)
    for a, want in zip(adamw.tree_leaves(new_p), jax.tree.leaves(jp)):
        assert a.dtype == BF16
        want = _np(want)
        assert (np.abs(_np(a) - want) <= _ulp(want)).all()
    for key in ("mu", "nu"):
        for a, want in zip(adamw.tree_leaves(new_m[key]),
                           jax.tree.leaves(jm[key])):
            assert a.dtype == torch.float32
            assert _rel(a, want) <= 1e-6, key


# ---------------------------------------------------------------------------
# (d) fused groups under grad in bf16
# ---------------------------------------------------------------------------

def test_vgg16_bf16_fused_gradient_equals_per_layer_bitwise():
    topo = scale_layers(vgg16_layers(), 16)
    assert FusedGroupPlan.build(topo, n=1, dtype_bytes=2).fused_groups
    params = layers.TrimCNN.random(topo, n_classes=10, seed=0,
                                   device="cpu", dtype=BF16).tree()
    x = _bf16(np.random.default_rng(4).standard_normal((1, 224, 224, 3)))

    def grads(fused):
        model = layers.TrimCNN(topo, params, trainable=True, fused=fused)
        loss = (model(x).float() ** 2).sum()
        return torch.autograd.grad(loss, list(model.parameters()))

    fused, per_layer = grads(True), grads(False)
    assert len(fused) == 2 * len(topo) + 2
    for a, b in zip(fused, per_layer):
        assert a.dtype == BF16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (e) the backward's autotune lookups at bf16
# ---------------------------------------------------------------------------

def _spy(monkeypatch, name):
    seen, real = [], getattr(ops, name)

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(ops, name, spy)
    return seen


def test_bf16_backward_reads_the_bfloat16_records(monkeypatch):
    xs, ws, pads = (2, 12, 12, 8), (3, 3, 8, 16), ((1, 1), (1, 1))
    geo = input_grad_geometry(xs, ws, pad=pads)
    ig_key = dict(pad=(geo["pad_h"], geo["pad_w"]), device="cpu")
    # the bf16 dx conv (Cin/g 16) is on the tensor-core route: its record
    # names the route (one without predates it and is not read)
    for dtype, tile_go, ig in (
            ("float32", 3, dict(tile_h=5, tile_cout=4, dataflow="halo")),
            ("bfloat16", 2, dict(tile_h=4, tile_cout=8, dataflow="carry",
                                 route="mma"))):
        autotune.store(autotune.make_key(xs, ws, pad=pads, dtype=dtype,
                                         device="cpu", op="conv2d_wgrad"),
                       dict(tile_go=tile_go))
        autotune.store(autotune.make_key(geo["g_dilated_shape"],
                                         geo["wt_shape"], dtype=dtype,
                                         **ig_key), ig)
    seen_ig = _spy(monkeypatch, "trim_conv2d_input_grad")
    seen_wg = _spy(monkeypatch, "trim_conv2d_weight_grad")
    rng = np.random.default_rng(5)
    x, w = rng.standard_normal(xs), rng.standard_normal(ws) * .3
    for dtype, want_ig, want_go in ((BF16, (4, 8, "carry"), 2),
                                    (torch.float32, (5, 4, "halo"), 3)):
        xr = torch.from_numpy(x).to(dtype).requires_grad_()
        wr = torch.from_numpy(w).to(dtype).requires_grad_()
        (ops.conv2d(xr, wr).float() ** 2).sum().backward()
        assert xr.grad.dtype == wr.grad.dtype == dtype
        kw = seen_ig[-1]
        assert (kw["tile_h"], kw["tile_cout"], kw["dataflow"]) == want_ig
        assert seen_wg[-1]["tile_go"] == want_go
    # the tuner writes a bf16 problem's records under :bfloat16:
    recs = autotune.tune_backward(xs, ws, pad=pads, dtype="bfloat16",
                                  device="cpu", write=False)
    assert recs["weight_grad"]["tile_go"] == WeightGradPlan.build(
        xs, ws, pad=pads, dtype_bytes=2).tile_go
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        autotune.tune_weight_grad(xs, ws, pad=pads, dtype="int8",
                                  device="cpu")


# ---------------------------------------------------------------------------
# (f) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8])
def test_bf16_weight_grad_plan_is_the_f32_geometry(n):
    """On routes gemm and depthwise (VGG-16 conv1, the depthwise layer,
    AlexNet conv1's K 11 part, the stem) the bf16 plan is the f32 plan's
    geometry, bytes halved.  On route mma (VGG-16 conv2-13, PR 33) it
    keeps the f32 plan's fields but its chunks: its tiles are
    ``WGRAD_MMA_TILE_ROWS`` rows, its chunk height the mma time model's
    (a pure function of the shape), its workspace within the cap, and the
    partial launch's blocks are its tiles times its chunks."""
    problems = [((n, l.ifmap, l.ifmap, l.in_channels),
                 (3, 3, l.in_channels, l.out_channels), 1, 1, 1)
                for l in vgg16_layers()]
    problems += [((n, 112, 112, 32), (3, 3, 1, 32), 1, 32, 1),    # depthwise
                 ((n, 223, 222, 3), (3, 2, 3, 96), 4, 1, 0),      # K 11 part
                 ((n, 224, 224, 3), (7, 7, 3, 64), 2, 1, 3)]      # stem
    routes = []
    for xs, ws, s, g, p in problems:
        p32 = WeightGradPlan.build(xs, ws, stride=s, pad=p, groups=g)
        p16 = WeightGradPlan.build(xs, ws, stride=s, pad=p, groups=g,
                                   dtype_bytes=2)
        assert type(p16) is BF16WeightGradPlan and p16.dtype_bytes == 2
        assert type(p32) is WeightGradPlan and p32.dtype_bytes == 4
        assert p32.route in ("gemm", "depthwise")
        assert 2 * p16.min_bytes() == p32.min_bytes()
        assert p16.flops == p32.flops
        routes.append(p16.route)
        if p16.route != "mma":
            assert p16.route == p32.route
            assert dataclasses.astuple(p16) == dataclasses.astuple(p32)
            for prop in ("tile_cout", "chunks", "blocks",
                         "workspace_bytes"):
                assert getattr(p16, prop) == getattr(p32, prop), prop
            continue
        fields = dataclasses.asdict(p16)
        assert {k: v for k, v in fields.items() if k != "tile_go"} == \
            {k: v for k, v in dataclasses.asdict(p32).items()
             if k != "tile_go"}
        assert p16.tile_cout == p32.tile_cout
        assert p16.tiles == -(-p16.rows // cp.WGRAD_MMA_TILE_ROWS) * \
            -(-p16.cout_per_group // p16.tile_cout)
        assert p16.blocks == p16.tiles * p16.chunks
        assert p16.workspace_bytes <= cp.WGRAD_WORKSPACE_CAP
        again = WeightGradPlan.build(xs, ws, stride=s, pad=p, groups=g,
                                     dtype_bytes=2)
        assert again == p16
        # the mma time model's chunk height, not the FFMA model's
        rows = p16.n * p16.h_out
        _, min_rows = cp._wgrad_min_rows(rows, p16.w_out, p16.dw_elems)
        assert p16.tile_go == min(
            range(rows, min_rows - 1, -1),
            key=lambda t: (p16.model_seconds(t), -t))
    assert routes == ["gemm"] + ["mma"] * 12 + ["depthwise", "gemm", "gemm"]
    with pytest.raises(ValueError, match="dtype_bytes"):
        WeightGradPlan.build((1, 8, 8, 4), (3, 3, 4, 4), dtype_bytes=1)
