"""Parity of the port's gradients with the JAX package on the CPU.

The same numpy inputs (from a seed) go through the JAX functions and their
counterparts in the port, whose wrappers run their plain PyTorch versions
on CPU tensors:

* ``input_grad_geometry`` against JAX's (symmetric pads), and the port's
  asymmetric XLA-'same' pads at stride 2 (odd and even sizes);
* ``trim_conv2d_input_grad`` against JAX's, which runs the Pallas carry
  kernel (interpret mode), on the six shapes of ``tests/test_grad.py``;
* ``trim_conv2d_weight_grad`` against JAX ``ref.conv2d_grads`` on the same
  six (the JAX weight-grad kernel does not run on this JAX version:
  ``pl.unblocked`` is gone);
* ``torch.autograd.grad`` of ``ops.conv2d`` against ``jax.grad`` of
  ``ref.conv2d`` on the grid of ``tests/test_grad.py`` (halo included).

Tolerance: 1e-5 of max|reference| (DESIGN.md §5, ``tests/test_grad.py``):
both sides accumulate in f32, only the summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv_plan as jconv_plan
from repro.kernels import ref as jref
from repro.kernels.trim_conv2d import \
    trim_conv2d_input_grad as j_input_grad
from repro_torch.core import conv_plan as cp
from repro_torch.core.conv_plan import WeightGradPlan, input_grad_geometry
from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv2d as tc

TOL = 1e-5


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


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * (float(np.abs(want).max()) + 1e-9), err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# ---------------------------------------------------------------------------
# input_grad_geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_shape,w_shape,stride,pad,groups", [
    ((2, 8, 8, 4), (3, 3, 4, 8), 1, 0, 1),
    ((2, 12, 10, 4), (3, 3, 4, 8), 2, 1, 1),
    ((1, 11, 13, 6), (5, 5, 3, 6), 3, 2, 2),
    ((2, 10, 10, 8), (3, 3, 1, 8), 2, 1, 8),
    ((2, 9, 9, 4), (1, 1, 4, 4), 1, 0, 1),
    ((2, 14, 9, 5), (4, 4, 5, 7), 2, 1, 1),
])
def test_input_grad_geometry_matches_jax(x_shape, w_shape, stride, pad,
                                         groups):
    want = jconv_plan.input_grad_geometry(x_shape, w_shape, stride=stride,
                                          pad=pad, groups=groups)
    got = input_grad_geometry(x_shape, w_shape, stride=stride, pad=pad,
                              groups=groups)
    assert got == want


@pytest.mark.parametrize("h,w", [(10, 10), (11, 11), (10, 13), (13, 8)])
def test_input_grad_geometry_asymmetric_same_pads(h, w):
    """XLA 'same' at stride 2 pads (0, 1) on an even size and (1, 1) on an
    odd one; the edge pads must land dx back on x's shape, and the dx they
    give must equal the oracle's."""
    k, s = 3, 2
    pads = ref.conv_pads(h, w, k, s, "same")
    geo = input_grad_geometry((2, h, w, 4), (k, k, 4, 6), stride=s,
                              pad=pads)
    assert (geo["h_out"], geo["w_out"]) == (-(-h // s), -(-w // s))
    _, hp, wp, _ = geo["g_padded_shape"]
    assert (hp - k + 1, wp - k + 1) == (h, w)
    assert geo["pad_h"][0] == k - 1 - pads[0][0]
    rng = np.random.default_rng(h * 100 + w)
    x = _t(rng.standard_normal((2, h, w, 4)))
    wt = _t(rng.standard_normal((k, k, 4, 6)) * .3)
    gy = _t(rng.standard_normal((2, geo["h_out"], geo["w_out"], 6)))
    got = tc.trim_conv2d_input_grad(gy, wt, x_shape=tuple(x.shape),
                                    stride=s, pad=pads)
    _close(got, ref.conv2d_input_grad(x, wt, gy, stride=s, padding="same"))


def test_input_grad_geometry_rejects_pads_beyond_k_minus_1():
    with pytest.raises(ValueError, match="K-1"):
        input_grad_geometry((1, 8, 8, 2), (3, 3, 2, 2), pad=((0, 3), (0, 0)))


# ---------------------------------------------------------------------------
# Backward kernels vs the JAX package (tests/test_grad.py:39-46)
# ---------------------------------------------------------------------------

SHAPES = [
    (8, 8, 4, 8, 3, 1, 0, 1),
    (12, 10, 4, 8, 3, 2, 1, 1),      # (h+2p-k) % s != 0 residual
    (11, 13, 6, 6, 5, 3, 2, 2),      # grouped, stride 3
    (10, 10, 8, 8, 3, 2, 1, 8),      # depthwise strided
    (9, 9, 4, 4, 1, 1, 0, 1),        # 1x1
    (14, 9, 5, 7, 4, 2, 1, 1),       # even K
]


def _shape_inputs(h, w, cin, cout, k, s, pad, g, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin // g, cout)) * .3).astype(np.float32)
    ho = (h + 2 * pad - k) // s + 1
    wo = (w + 2 * pad - k) // s + 1
    gy = rng.standard_normal((2, ho, wo, cout)).astype(np.float32)
    return x, wt, gy


@pytest.mark.parametrize("case", SHAPES)
def test_input_grad_matches_jax_carry_kernel(case):
    """The port pads virtually; JAX takes the pre-padded input, so its dx
    is cropped back to x."""
    h, w, cin, cout, k, s, pad, g = case
    x, wt, gy = _shape_inputs(*case, seed=sum(case))
    xp_shape = (2, h + 2 * pad, w + 2 * pad, cin)
    want = np.asarray(j_input_grad(jnp.asarray(gy), jnp.asarray(wt),
                                   x_shape=xp_shape, stride=s, pad=0,
                                   groups=g))
    want = want[:, pad:pad + h, pad:pad + w]
    got = tc.trim_conv2d_input_grad(_t(gy), _t(wt), x_shape=x.shape,
                                    stride=s, pad=pad, groups=g)
    _close(got, want)


@pytest.mark.parametrize("case", SHAPES)
def test_weight_grad_matches_jax_ref(case):
    h, w, cin, cout, k, s, pad, g = case
    x, wt, gy = _shape_inputs(*case, seed=sum(case) + 1)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    _, want = jref.conv2d_grads(xp, jnp.asarray(wt), jnp.asarray(gy),
                                stride=s, padding="valid",
                                feature_group_count=g)
    got = tc.trim_conv2d_weight_grad(_t(x), _t(gy), kernel_size=k,
                                     stride=s, pad=pad, groups=g)
    _close(got, want)


@pytest.mark.parametrize("tile_go", [1, 2, 3, 7, 100])
def test_weight_grad_chunking_does_not_change_the_function(tile_go):
    """Chunks of any height (ragged, crossing images, one chunk) compute
    the same dw; the plan caps the workspace and clamps the height."""
    x, wt, gy = _shape_inputs(12, 10, 4, 8, 3, 2, 1, 1, seed=tile_go)
    plan = WeightGradPlan.build(x.shape, wt.shape, stride=2, pad=1,
                                tile_go=tile_go)
    assert plan.tile_go == min(tile_go, 2 * 6)
    assert plan.chunks == -(-12 // plan.tile_go)
    assert plan.workspace_bytes == (0 if plan.chunks == 1 else
                                    4 * plan.chunks * wt.size)
    got = tc.trim_conv2d_weight_grad(_t(x), _t(gy), kernel_size=3, stride=2,
                                     pad=1, tile_go=tile_go)
    _close(got, ref.conv2d_weight_grad(
        ref.pad_nhwc(_t(x), ((1, 1), (1, 1))), _t(wt), _t(gy), stride=2,
        padding="valid"))


@pytest.mark.parametrize("layer,x_shape,cout,tile_go,chunks", [
    ("conv1", (8, 224, 224, 3), 64, 7, 256),
    ("conv2", (8, 224, 224, 64), 64, 35, 52),
    ("conv9", (8, 28, 28, 512), 512, 32, 7),
    ("conv13", (8, 14, 14, 512), 512, 23, 5),
])
def test_weight_grad_plan_at_vgg16_shapes(layer, x_shape, cout, tile_go,
                                          chunks):
    """The chunk count is a pure function of the shape: chunks of at least
    256 positions, as tall as whole rounds of resident blocks allow, the
    workspace within 256 MiB."""
    plan = WeightGradPlan.build(x_shape, (3, 3, x_shape[3], cout), pad=1)
    assert (plan.tile_go, plan.chunks) == (tile_go, chunks), layer
    assert plan.route == "gemm"
    assert plan.tile_go * plan.w_out >= 256
    assert 0 < plan.workspace_bytes <= 256 * 2**20
    assert plan.flops == 2 * 8 * x_shape[1] ** 2 * cout * 9 * x_shape[3]


def _vgg16_wgrad_plans(n=8):
    from repro_torch.core.model import vgg16_layers
    plans = [(l.name, WeightGradPlan.build(
        (n, l.ifmap, l.ifmap, l.in_channels),
        (3, 3, l.in_channels, l.out_channels), pad=1))
        for l in vgg16_layers()]
    plans.append(("s2_56x128", WeightGradPlan.build(
        (n, 56, 56, 128), (3, 3, 128, 256), stride=2, pad=1)))
    return plans


@pytest.mark.parametrize("name,plan", _vgg16_wgrad_plans(),
                         ids=[name for name, _ in _vgg16_wgrad_plans()])
def test_weight_grad_plan_reaches_the_wave_target(name, plan):
    """Every GEMM-route plan of VGG-16 at batch 8 (and the stride-2 case)
    puts two blocks on at least 90% of the 132 SMs, and its last round of
    resident blocks is at least 90% full."""
    assert plan.route == "gemm"
    slots = cp.WGRAD_SLOTS
    assert slots == 132 * 2
    assert plan.blocks >= 0.9 * slots, name
    rounds = -(-plan.blocks // slots)
    assert plan.blocks >= 0.9 * rounds * slots, name
    assert plan.tile_cout == (64 if plan.cout <= 64 else 128)
    assert plan.blocks == plan.chunks * plan.tiles == plan.chunks * \
        -(-plan.rows // 128) * -(-plan.cout // plan.tile_cout)


@pytest.mark.parametrize("x_shape,w_shape", [
    ((8, 56, 56, 1024), (3, 3, 1024, 1024)),    # the cap binds: 7 chunks
    ((8, 28, 28, 1024), (3, 3, 1024, 1024)),
    ((8, 224, 224, 64), (3, 3, 64, 64)),
    ((1, 64, 16, 2048), (3, 3, 2048, 4096)),    # one chunk, no workspace
])
def test_weight_grad_plan_workspace_stays_under_the_cap(x_shape, w_shape):
    plan = WeightGradPlan.build(x_shape, w_shape, pad=1)
    cap = cp.WGRAD_WORKSPACE_CAP
    assert plan.workspace_bytes <= cap
    assert plan.chunks <= max(1, cap // (4 * plan.dw_elems))
    # an override taller or shorter than the cap allows is raised to it
    low = WeightGradPlan.build(x_shape, w_shape, pad=1, tile_go=1)
    assert low.workspace_bytes <= cap
    assert low.tile_go == min(plan.n * plan.h_out,
                              -(-plan.n * plan.h_out
                                // max(1, cap // (4 * plan.dw_elems))))


@pytest.mark.parametrize("x_shape,w_shape,groups,route", [
    ((8, 112, 112, 32), (3, 3, 1, 32), 32, "depthwise"),
    ((2, 10, 10, 8), (3, 3, 1, 8), 8, "depthwise"),
    ((2, 20, 20, 16), (7, 7, 1, 16), 16, "depthwise"),
    ((2, 10, 10, 8), (3, 3, 1, 16), 8, "gemm"),       # channel multiplier 2
    ((2, 20, 20, 6), (3, 3, 3, 12), 2, "gemm"),       # Cin/g 3, Cout/g 6
    ((2, 10, 10, 8), (3, 3, 2, 8), 4, "gemm"),
    ((2, 10, 10, 1), (3, 3, 1, 1), 1, "depthwise"),   # groups == Cin == Cout
    ((2, 10, 10, 4), (3, 3, 4, 8), 1, "gemm"),
])
def test_weight_grad_plan_routes_depthwise_only(x_shape, w_shape, groups,
                                                route):
    plan = WeightGradPlan.build(x_shape, w_shape, pad=1, groups=groups)
    assert plan.route == route
    if route == "depthwise":
        assert plan.tiles == -(-plan.dw_elems // 256)
        assert plan.blocks >= min(cp.WGRAD_DW_BLOCKS,
                                  plan.tiles * plan.n * plan.h_out)


@pytest.mark.parametrize("case", [
    (12, 12, 8, 8, 3, 1, 1, 8),      # depthwise route
    (10, 9, 6, 12, 3, 2, 1, 2),      # Cin/g 3, Cout/g 6
    (16, 16, 8, 16, 3, 1, 1, 1),
])
@pytest.mark.parametrize("tile_go", [None, 1, 3, 1000])
def test_weight_grad_chunked_order_matches_jax_ref(case, tile_go):
    """The kernels' summation order — one chain a chunk of the plan's
    cotangent rows, then the partials in ascending chunk order — replayed
    in plain PyTorch stays within 1e-5 of JAX ``ref.conv2d_grads``, and
    so does the wrapper, for the plan's chunking and any override."""
    h, w, cin, cout, k, s, pad, g = case
    x, wt, gy = _shape_inputs(*case, seed=h * w + (tile_go or 0))
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    _, want = jref.conv2d_grads(xp, jnp.asarray(wt), jnp.asarray(gy),
                                stride=s, padding="valid",
                                feature_group_count=g)
    plan = WeightGradPlan.build(x.shape, wt.shape, stride=s, pad=pad,
                                groups=g, tile_go=tile_go)
    n, ho = gy.shape[0], gy.shape[1]
    rows = np.arange(n * ho)
    dw = None
    for c in range(plan.chunks):
        sel = rows[c * plan.tile_go:(c + 1) * plan.tile_go]
        gs = np.zeros_like(gy)
        for r in sel:       # the chunk's cotangent rows, zeros elsewhere
            gs[r // ho, r % ho] = gy[r // ho, r % ho]
        part = tc.trim_conv2d_weight_grad_plain(
            _t(x), _t(gs), kernel_size=k, stride=s, pad=pad, groups=g)
        dw = part if dw is None else dw + part
    _close(dw, want)
    got = tc.trim_conv2d_weight_grad(_t(x), _t(gy), kernel_size=k,
                                     stride=s, pad=pad, groups=g,
                                     tile_go=tile_go)
    _close(got, want)


def test_weight_grad_plan_single_chunk_has_no_workspace():
    plan = WeightGradPlan.build((1, 64, 16, 2048), (3, 3, 2048, 4096), pad=1)
    assert plan.chunks == 1 and plan.workspace_bytes == 0


# ---------------------------------------------------------------------------
# autograd of ops.conv2d vs jax.grad of ref.conv2d (tests/test_grad.py:99)
# ---------------------------------------------------------------------------

GRID = [
    # h, w, cin, cout, k, s, padding, groups, activation, dataflow
    (10, 10, 4, 8, 3, 1, "same", 1, None, None),
    (10, 10, 4, 8, 3, 1, "same", 1, "relu", None),
    (12, 9, 4, 8, 3, 2, "same", 1, "gelu", None),
    (12, 12, 8, 8, 3, 2, "valid", 8, "silu", None),
    (14, 14, 6, 9, 3, 1, "same", 3, None, "halo"),
    (11, 11, 4, 4, 1, 1, "valid", 1, None, None),
]


@pytest.mark.parametrize("case", GRID)
def test_autograd_conv2d_matches_jax_grad_of_ref(case):
    h, w, cin, cout, k, s, padding, g, act, df = case
    rng = np.random.default_rng(h * w + cout)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin // g, cout)) * .3).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    kw = dict(stride=s, padding=padding, feature_group_count=g,
              activation=act)

    def loss_ref(x, wt, b):
        return (jref.conv2d(x, wt, bias=b, **kw) ** 2).sum()

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    leaves = [_t(a).requires_grad_() for a in (x, wt, b)]
    y = ops.conv2d(*leaves[:2], bias=leaves[2], dataflow=df, **kw)
    got = torch.autograd.grad((y ** 2).sum(), leaves)
    for a, r in zip(got, want):
        _close(a, r)


def test_autograd_skips_dx_when_x_needs_no_grad():
    """The first layer's input needs no gradient: no input-gradient conv
    runs (on the card, one launch fewer of the forward kernel)."""
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((1, 6, 6, 2)))
    wt = _t(rng.standard_normal((3, 3, 2, 3))).requires_grad_()
    calls = []
    real = tc.trim_conv2d_input_grad
    try:
        ops.trim_conv2d_input_grad = lambda *a, **k: calls.append(1) or \
            real(*a, **k)
        y = ops.conv2d(x, wt, activation="relu")
        (dw,) = torch.autograd.grad(y.sum(), [wt])
    finally:
        ops.trim_conv2d_input_grad = real
    assert calls == [] and dw.shape == wt.shape


def test_no_grad_path_is_the_fused_launch():
    """Without grad the conv is the served, fused launch: its output
    carries no graph and equals the autograd path's forward."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((1, 7, 7, 3)))
    wt = _t(rng.standard_normal((3, 3, 3, 4))).requires_grad_()
    with torch.no_grad():
        served = ops.conv2d(x, wt, activation="gelu")
    trained = ops.conv2d(x, wt, activation="gelu")
    assert served.grad_fn is None and trained.grad_fn is not None
    _close(trained.detach(), served)
