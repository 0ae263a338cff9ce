"""The port's int8 inference route against the JAX package on the CPU.

The same numpy inputs (from a seed) go through both packages:

* the four ``ref`` functions (``quantize_int8``, ``weight_scales_int8``,
  ``dequant_params``, ``conv2d_quantized``), bitwise;
* ``trim_conv2d_q8`` (its plain version on CPU tensors) against the JAX
  ``trim_conv2d`` with a ``scale`` on the carry kernel in interpret mode,
  over ``tests/test_quant.py``'s grid of K, stride, groups and padding, and
  the halo dataflow against JAX ``ref.conv2d_quantized`` (the JAX halo
  kernel does not run on this JAX version: ``pl.unblocked`` is gone);
* ``calibrate_conv2d`` (scale, zero point, int8 weights, int32 bias) and
  ``ops.conv2d`` on the calibrated layer, ``guard.events()`` empty so the
  JAX side ran its int8 kernel and did not demote;
* ``params_from_jax`` on a calibrated JAX tree, dtypes included;
* VGG-16 at 1/16 width on a 32x32 image, calibrated layer by layer in
  both packages on the same f32 layer inputs, and a CPU ``ServingEngine``
  on it;
* the refusals: mixed dtypes, ``fused=True``, ``trainable=True`` and
  gradients.

Tolerance: bitwise for activation None and relu (integer sums are exact
and the epilogue is one int32 add and one f32 multiply in both); for gelu
and silu 1e-5 * max(1, max|jax|), the f32 route's, since XLA's and
PyTorch's transcendentals differ.  The network's logits: 1e-5 (DESIGN.md
§5), the f32 head's sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guard
from repro.core import netplan as jnetplan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.trim_conv2d import trim_conv2d as jtrim_conv2d
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro_torch.convert import params_from_jax
from repro_torch.core.conv_plan import SMEM_PER_BLOCK, ConvPlan, same_pads
from repro_torch.core.netplan import (infer_pools, layer_kernel_problem,
                                      network_layers, scale_layers)
from repro_torch.core.serving import ServingEngine, replay
from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.models import layers
from repro_torch.testing.load import poisson_arrivals

TOL = 1e-5
ACTS = [None, "relu", "gelu", "silu"]
# tests/test_quant.py's grid: (K, stride, groups, padding)
GRID = [(1, 1, 1, "same"), (3, 1, 1, "same"), (3, 2, 1, "same"),
        (3, 1, 2, "same"), (5, 1, 2, "same"), (3, 2, 2, "valid"),
        (1, 1, 1, "valid")]


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want, act=None):
    """Bitwise for None / relu, else within the f32 tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if act in (None, "relu"):
        assert np.array_equal(got, want), float(np.abs(got - want).max())
    else:
        err = float(np.abs(got - want).max())
        assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def _problem(k, groups, seed, zero_point=3, bias=True, shape=(2, 13, 11)):
    """test_quant.py's ``_quantize_problem``: f32 data quantized by the
    JAX ``ref`` (held against the port's below), as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, 8)).astype(np.float32)
    w = (rng.standard_normal((k, k, 8 // groups, 12)) * 0.1).astype(
        np.float32)
    b = rng.standard_normal(12).astype(np.float32) if bias else None
    x_scale = np.float32(np.abs(x).max() / np.float32(127.0))
    w_scale = jref.weight_scales_int8(jnp.asarray(w))
    return dict(x=x, w=w, b=b, x_scale=x_scale, zp=zero_point,
                x_q=np.asarray(jref.quantize_int8(jnp.asarray(x), x_scale,
                                                  zero_point)),
                w_q=np.asarray(jref.quantize_int8(
                    jnp.asarray(w), w_scale[None, None, None, :])),
                w_scale=np.asarray(w_scale))


# ---------------------------------------------------------------------------
# ref: the four functions, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,groups", [(1, 1), (3, 1), (3, 2), (5, 2)])
def test_quantize_and_weight_scales_match_jax(k, groups):
    q = _problem(k, groups, seed=k + groups)
    x_q = ref.quantize_int8(_t(q["x"]), torch.tensor(q["x_scale"]), q["zp"])
    assert x_q.dtype == torch.int8
    assert np.array_equal(x_q.numpy(), q["x_q"])
    w_scale = ref.weight_scales_int8(_t(q["w"]))
    assert w_scale.dtype == torch.float32
    assert np.array_equal(w_scale.numpy(), q["w_scale"])
    w_q = ref.quantize_int8(_t(q["w"]), w_scale[None, None, None, :])
    assert np.array_equal(w_q.numpy(), q["w_q"])
    # a Python-float scale, a zero point at the clip edge, all-zero weights
    assert np.array_equal(
        ref.quantize_int8(_t(q["x"]), float(q["x_scale"]), -128).numpy(),
        np.asarray(jref.quantize_int8(jnp.asarray(q["x"]),
                                      float(q["x_scale"]), -128)))
    zeros = np.zeros((k, k, 2, 3), np.float32)
    assert np.array_equal(ref.weight_scales_int8(_t(zeros)).numpy(),
                          np.asarray(jref.weight_scales_int8(
                              jnp.asarray(zeros))))


@pytest.mark.parametrize("bias", [True, False])
def test_dequant_params_match_jax(bias):
    q = _problem(3, 2, seed=11, zero_point=-5, bias=bias)
    want_s, want_b = jref.dequant_params(
        jnp.asarray(q["w_q"]), jnp.asarray(q["w_scale"]), q["x_scale"],
        q["zp"], None if q["b"] is None else jnp.asarray(q["b"]))
    scale, bias_q = ref.dequant_params(
        _t(q["w_q"]), _t(q["w_scale"]), torch.tensor(q["x_scale"]), q["zp"],
        None if q["b"] is None else _t(q["b"]))
    assert (scale.dtype, bias_q.dtype) == (torch.float32, torch.int32)
    assert np.array_equal(scale.numpy(), np.asarray(want_s))
    assert np.array_equal(bias_q.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("k,stride,groups,padding", GRID)
def test_conv2d_quantized_matches_jax(k, stride, groups, padding):
    i = GRID.index((k, stride, groups, padding))
    act = ACTS[i % 4]
    q = _problem(k, groups, seed=20 + i)
    want = jref.conv2d_quantized(
        jnp.asarray(q["x_q"]), jnp.asarray(q["w_q"]), x_scale=q["x_scale"],
        x_zero_point=q["zp"], w_scale=jnp.asarray(q["w_scale"]),
        bias=jnp.asarray(q["b"]), stride=stride, padding=padding,
        feature_group_count=groups, activation=act)
    got = ref.conv2d_quantized(
        _t(q["x_q"]), _t(q["w_q"]), x_scale=torch.tensor(q["x_scale"]),
        x_zero_point=q["zp"], w_scale=_t(q["w_scale"]), bias=_t(q["b"]),
        stride=stride, padding=padding, feature_group_count=groups,
        activation=act)
    _same(got, want, act)


# ---------------------------------------------------------------------------
# The int8 kernel's plain version against the JAX kernel and oracle
# ---------------------------------------------------------------------------

def _q8_port(q, k, stride, groups, padding, act, dataflow):
    b = None if q["b"] is None else _t(q["b"])
    scale, bias_q = ref.dequant_params(_t(q["w_q"]), _t(q["w_scale"]),
                                       torch.tensor(q["x_scale"]), q["zp"], b)
    h, w = q["x_q"].shape[1:3]
    pads = ((same_pads(h, k, stride), same_pads(w, k, stride))
            if padding == "same" else 0)
    return tc.trim_conv2d_q8(_t(q["x_q"]), _t(q["w_q"]), bias_q, scale,
                             zero_point=q["zp"], stride=stride, pad=pads,
                             groups=groups, activation=act,
                             dataflow=dataflow)


def _q8_jax_kernel(q, k, stride, groups, padding, act):
    """test_quant.py's ``_kernel_vs_oracle``: the JAX int8 kernel on the
    input pre-padded with the zero point."""
    b = None if q["b"] is None else jnp.asarray(q["b"])
    scale, bias_q = jref.dequant_params(
        jnp.asarray(q["w_q"]), jnp.asarray(q["w_scale"]), q["x_scale"],
        q["zp"], b)
    x_k = jnp.asarray(q["x_q"])
    if padding == "same":
        h, w = x_k.shape[1:3]
        x_k = jax.lax.pad(x_k, jnp.asarray(q["zp"], jnp.int8),
                          ((0, 0, 0), (*same_pads(h, k, stride), 0),
                           (*same_pads(w, k, stride), 0), (0, 0, 0)))
    return jtrim_conv2d(x_k, jnp.asarray(q["w_q"]), bias_q, scale,
                        stride=stride, pad=0, groups=groups, activation=act,
                        dataflow="carry", interpret=True)


@pytest.mark.parametrize("k,stride,groups,padding", GRID)
def test_q8_carry_matches_jax_int8_kernel(k, stride, groups, padding):
    i = GRID.index((k, stride, groups, padding))
    act = ACTS[(i + 1) % 4]
    q = _problem(k, groups, seed=40 + i)
    want = _q8_jax_kernel(q, k, stride, groups, padding, act)
    got = _q8_port(q, k, stride, groups, padding, act, "carry")
    assert got.dtype == torch.float32
    _same(got, want, act)


@pytest.mark.parametrize("k,stride,groups,padding", GRID)
def test_q8_halo_matches_jax_oracle(k, stride, groups, padding):
    i = GRID.index((k, stride, groups, padding))
    act = ACTS[(i + 2) % 4]
    q = _problem(k, groups, seed=60 + i)
    want = jref.conv2d_quantized(
        jnp.asarray(q["x_q"]), jnp.asarray(q["w_q"]), x_scale=q["x_scale"],
        x_zero_point=q["zp"], w_scale=jnp.asarray(q["w_scale"]),
        bias=jnp.asarray(q["b"]), stride=stride, padding=padding,
        feature_group_count=groups, activation=act)
    _same(_q8_port(q, k, stride, groups, padding, act, "halo"), want, act)


@pytest.mark.parametrize("dataflow", ["carry", "halo"])
def test_q8_no_bias_nonzero_zero_point(dataflow):
    """The zero-point correction alone: 'same' borders read the zero
    point, not 0 (test_quant.py's case, both dataflows)."""
    q = _problem(3, 1, seed=7, zero_point=-9, bias=False, shape=(1, 12, 12))
    want = _q8_jax_kernel(q, 3, 1, 1, "same", None)
    _same(_q8_port(q, 3, 1, 1, "same", None, dataflow), want)


def test_q8_plan_holds_the_window_in_bytes():
    """dtype_bytes=1 plans the int8 kernel: its own tiles with the window
    in bytes, 16-channel pitches where Cin/g allows, Cin/g rounded to a
    word otherwise; the f32 plan of the same problem is the f32 kernel's
    (no int8 route or warps)."""
    f32 = ConvPlan.build((8, 56, 56, 256), (3, 3, 256, 256), pad=1)
    q8 = ConvPlan.build((8, 56, 56, 256), (3, 3, 256, 256), pad=1,
                        dtype_bytes=1)
    assert (f32.dtype_bytes, q8.dtype_bytes) == (4, 1)
    assert (f32.route, f32.warps_n, f32.warps_k, f32.m_frags) == \
        ("f32", 0, 0, 0)
    assert q8.cin_stride in (256 + 16, 256)
    assert q8.ring_rows * q8.row_bytes < q8.smem_bytes \
        <= SMEM_PER_BLOCK
    assert q8.min_bytes() == (8 * 56 * 56 * 256 + 9 * 256 * 256
                              + 4 * (2 * 256 + 8 * 56 * 56 * 256))
    conv1 = ConvPlan.build((1, 224, 224, 3), (3, 3, 3, 64), pad=1,
                           dtype_bytes=1)
    assert conv1.cin_stride == 4
    dw = ConvPlan.build((1, 16, 16, 8), (3, 3, 1, 8), pad=1, groups=8,
                        dtype_bytes=1)
    assert dw.cin_stride == 4
    # 4 (f32), 2 (bf16) and 1 (int8) are the kernels' element sizes
    with pytest.raises(ValueError, match="dtype_bytes"):
        ConvPlan(n=1, h=8, w=8, cin=4, cout=4, kh=3, kw=3, stride=1,
                 pads=((1, 1), (1, 1)), groups=1, tile_h=1, tile_w=1,
                 tile_cout=4, dtype_bytes=3)


def test_q8_plan_constants_match_the_kernel():
    """The namespace-scope ``constexpr``s of ``trim_conv2d_q8.cu``
    against their Python mirrors in ``core/conv_plan.py``, so the plan's
    shared memory and blocks cannot drift from the kernel's."""
    import re
    from repro_torch.core import conv_plan as cp
    from repro_torch.kernels.build import CSRC
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 (CSRC / "trim_conv2d_q8.cu").read_text(),
                                 re.M):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    assert found == {
        "kThreads": cp.CONV_THREADS,
        "kWarps": cp.Q8_WARPS,
        "kMmaM": cp.Q8_MMA_M,
        "kMmaN": cp.Q8_MMA_N,
        "kMmaK": cp.Q8_MMA_K,
        "kWarpN": cp.Q8_WARP_N,
        "kMaxMFrags": cp.Q8_MAX_M_FRAGS,
        "kMaxMFragsTwo": cp.Q8_M_FRAGS_TWO,
        "kStageSteps": cp.Q8_STAGE_STEPS,
        "kStages": cp.Q8_STAGES,
        "kRowPad": cp.Q8_ROW_PAD,
        "kStagingBytes": cp.Q8_STAGING,
        "kIm2colMaxK": cp.Q8_IM2COL_MAX_K,
        "kPositions": cp.CONV_POSITIONS,
        "kCout": cp.CONV_COUT,
        "kQuad": cp.Q8_QUAD,
        "kVec": cp.Q8_VEC,
        "kChunk": cp.Q8_WEIGHT_CHUNK,
        "kDp4aStages": cp.Q8_WEIGHT_STAGES,
        "kMaxSmemBytes": cp.SMEM_PER_BLOCK,
        "kSmemPerSm": cp.SMEM_PER_SM,
        "kReservedSmem": cp.SMEM_RESERVED_PER_BLOCK,
        "kWPitch": cp.Q8_STAGE_STEPS * cp.Q8_MMA_K + cp.Q8_ROW_PAD,
    }
    # the launcher's blocks-per-SM instances are the plan's
    assert cp.CONV_BLOCKS_PER_SM == 2


@pytest.mark.parametrize("k,cin_pg,cout,tap,kpad", [
    (3, 5, 6, 8, 96),        # dp4a / im2col: Cin4 = 8, 72 bytes -> 96
    (3, 3, 64, 4, 64),       # VGG-16 conv1: 36 bytes -> two k-steps
    (5, 3, 16, 4, 128),      # K 5: 100 bytes -> four k-steps
    (3, 48, 40, 64, 576),    # mma: a 16-channel tail padded to 32
    (3, 64, 8, 64, 576),     # mma: whole k-steps
    (1, 16, 24, 32, 32),
])
def test_pack_q8_weights_layout(k, cin_pg, cout, tap, kpad):
    """K-major rows, one an output channel: tap (ki, kj) at byte
    ``(ki K + kj) tap``, its channels in order; zero past Cin/g in each
    tap and past ``K K tap`` in the row; the round trip gives ``w``."""
    from repro_torch.core.conv_plan import q8_kpad, q8_tap_bytes
    w = torch.randint(-127, 128, (k, k, cin_pg, cout), dtype=torch.int8)
    wp = tc.pack_q8_weights(w)
    assert (q8_tap_bytes(cin_pg), q8_kpad(k, cin_pg)) == (tap, kpad)
    assert wp.shape == (cout, kpad) and wp.dtype == torch.int8
    assert wp.is_contiguous()
    taps = wp[:, :k * k * tap].reshape(cout, k, k, tap)
    assert torch.equal(taps[..., :cin_pg].permute(1, 2, 3, 0), w)
    assert not taps[..., cin_pg:].any()
    assert not wp[:, k * k * tap:].any()


# ---------------------------------------------------------------------------
# calibrate_conv2d, ops.conv2d and params_from_jax
# ---------------------------------------------------------------------------

def _calibrated(k=3, groups=1, stride=1, padding="same", seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 14, 14, 8)) + 0.3).astype(np.float32)
    w = (rng.standard_normal((k, k, 8 // groups, 16)) * 0.1).astype(
        np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    jp = jlayers.calibrate_conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  jnp.asarray(x), groups=groups,
                                  stride=stride, padding=padding)
    p = layers.calibrate_conv2d({"w": _t(w), "b": _t(b)}, _t(x),
                                groups=groups)
    return x, jp, p


def test_calibrate_conv2d_matches_jax_bitwise():
    _, jp, p = _calibrated()
    jpk, pk = jp["packed"], p["packed"]
    assert isinstance(pk, ops.QuantizedConv2dWeights)
    assert pk.zero_point.dtype == torch.int32
    assert pk.input_scale.dtype == torch.float32
    assert pk.zp == int(jpk.zero_point)
    assert np.array_equal(pk.zero_point.numpy(), np.asarray(jpk.zero_point))
    assert np.array_equal(pk.input_scale.numpy(),
                          np.asarray(jpk.input_scale))
    g, cout = jpk.groups, jpk.cout
    assert np.array_equal(pk.w.numpy(), np.asarray(
        jops._unpack_weights(jpk.w, g, cout)))
    assert np.array_equal(pk.scale.numpy(), np.asarray(
        jops._unpack_cout_row(jpk.scale, g, cout)))
    assert np.array_equal(pk.w_kernel.numpy(), tc.pack_q8_weights(pk.w)
                          .numpy())
    # the int32 bias the kernels are given (JAX: on the padded layout)
    want_s, want_b = jref.dequant_params(jpk.w, jpk.scale, jpk.input_scale,
                                         jpk.zero_point, jpk.bias)
    scale, bias_q = ref.dequant_params(pk.w, pk.scale, pk.input_scale,
                                       pk.zero_point, pk.bias)
    assert np.array_equal(bias_q.numpy(), np.asarray(
        jops._unpack_cout_row(want_b.reshape(1, -1), g, cout)))
    assert np.array_equal(scale.numpy(), np.asarray(
        jops._unpack_cout_row(want_s.reshape(1, -1), g, cout)))


@pytest.mark.parametrize("k,groups,stride,padding,act",
                         [(3, 1, 1, "same", "relu"), (3, 2, 2, "valid", None),
                          (1, 1, 1, "same", "gelu"), (5, 2, 1, "same", "relu")])
def test_ops_conv2d_on_calibrated_weights_matches_jax(k, groups, stride,
                                                      padding, act):
    x, jp, p = _calibrated(k, groups, stride, padding, seed=k + groups)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jp["packed"],
                                  stride=stride, padding=padding,
                                  activation=act, dataflow="carry",
                                  use_autotune_cache=False))
    assert guard.events() == [], "JAX side demoted from its int8 kernel"
    for df in ("carry", "halo"):
        got = ops.conv2d(_t(x), p["packed"], stride=stride, padding=padding,
                         feature_group_count=groups, activation=act,
                         dataflow=df)
        _same(got, want, act)
    # the oracle route and an already-quantized input agree too
    got = ops.conv2d(_t(x), p["packed"], stride=stride, padding=padding,
                     activation=act, impl="ref")
    _same(got, want, act)
    pk = p["packed"]
    x_q = ref.quantize_int8(_t(x), pk.input_scale, pk.zero_point)
    _same(ops.conv2d(x_q, pk, stride=stride, padding=padding,
                     activation=act), want, act)


def test_params_from_jax_carries_a_calibrated_tree():
    _, jp, p = _calibrated(3, 2)
    tree = jax.tree.map(np.asarray, {"conv0": jp, "head": {
        "w": jnp.ones((16, 3)), "b": jnp.zeros((3,))}})
    got = params_from_jax(tree)
    pk, want = got["conv0"]["packed"], p["packed"]
    assert isinstance(pk, ops.QuantizedConv2dWeights)
    assert (pk.groups, pk.cout, pk.zp) == (want.groups, want.cout, want.zp)
    for name, t in want.tensors().items():
        assert getattr(pk, name).dtype == t.dtype, name
        assert torch.equal(getattr(pk, name), t), name
    assert (pk.w.dtype, pk.zero_point.dtype) == (torch.int8, torch.int32)
    assert got["head"]["w"].dtype == torch.float32
    # integer leaves keep their dtype; float ones become float32, as before
    ints = params_from_jax({"a": np.arange(3, dtype=np.int32),
                            "b": np.ones(2, np.float64)})
    assert (ints["a"].dtype, ints["b"].dtype) == (torch.int32,
                                                  torch.float32)
    # an f32 packed entry carries over as the port's packed f32 entry
    # (logical weights; tests/test_torch_autotune.py holds its forward)
    f32 = jax.tree.map(np.asarray, jops.pack_conv2d_weights(
        jnp.ones((3, 3, 4, 8))))
    pf = params_from_jax({"packed": f32})["packed"]
    assert isinstance(pf, ops.PackedConv2dWeights)
    assert torch.equal(pf.w, torch.ones((3, 3, 4, 8)))


# ---------------------------------------------------------------------------
# VGG-16/16 calibrated in both packages, and served
# ---------------------------------------------------------------------------

CALIB_IMAGES, IMAGE = 4, 32


@pytest.fixture(scope="module")
def vgg_q8():
    """VGG-16 at 1/16 width, JAX-initialised (seed 0), calibrated layer
    by layer on its f32 layer inputs over seeded images: each package's
    ``calibrate_conv2d`` on the same numpy inputs (from the JAX f32
    forward; the port's f32 inputs differ from them by f32 sum order)."""
    jtopo = jnetplan.scale_layers(jnetplan.network_layers("vgg16"), 16)
    topo = scale_layers(network_layers("vgg16"), 16)
    params = jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo, n_classes=10),
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    calib = rng.standard_normal((CALIB_IMAGES, IMAGE, IMAGE, 3)).astype(
        np.float32)
    pools = list(infer_pools(topo))
    jtree, tree, h = {"head": params["head"]}, {"head": params["head"]}, \
        jnp.asarray(calib)
    for i, l in enumerate(jtopo):
        lp = {"w": params[f"conv{i}"]["w"], "b": params[f"conv{i}"]["b"]}
        padding = layer_kernel_problem(topo[i])[3]
        jtree[f"conv{i}"] = jlayers.calibrate_conv2d(
            jax.tree.map(jnp.asarray, lp), h, groups=l.groups,
            stride=l.stride, padding=padding)
        tree[f"conv{i}"] = layers.calibrate_conv2d(
            {k: _t(v) for k, v in lp.items()}, _t(np.asarray(h)),
            groups=l.groups)
        h = jlayers._cnn_apply_layer_range(
            jax.tree.map(jnp.asarray, params), jtopo, pools, h, i, i + 1,
            activation="relu", impl="pallas", mesh=None, rules=None)
    x = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    return dict(topo=topo, jtopo=jtopo, params=params, jtree=jtree,
                tree=tree, x=x)


def test_vgg16_calibrated_in_both_packages_matches(vgg_q8):
    v = vgg_q8
    jconv = {k: p for k, p in v["jtree"].items() if k != "head"}
    conv = {k: p for k, p in v["tree"].items() if k != "head"}
    want_feat = np.asarray(jlayers.cnn_apply_from_layers(
        jconv, v["jtopo"], jnp.asarray(v["x"])))
    want = np.asarray(jlayers.cnn_apply_from_layers(
        {**jconv, "head": jax.tree.map(jnp.asarray, v["params"]["head"])},
        v["jtopo"], jnp.asarray(v["x"])))
    assert guard.events() == [], "JAX side demoted from its int8 kernel"
    model = layers.TrimCNN(v["topo"], params_from_jax(v["tree"]))
    assert model.params["conv0"].w.dtype == torch.int8
    assert not list(model.params["conv0"].parameters())
    with torch.no_grad():
        feat = layers.cnn_apply_from_layers(conv, v["topo"], _t(v["x"]))
        got = model(_t(v["x"]))
    assert np.array_equal(feat.numpy(), want_feat)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err
    # the JAX tree, carried over, serves the same function
    jmodel = layers.TrimCNN(v["topo"], params_from_jax(v["jtree"]))
    with torch.no_grad():
        assert torch.equal(jmodel(_t(v["x"])), got)
        # the impl="ref" chain (conv2d_quantized per layer) bitwise
        oracle = layers.TrimCNN(v["topo"], model.tree(), impl="ref")
        assert torch.equal(oracle(_t(v["x"])), got)


def test_vgg16_calibrated_serving_bit_matches_forward_one(vgg_q8):
    v = vgg_q8
    engine = ServingEngine.for_topology(v["topo"], v["jtree"],
                                        buckets=(1, 2, 4), device="cpu")
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((6, IMAGE, IMAGE, 3)).astype(np.float32)
    trace = [(t, i, xs[i]) for i, t in
             enumerate(poisson_arrivals(500.0, len(xs), seed=0))]
    tc.reset_launch_counts()
    results, rejected = replay(engine, trace, service_model=lambda b: 1e-3)
    assert not rejected and len(results) == len(xs)
    assert sum(tc.LAUNCHES.values()) == 0      # the CPU runs plain versions
    assert len(engine.stats()["bucket_batches"]) > 1
    for i in range(len(xs)):
        assert results[i].shape == (10,)
        assert np.array_equal(results[i], engine.forward_one(xs[i]))


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_q8_refuses_mixed_dtypes():
    x8 = torch.zeros((1, 8, 8, 8), dtype=torch.int8)
    w8 = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(TypeError, match="int8 route"):
        tc.trim_conv2d_q8(x8.float(), w8, None, s)
    with pytest.raises(TypeError, match="integer weights"):
        tc.trim_conv2d_q8(x8, w8.float(), None, s)
    with pytest.raises(TypeError, match="requantized int32 bias"):
        tc.trim_conv2d_q8(x8, w8, torch.zeros(8), s)
    with pytest.raises(TypeError, match="dequant scale"):
        tc.trim_conv2d_q8(x8, w8, None, None)
    with pytest.raises(TypeError, match="int8 kernel"):
        tc.trim_conv2d_q8(x8.int(), w8, None, s)
    with pytest.raises(TypeError, match="trim_conv2d_q8"):
        tc.trim_conv2d(x8, w8)
    with pytest.raises(ValueError, match="zero_point"):
        tc.trim_conv2d_q8(x8, w8, None, s, zero_point=200)
    with pytest.raises(ValueError, match="share"):
        tc.trim_conv2d_q8(x8, w8.to("meta"), None, s)
    with pytest.raises(ValueError, match="pack_q8_weights"):
        tc.trim_conv2d_q8(x8, w8, None, s, w_packed=w8)
    with pytest.raises(ValueError, match="bias"):
        ops.conv2d(x8.float(), _calibrated()[2]["packed"],
                   bias=torch.zeros(16))


def test_q8_refuses_fused_trainable_and_grad(vgg_q8):
    v = vgg_q8
    tree = v["tree"]
    with pytest.raises(ValueError, match="fused"):
        layers.TrimCNN(v["topo"], tree, fused=True)
    with pytest.raises(ValueError, match="trainable"):
        layers.TrimCNN(v["topo"], tree, trainable=True)
    with pytest.raises(ValueError, match="raw conv params"):
        layers.cnn_apply_from_layers(tree, v["topo"], _t(v["x"]), fused=True)
    with pytest.raises(ValueError, match="fused"):
        ServingEngine.for_topology(v["topo"], tree, buckets=(1,),
                                   device="cpu", fused=True)
    x = _t(v["x"]).requires_grad_()
    with pytest.raises(NotImplementedError, match="inference only"):
        layers.conv2d_apply(tree["conv0"], x)
    pk = tree["conv0"]["packed"]
    scale, bias_q = ref.dequant_params(pk.w, pk.scale, pk.input_scale,
                                       pk.zero_point, pk.bias)
    x_q = ref.quantize_int8(_t(v["x"]), pk.input_scale, pk.zero_point)
    with pytest.raises(NotImplementedError, match="inference only"):
        tc.trim_conv2d_q8(x_q, pk.w, bias_q, scale.requires_grad_(), pad=1)
    with torch.no_grad():
        assert layers.conv2d_apply(tree["conv0"], x).grad_fn is None
