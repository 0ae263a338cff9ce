"""The bf16 routes of the port's conv kernels against the JAX package on
the CPU.

Every Pallas kernel takes bf16 operands, sums in f32 and stores in the
input's dtype; the port's carry, halo and fused wrappers do the same on
bf16 tensors (their plain versions here, on CPU tensors).  The same numpy
inputs, rounded to bf16 once, go through both packages.

* ``ops.conv2d`` on bf16 against JAX ``ops.conv2d(impl="pallas")`` (the
  carry kernel in interpret mode, ``guard.events()`` empty) over
  ``tests/test_torch_conv2d.py``'s grid of kernel sizes, strides, groups,
  paddings and activations; halo against JAX ``ref`` (the JAX halo and
  fused kernels do not run on this JAX version).  Tolerance: ``max|a - b|
  / max|ref| < 3e-2`` (DESIGN.md §5, ``tests/test_kernels.py``).
* The plain bf16 conv against a float64 oracle rounded to bf16: within
  one bf16 ulp where the f32 sum cannot cancel (non-negative operands),
  and within one ulp plus the f32 sum's own error bound (``n u32 sum|x
  w|``) on signed operands, where an f32 sum that cancels cannot stay
  within one ulp of a small exact result.  The plain version is the
  kernel's own fmaf chain (``fmaf_taps``), bit for bit per element.
* The K = 11 / stride 4 adder tree at a narrow AlexNet-conv1 geometry:
  bitwise the sum of its bf16 parts in bf16, in the decomposition's
  order, then the bf16 epilogue; within 3e-2 of JAX's tree.
* The plain fused group bitwise equal to the port's bf16 per-layer chain,
  and within 3e-2 of JAX's bf16 chain.
* VGG-16 at 1/16 width in bf16 through ``ServingEngine.for_topology`` on
  the CPU, per layer and fused: served rows bit-match ``forward_one``,
  logits within 3e-2 of JAX ``cnn_apply_from_layers`` on the same bf16
  params.
* ``params_from_jax`` carries a JAX bf16 tree bit for bit; mixed float
  dtypes raise; bf16 autotune keys and plans are their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guard
from repro.core import netplan as jnetplan
from repro.core.fuse_plan import build_group as jbuild_group
from repro.core.model import ConvLayer as JConvLayer
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.trim_conv2d_fused import reference_chain as jreference
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro_torch.convert import params_from_jax
from repro_torch.core import autotune
from repro_torch.core.conv_plan import SMEM_PER_BLOCK, ConvPlan
from repro_torch.core.fuse_plan import (BF16FusedGroup, FusedGroup,
                                        FusedGroupPlan, build_group)
from repro_torch.core.model import ConvLayer
from repro_torch.core.netplan import network_layers, scale_layers
from repro_torch.core.serving import ServingEngine, replay
from repro_torch.core.tiling import subkernel_decomposition
from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.kernels import trim_conv2d_fused as tf
from repro_torch.models import layers
from repro_torch.testing.load import poisson_arrivals

TOL = 3e-2
BF16 = torch.bfloat16
CIN = COUT = 8
ACTS = [None, "relu", "gelu", "silu"]
GRID = [(k, s, g, pad, ACTS[i % 4]) for i, (k, s, g, pad) in enumerate(
    [(k, s, g, pad) for k in (1, 3, 5) for s in (1, 2) for g in (1, CIN)
     for pad in ("same", "valid")])]


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


def _jax(t: torch.Tensor):
    """The same bf16 values as a JAX bf16 array (exact)."""
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err / max(float(np.abs(want).max()), 1e-6) < tol, err


def _inputs(k, groups, seed, hw=(11, 12), cin=CIN, cout=COUT):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, cin))
    w = rng.standard_normal((k, k, cin // groups, cout)) \
        / np.sqrt(k * k * cin // groups)
    b = rng.standard_normal(cout)
    return _bf16(x), _bf16(w), _bf16(b)


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude (of the normal range)."""
    m = t.double().abs().clamp_min(2.0 ** -126)
    return torch.pow(2.0, torch.floor(torch.log2(m)) - 7)


# ---------------------------------------------------------------------------
# the conv against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,groups,padding,act", GRID)
def test_conv2d_bf16_matches_jax_carry_kernel(k, stride, groups, padding,
                                              act):
    x, w, b = _inputs(k, groups, seed=k * 10 + stride + groups)
    want = jops.conv2d(_jax(x), _jax(w), stride=stride, padding=padding,
                       feature_group_count=groups, bias=_jax(b),
                       activation=act, dataflow="carry",
                       use_autotune_cache=False)
    assert guard.events() == [], "JAX side fell back from the Pallas kernel"
    assert want.dtype == jnp.bfloat16
    got = ops.conv2d(x, w, stride=stride, padding=padding,
                     feature_group_count=groups, bias=b, activation=act,
                     dataflow="carry")
    assert got.dtype == BF16
    _close(got, want)


@pytest.mark.parametrize("k,stride,groups", [(3, 1, 1), (3, 2, 1),
                                              (5, 2, CIN), (3, 1, 2)])
def test_halo_bf16_matches_jax_ref_and_carry(k, stride, groups):
    x, w, b = _inputs(k, groups, seed=7 + k + stride + groups)
    want = jref.conv2d(_jax(x), _jax(w), stride=stride, padding="same",
                       feature_group_count=groups, bias=_jax(b),
                       activation="relu")
    kw = dict(stride=stride, feature_group_count=groups, bias=b,
              activation="relu")
    halo = ops.conv2d(x, w, dataflow="halo", **kw)
    _close(halo, want)
    assert torch.equal(halo, ops.conv2d(x, w, dataflow="carry", **kw))
    # impl="ref": the conv and epilogue in f32 on the widened operands,
    # one cast
    _close(ops.conv2d(x, w, impl="ref", **kw), want)


# geometries of the plain version's rounding checks: K, stride, groups,
# Cin, Cout, padding
ROUNDING = [(3, 1, 1, 8, 8, "same"), (3, 2, 1, 64, 16, "same"),
            (5, 1, 4, 16, 12, "valid"), (1, 1, 1, 256, 8, "valid"),
            (3, 1, 16, 16, 16, "same"), (3, 1, 1, 3, 8, "same")]


@pytest.mark.parametrize("case", ROUNDING, ids=[str(i) for i in
                                                range(len(ROUNDING))])
def test_plain_bf16_rounds_once_from_the_exact_sum(case):
    """Non-negative operands (and a non-negative bias): no f32 partial sum
    cancels, its relative error stays below 2^-24 n (n the taps), far
    under half a bf16 ulp, so the one rounding at the store leaves the
    result within one ulp of the float64 sum rounded to bf16."""
    k, s, g, cin, cout, padding = case
    rng = np.random.default_rng(sum(case[:5]))
    x = _bf16(np.abs(rng.standard_normal((2, 9, 10, cin))))
    w = _bf16(np.abs(rng.standard_normal((k, k, cin // g, cout))))
    b = _bf16(np.abs(rng.standard_normal(cout)))
    kw = dict(stride=s, padding=padding, feature_group_count=g)
    got = ops.conv2d(x, w, bias=b, **kw)
    exact = ref.conv2d(x.double(), w.double(), bias=b.double(), **kw)
    want = exact.to(BF16)
    assert ((got.double() - want.double()).abs() <= _ulp(want)).all()


@pytest.mark.parametrize("case", ROUNDING, ids=[str(i) for i in
                                                range(len(ROUNDING))])
def test_plain_bf16_signed_within_an_ulp_and_the_f32_sum_bound(case):
    """Signed operands: within one bf16 ulp of the float64 oracle rounded
    to bf16, plus the f32 chain's error bound ``n 2^-24 sum|x w|`` (the
    sum JAX specifies cannot be closer to a result that cancels)."""
    k, s, g, cin, cout, padding = case
    x, w, b = _inputs(k, g, seed=sum(case[:5]), hw=(9, 10), cin=cin,
                      cout=cout)
    kw = dict(stride=s, padding=padding, feature_group_count=g)
    got = ops.conv2d(x, w, bias=b, activation="relu", **kw)
    want = ref.conv2d(x.double(), w.double(), bias=b.double(),
                      activation="relu", **kw).to(BF16)
    mass = ref.conv2d(x.double().abs(), w.double().abs(), **kw)
    bound = _ulp(want) + k * k * cin // g * 2.0 ** -24 * mass
    assert ((got.double() - want.double()).abs() <= bound).all()


def test_plain_bf16_is_the_kernels_fmaf_chain():
    """Each output is one f32 multiply-add an input channel in (ki, kj,
    ci) order from 0, then + bias and the activation in f32, rounded
    once: an explicit scalar loop over one output gives the same bits."""
    x, w, b = _inputs(3, 1, seed=21, hw=(5, 6))
    got = tc.trim_conv2d(x, w, b, pad=1, activation="relu")
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    for (n, oh, ow, co) in [(0, 0, 0, 0), (1, 4, 5, 7), (0, 2, 3, 3)]:
        acc = torch.zeros((), dtype=torch.float32)
        for ki in range(3):
            for kj in range(3):
                for ci in range(CIN):
                    acc = acc + xp[n, oh + ki, ow + kj, ci] \
                        * w[ki, kj, ci, co].float()
        want = torch.relu(acc + b[co].float()).to(BF16)
        assert torch.equal(got[n, oh, ow, co], want)


def test_large_k_adder_tree_sums_bf16_parts_as_jax():
    """AlexNet conv1's geometry (11 x 11, stride 4, 'valid') at 8 output
    channels: the 16 sub-kernel parts are bf16, summed in bf16 out of
    place in the decomposition's order, then the bf16 epilogue."""
    rng = np.random.default_rng(11)
    x = _bf16(rng.standard_normal((1, 47, 51, 3)))
    w = _bf16(rng.standard_normal((11, 11, 3, 8)) / np.sqrt(363))
    b = _bf16(rng.standard_normal(8))
    got = ops.conv2d(x, w, stride=4, padding="valid", bias=b,
                     activation="relu")
    h_out, w_out = (47 - 11) // 4 + 1, (51 - 11) // 4 + 1
    out = None
    for r0, c0, kh, kw in subkernel_decomposition(11, native_k=3):
        part = tc.trim_conv2d_plain(
            x[:, r0:r0 + (h_out - 1) * 4 + kh,
              c0:c0 + (w_out - 1) * 4 + kw].contiguous(),
            w[r0:r0 + kh, c0:c0 + kw].contiguous(), stride=4)
        assert part.dtype == BF16
        out = part if out is None else out + part
    assert torch.equal(got, ref.epilogue(out, b, "relu"))
    want = jops.conv2d(_jax(x), _jax(w), stride=4, padding="valid",
                       bias=_jax(b), activation="relu", impl="pallas",
                       use_autotune_cache=False)
    assert guard.events() == []
    _close(got, want)


# ---------------------------------------------------------------------------
# fused groups
# ---------------------------------------------------------------------------

CHAIN = [("c0", 12, 3, 8, 3, 1, 1), ("c1", 12, 8, 8, 3, 1, 1),
         ("c2", 6, 8, 16, 3, 1, 1)]


@pytest.fixture(scope="module")
def chain():
    topo = [ConvLayer(*a) for a in CHAIN]
    jtopo = [JConvLayer(*a) for a in CHAIN]
    params = jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo), jax.random.PRNGKey(3)))
    ws = [_bf16(params[f"conv{i}"]["w"]) for i in range(3)]
    bs = [_bf16(params[f"conv{i}"]["b"])
          + _bf16(np.linspace(-0.3, 0.3, CHAIN[i][3])) for i in range(3)]
    x = _bf16(np.random.default_rng(3).standard_normal((2, 12, 12, 3)))
    want = jreference(_jax(x), [_jax(w) for w in ws],
                      [_jax(b) for b in bs],
                      group=jbuild_group(jtopo, 0, n=2))
    assert guard.events() == []
    return topo, x, ws, bs, want


@pytest.mark.parametrize("strip_rows,band_cols", [(1, 1), (2, 3), (3, None)])
def test_fused_bf16_equals_the_chain_bitwise_and_matches_jax(
        chain, strip_rows, band_cols):
    topo, x, ws, bs, want = chain
    g = build_group(topo, 0, n=2, strip_rows=strip_rows,
                    band_cols=band_cols, dtype_bytes=2)
    assert isinstance(g, BF16FusedGroup) and g.dtype_bytes == 2
    got = tf.fused_group_apply(x, ws, bs, group=g)
    assert got.dtype == BF16
    assert torch.equal(got, tf.reference_chain(x, ws, bs, group=g))
    _close(got, want)


def test_bf16_fused_plan_halves_the_bytes():
    """The same geometry in elements, two bytes each, on the fmaf chain:
    f32 plans do not move, a bf16 tile fits where the f32 one does not; a
    stage on the bf16 tensor cores takes a pitch of its own."""
    topo = network_layers("vgg16")
    f32, bf16 = (FusedGroupPlan.build(topo, n=1, dtype_bytes=d)
                 for d in (4, 2))
    assert f32 == FusedGroupPlan.build(topo, n=1)
    assert all(type(g) is FusedGroup for g in f32.groups)
    assert all(type(g) is BF16FusedGroup for g in bf16.groups)
    assert len(bf16.fused_groups) > len(f32.fused_groups)
    assert all(g.smem_bytes <= SMEM_PER_BLOCK for g in bf16.groups)
    # VGG-16/16's conv1..conv2 (Cin 3, 4): both stages on the fmaf chain
    g4, g2 = (build_group(scale_layers(topo, 16)[:2], 0, n=8, strip_rows=8,
                          band_cols=16, dtype_bytes=d) for d in (4, 2))
    assert dataclasses.asdict(g4) == dataclasses.asdict(g2)
    assert 2 * g2.smem_bytes == g4.smem_bytes
    assert 2 * g2.hbm_bytes()["total"] == g4.hbm_bytes()["total"]
    assert 2 * g2.min_bytes() == g4.min_bytes()
    # full-width conv2 (Cin 64) runs on the bf16 tensor cores: a pitch of
    # Cin + 8, an odd count of 16-byte quads, in the same geometry
    g4, g2 = (build_group(topo[:2], 0, n=8, strip_rows=8, band_cols=16,
                          dtype_bytes=d) for d in (4, 2))
    assert dataclasses.asdict(g4) == dataclasses.asdict(g2)
    assert [lay.route for lay in g2.layouts] == ["ffma", "mma"]
    assert g2.layouts[1].pitch == 72 and g2.smem_bytes < g4.smem_bytes
    assert 2 * g2.min_bytes() == g4.min_bytes()
    with pytest.raises(ValueError, match="dtype_bytes"):
        build_group(topo[:2], 0, dtype_bytes=1)


def test_bf16_conv_plan():
    """The bf16 instance's plan: a pitch of Cin/g + 8 (16-byte copies of
    8 channels), 2-byte windows, bf16 bytes; f32 unchanged."""
    xs, ws = (8, 56, 56, 256), (3, 3, 256, 256)
    f32 = ConvPlan.build(xs, ws, pad=1)
    bf16 = ConvPlan.build(xs, ws, pad=1, dtype_bytes=2)
    assert (f32.route, bf16.route) == ("f32", "bf16")
    assert (f32.cin_stride, bf16.cin_stride) == (260, 264)
    assert bf16.smem_bytes <= SMEM_PER_BLOCK
    assert 2 * bf16.min_bytes() == f32.min_bytes()
    assert ConvPlan.build((1, 32, 32, 3), (3, 3, 3, 64), pad=1,
                          dtype_bytes=2).cin_stride == 3


# ---------------------------------------------------------------------------
# networks, serving, conversion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_bf16():
    """VGG-16 at 1/16 width, JAX-initialised (seed 0) and cast to bf16
    once; both packages' forwards of two seeded 224 x 224 images."""
    jtopo = jnetplan.scale_layers(jnetplan.network_layers("vgg16"), 16)
    topo = scale_layers(network_layers("vgg16"), 16)
    params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                          jinit(jlayers.cnn_params_from_layers(
                              jtopo, n_classes=10), jax.random.PRNGKey(0)))
    xs = np.random.default_rng(1).standard_normal((5, 224, 224, 3)).astype(
        np.float32)
    xb = _bf16(xs)
    want = jlayers.cnn_apply_from_layers(
        jax.tree.map(jnp.asarray, params), jtopo, _jax(xb[:2]), impl="ref")
    assert want.dtype == jnp.bfloat16
    return dict(topo=topo, params=params, xs=xb.float().numpy(),
                want=_np(want))


@pytest.mark.parametrize("fused", [False, True])
def test_vgg16_bf16_served_bit_matches_forward_one_and_jax(vgg_bf16,
                                                           fused):
    v = vgg_bf16
    engine = ServingEngine.for_topology(v["topo"], v["params"],
                                        buckets=(1, 2, 4), device="cpu",
                                        fused=fused)
    assert engine.tune_kwargs["dtype"] == "bfloat16"
    xs = v["xs"]
    trace = [(t, i, xs[i]) for i, t in
             enumerate(poisson_arrivals(500.0, len(xs), seed=0))]
    results, rejected = replay(engine, trace)
    assert not rejected and sorted(results) == list(range(len(xs)))
    for i in range(len(xs)):
        assert results[i].dtype == np.float32 and results[i].shape == (10,)
        assert np.array_equal(results[i], engine.forward_one(xs[i]))
    _close(np.stack([results[0], results[1]]), v["want"])


def test_vgg16_bf16_fused_equals_per_layer_bitwise(vgg_bf16):
    v = vgg_bf16
    tree = params_from_jax(v["params"])
    x = torch.from_numpy(v["xs"][:1]).to(BF16)
    plan = FusedGroupPlan.build(v["topo"], n=1, dtype_bytes=2)
    assert plan.fused_groups
    with torch.no_grad():
        per_layer = layers.cnn_apply_from_layers(tree, v["topo"], x)
        fused = layers.cnn_apply_from_layers(tree, v["topo"], x, fused=True)
    assert per_layer.dtype == BF16
    assert torch.equal(per_layer, fused)


def test_trim_cnn_random_bf16_is_one_cast_of_the_f32_draws():
    topo = scale_layers(network_layers("vgg16"), 16)[:3]
    f32 = layers.TrimCNN.random(topo, n_classes=4, seed=5, device="cpu")
    bf16 = layers.TrimCNN.random(topo, n_classes=4, seed=5, device="cpu",
                                 dtype=BF16)
    assert bf16.dtype == BF16 and f32.dtype == torch.float32
    for (k, a), (_, b) in zip(f32.named_parameters(),
                              bf16.named_parameters()):
        assert torch.equal(a.to(BF16), b), k


def test_params_from_jax_carries_bf16_bit_for_bit():
    jtopo = jnetplan.scale_layers(jnetplan.network_layers("alexnet"), 16)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jinit(
        jlayers.cnn_params_from_layers(jtopo, n_classes=10),
        jax.random.PRNGKey(2)))
    numpy_tree = jax.tree.map(np.asarray, params)
    tree = params_from_jax(numpy_tree)
    for name, entry in tree.items():
        for leaf, t in entry.items():
            a = numpy_tree[name][leaf]
            assert a.dtype.name == "bfloat16"
            assert t.dtype == BF16 and t.shape == a.shape
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), (name, leaf)
    # tensors keep bf16 too, and f32 stays f32
    assert params_from_jax({"w": torch.ones(2, dtype=BF16)})["w"].dtype \
        == BF16
    assert params_from_jax({"w": np.ones(2)})["w"].dtype == torch.float32


def test_mixed_float_dtypes_raise():
    x, w, b = _inputs(3, 1, seed=1)
    with pytest.raises(TypeError, match="mixed"):
        tc.trim_conv2d(x, w.float(), b)
    with pytest.raises(TypeError, match="mixed"):
        tc.trim_conv2d(x.float(), w, None)
    with pytest.raises(TypeError, match="mixed"):
        ops.conv2d(x, w, bias=b.float())
    with pytest.raises(TypeError):
        tc.trim_conv2d(x.half(), w.half())
    g = build_group([ConvLayer(*a) for a in CHAIN[:2]], 0, n=2,
                    strip_rows=2, dtype_bytes=2)
    ws = [torch.zeros((3, 3, 3, 8), dtype=BF16),
          torch.zeros((3, 3, 8, 8))]
    with pytest.raises(TypeError, match="mixed"):
        tf.trim_conv2d_fused(torch.zeros((2, 12, 12, 3), dtype=BF16), ws,
                             [None, None], group=g)
    # the cotangent kernels take one float dtype (bf16 since the bf16
    # weight-gradient route: tests/test_torch_bf16_train.py); the int8
    # calibration takes f32 only
    with pytest.raises(TypeError, match="mixed"):
        tc.trim_conv2d_weight_grad(x, x.float(), kernel_size=3, pad=1)
    with pytest.raises(TypeError, match="mixed"):
        tc.trim_conv2d_input_grad(x, w.float(), x_shape=tuple(x.shape),
                                  pad=1)
    with pytest.raises(TypeError, match="mixed"):
        ops.conv2d(x, w.float().requires_grad_())
    with pytest.raises(TypeError, match="f32"):
        layers.calibrate_conv2d({"w": w, "b": b}, x)


def test_bf16_autotune_keys_and_records_are_their_own(monkeypatch):
    xs, ws, pads = (2, 12, 12, 16), (3, 3, 16, 32), ((1, 1), (1, 1))
    kw = dict(pad=pads, device="cpu")
    k32 = autotune.make_key(xs, ws, **kw)
    k16 = autotune.make_key(xs, ws, dtype="bfloat16", **kw)
    assert k32 != k16 and ":bfloat16:" in k16 and ":float32:" in k32
    assert autotune.dtype_name(BF16) == "bfloat16"
    assert autotune.fused_key("sig", dtype="bfloat16", device="cpu") \
        != autotune.fused_key("sig", device="cpu")
    rec = autotune.tune(xs, ws, dtype="bfloat16", **kw)
    assert autotune.knobs_for(xs, ws, dtype="bfloat16", **kw)["tile_cout"] \
        == rec["tile_cout"]
    assert autotune.knobs_for(xs, ws, **kw) is None   # no f32 record
    # ops.conv2d on bf16 looks the bf16 record up, never an f32 one
    seen = []
    real = autotune.knobs_for

    def spy(*a, **k):
        seen.append(k.get("dtype"))
        return real(*a, **k)
    monkeypatch.setattr(autotune, "knobs_for", spy)
    ops.conv2d(torch.zeros(xs, dtype=BF16), torch.zeros(ws, dtype=BF16))
    ops.pack_conv2d_weights(torch.zeros(ws, dtype=BF16),
                            x_shape=(2, 12, 12, 16))
    assert seen == ["bfloat16", "bfloat16"]
    monkeypatch.setattr(autotune, "knobs_for", real)
    pk = ops.pack_conv2d_weights(torch.zeros(ws, dtype=BF16),
                                 torch.zeros(32, dtype=BF16))
    assert pk.w.dtype == pk.bias.dtype == BF16
    # the fused records: tuned and looked up at bfloat16
    topo = scale_layers(network_layers("vgg16"), 16)
    recs = autotune.tune_fused_network(topo, n=1, dtype="bfloat16",
                                       device="cpu")
    assert recs and all(":bfloat16:" in r["key"] for r in recs.values())
    plan = FusedGroupPlan.build(topo, n=1, dtype_bytes=2,
                                use_autotune_cache=True, device="cpu")
    assert plan == FusedGroupPlan.build(topo, n=1, dtype_bytes=2)
