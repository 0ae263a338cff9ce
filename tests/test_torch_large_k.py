"""K > 8 in the port against the JAX package on the CPU: the paper's
kernel tiling (``core/tiling.py``), rectangular ``ConvPlan`` /
``WeightGradPlan``, the rectangular plain kernel, the adder-tree path of
``ops.conv2d`` and its gradients, and the int8 route's refusal.

The same numpy inputs (from a seed) go through both packages.  The JAX
side runs its Pallas carry kernel in interpret mode (``guard.events()``
stays empty, so it did not fall back to ``ref``); its Pallas backward
does not run on this JAX version (``pl.unblocked`` is gone), so the
gradients are held against ``jax.grad`` of JAX ``impl="ref"``.
Tolerance: 1e-4 * max(1, max|jax|) (the adder tree sums up to 36 parts,
each an f32 sum taken in another order), 1e-5 for one rectangular kernel.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guard
from repro.core import model as jmodel
from repro.core import tiling as jtiling
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.trim_conv2d import trim_conv2d as jtrim
from repro.models import layers as jlayers
from repro_torch.core import model, tiling
from repro_torch.core.conv_plan import (SMEM_PER_BLOCK, ConvPlan,
                                        WeightGradPlan)
from repro_torch.kernels import ops
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.models import layers

TOL = 1e-4
ACTS = [None, "relu", "gelu", "silu"]
CIN = COUT = 4


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
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("k", range(1, 17))
def test_subkernel_decomposition_matches_jax(k):
    assert tiling.subkernel_decomposition(k) == \
        jtiling.subkernel_decomposition(k)
    assert tiling.subkernel_decomposition(k, native_k=4) == \
        jtiling.subkernel_decomposition(k, native_k=4)
    assert model.num_subkernels(k) == jmodel.num_subkernels(k) \
        == len(tiling.subkernel_decomposition(k))


@pytest.mark.parametrize("k,stride", list(itertools.product(
    range(9, 17), (1, 2, 3, 4, 14))))
def test_rectangular_plans_build_for_every_subkernel(k, stride):
    """Each sub-kernel of K x K on its 'valid' slice (3 output rows, 4
    columns): the forward plans (carry, halo) and the weight-gradient plan
    have the sub-kernel's extents, output and window."""
    h_out, w_out = 3, 4
    for r0, c0, kh, kw in tiling.subkernel_decomposition(k):
        xs = (2, (h_out - 1) * stride + kh, (w_out - 1) * stride + kw, 3)
        ws = (kh, kw, 3, 8)
        for df in ("carry", "halo"):
            p = ConvPlan.build(xs, ws, stride=stride, dataflow=df)
            assert (p.kh, p.kw) == (kh, kw)
            assert p.out_shape == (2, h_out, w_out, 8)
            assert p.carry_rows == max(kh - stride, 0)
            assert p.window_cols == (p.tile_w - 1) * stride + kw
            assert p.smem_bytes <= SMEM_PER_BLOCK
            assert p.flops == 2 * 2 * h_out * w_out * 8 * kh * kw * 3
        g = WeightGradPlan.build(xs, ws, stride=stride)
        assert g.dw_shape == ws and g.rows == kh * kw * 3
        assert (g.h_out, g.w_out) == (h_out, w_out)


def test_int8_plan_stays_square():
    with pytest.raises(ValueError, match="square"):
        ConvPlan.build((1, 9, 9, 16), (3, 2, 16, 16), dtype_bytes=1)


# (kh, kw, stride, groups, pad)
RECT = [(3, 2, 4, 1, 0), (2, 3, 1, 1, 0), (2, 2, 2, 1, 1), (3, 1, 1, 4, 1),
        (1, 3, 2, 2, 0), (3, 2, 1, 1, 2)]


@pytest.mark.parametrize("case", RECT, ids=[str(c[:3]) for c in RECT])
def test_rectangular_plain_kernel_matches_jax_carry_kernel(case):
    kh, kw, s, g, pad = case
    rng = np.random.default_rng(kh * 10 + kw + s)
    x = rng.standard_normal((2, 13, 12, CIN)).astype(np.float32)
    w = rng.standard_normal((kh, kw, CIN // g, COUT)).astype(np.float32)
    b = rng.standard_normal(COUT).astype(np.float32)
    want = jtrim(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=s,
                 pad=pad, groups=g, activation="relu")
    assert guard.events() == []
    got = tc.trim_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), stride=s, pad=pad, groups=g,
                         activation="relu")
    _close(got, want, 1e-5)
    # the weight gradient's plain version on the same rectangular taps:
    # against autograd of the plain forward
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tc.trim_conv2d_plain(xt, wt, stride=s, pad=pad, groups=g)
    gy = torch.from_numpy(rng.standard_normal(tuple(y.shape), np.float32))
    dw_auto = torch.autograd.grad(y, wt, gy)[0]
    dw = tc.trim_conv2d_weight_grad(torch.from_numpy(x), gy,
                                    kernel_size=(kh, kw), stride=s, pad=pad,
                                    groups=g)
    _close(dw, dw_auto.numpy(), 1e-5)


# K x stride x padding x groups (1 or depthwise); the activation cycles
GRID = [(k, s, pad, g, ACTS[i % 4]) for i, (k, s, pad, g) in enumerate(
    itertools.product((9, 11, 14, 16), (1, 2, 4, 14), ("same", "valid"),
                      (1, CIN)))]


def _inputs(k, s, g, seed):
    rng = np.random.default_rng(seed)
    hw = (k + 2 * s, k + s + 1)         # at least one output when 'valid'
    x = rng.standard_normal((2, *hw, CIN)).astype(np.float32)
    w = (rng.standard_normal((k, k, CIN // g, COUT))
         / np.sqrt(k * k * CIN // g)).astype(np.float32)
    b = rng.standard_normal(COUT).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("k,stride,padding,groups,act", GRID,
                         ids=[f"k{c[0]}s{c[1]}{c[2][0]}g{c[3]}"
                              for c in GRID])
def test_large_k_conv2d_matches_jax_pallas(k, stride, padding, groups, act):
    x, w, b = _inputs(k, stride, groups, seed=k * 100 + stride + groups)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                       padding=padding, feature_group_count=groups,
                       bias=jnp.asarray(b), activation=act, impl="pallas",
                       use_autotune_cache=False)
    want = np.asarray(want)
    assert guard.events() == [], "JAX side fell back from the Pallas kernel"
    before = dict(tc.LAUNCHES)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=stride, padding=padding,
                     feature_group_count=groups, bias=torch.from_numpy(b),
                     activation=act)
    assert tc.LAUNCHES == before      # plain versions on the CPU
    assert ops.conv_launches(k) == model.num_subkernels(k)
    _close(got, want)


def test_large_k_halo_and_tiles_match_carry():
    """Explicit dataflow and tiles reach every sub-kernel; the result is
    the same function (bitwise on the CPU, where both run the plain
    version)."""
    x, w, b = _inputs(11, 4, 1, seed=5)
    args = (torch.from_numpy(x), torch.from_numpy(w))
    kw = dict(stride=4, padding="valid", bias=torch.from_numpy(b),
              activation="relu")
    carry = ops.conv2d(*args, **kw)
    assert torch.equal(carry, ops.conv2d(*args, dataflow="halo", **kw))
    assert torch.equal(carry, ops.conv2d(*args, tile_h=4, tile_cout=2,
                                         **kw))


# (x shape, w shape, stride, groups, padding): JAX's own geometry of
# test_grad_kernel_tiled_large_k, and a grouped K 9 'same' case
GRAD_CASES = [((1, 30, 30, 3), (11, 11, 3, 4), 4, 1, "valid"),
              ((2, 13, 12, 4), (9, 9, 2, 6), 2, 2, "same")]


@pytest.mark.parametrize("case", GRAD_CASES, ids=["k11_s4", "k9_g2"])
def test_large_k_gradients_match_jax_ref(case):
    xs, ws, s, g, padding = case
    rng = np.random.default_rng(ws[0])
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / ws[0]).astype(np.float32)
    b = rng.standard_normal(ws[3]).astype(np.float32)
    kw = dict(stride=s, padding=padding, feature_group_count=g,
              activation="gelu")
    out_shape = jref.conv2d(jnp.asarray(x), jnp.asarray(w), stride=s,
                            padding=padding, feature_group_count=g).shape
    gy = rng.standard_normal(out_shape).astype(np.float32)

    def jloss(x_, w_, b_):
        y = jops.conv2d(x_, w_, bias=b_, impl="ref", **kw)
        return jnp.sum(y * gy)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = ops.conv2d(leaves[0], leaves[1], bias=leaves[2], **kw)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    for a, c in zip(got, want):
        _close(a, c)


@pytest.mark.parametrize("k", [9, 11])
def test_int8_route_refuses_large_k_like_jax(k):
    rng = np.random.default_rng(k)
    w = rng.standard_normal((k, k, 3, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    with pytest.raises(ValueError, match="kernel-tiled"):
        jops.quantize_conv2d_weights(jnp.asarray(w), jnp.asarray(b),
                                     x_scale=0.05, x_zero_point=3)
    with pytest.raises(ValueError, match="kernel-tiled"):
        ops.quantize_conv2d_weights(torch.from_numpy(w),
                                    torch.from_numpy(b), x_scale=0.05,
                                    x_zero_point=3)
    # K = 8 still quantizes in both
    w8 = jnp.asarray(w[:8, :8])
    jops.quantize_conv2d_weights(w8, None, x_scale=0.05)
    ops.quantize_conv2d_weights(torch.from_numpy(w[:8, :8].copy()), None,
                                x_scale=0.05)


def test_calibrate_alexnet_conv1_refuses_like_jax():
    """AlexNet's conv1 (11 x 11): calibration raises in both packages;
    no int8 AlexNet."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((11, 11, 3, 96)).astype(np.float32)
    b = np.zeros(96, np.float32)
    xb = rng.standard_normal((2, 31, 31, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="kernel-tiled"):
        jlayers.calibrate_conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(xb), stride=4,
                                 padding="valid")
    with pytest.raises(ValueError, match="kernel-tiled"):
        layers.calibrate_conv2d({"w": torch.from_numpy(w),
                                 "b": torch.from_numpy(b)},
                                torch.from_numpy(xb))
