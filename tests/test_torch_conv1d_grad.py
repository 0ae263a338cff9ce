"""The conv1d backward (``_TrimConv1dFn``) against the JAX package on the
CPU.

The same numpy inputs go through the port's ``trim_conv1d`` under
autograd (on the CPU the kernels' plain versions: dx as the forward's
plain version on the reversed cotangent, dw as the weight-gradient
kernel's runs and groups), ``torch.autograd`` of the port's
``ref.depthwise_conv1d`` and ``jax.vjp`` of JAX ``ref.depthwise_conv1d``
(the gradient the JAX mixers take), within 1e-5 of max|grad| (f32 sums in
another order: dx sums K products, dw B x L) on the grid K in {2, 3, 4,
8, 9}, L in {1, K-1, 17, 300}, B in {1, 2}, D in {1, 5, 300}, contiguous
and as the Mamba mixer's strided half of the in-projection (whose
gradient reaches the other half as zeros).  Also: dx's plain version is
the flip formula bit for bit and dw's is bitwise repeatable;
``Conv1dWeightGradPlan``'s runs, groups, scratch and bound, and its
constants parsed from ``csrc/trim_conv1d_wgrad.cu``; the routing of
``ops.depthwise_conv1d`` under grad; no launch is counted on the CPU.
The kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import conv_plan
from repro_torch.core.conv_plan import Conv1dPlan, Conv1dWeightGradPlan
from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv1d as tc1

TOL = 1e-5
KS = [2, 3, 4, 8, 9]
CASES = sorted({(k, length) for k in KS for length in (1, k - 1, 17, 300)})
CU = Path(tc1.__file__).resolve().parent / "csrc" / "trim_conv1d_wgrad.cu"


def _inputs(b, length, d, k, seed, strided):
    rng = np.random.default_rng(seed)
    xz = rng.standard_normal((b, length, 2 * d if strided else d)) \
        .astype(np.float32)
    w = rng.standard_normal((k, d)).astype(np.float32)
    dy = rng.standard_normal((b, length, d)).astype(np.float32)
    return xz, w, dy


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), (what, err)


@jax.jit
def _jax_vjp(x, w, dy):
    """``jax.vjp`` of JAX ``ref.depthwise_conv1d`` (one compile a shape)."""
    return jax.vjp(jref.depthwise_conv1d, x, w)[1](dy)


@pytest.mark.parametrize("k,length", CASES,
                         ids=[f"k{k}-l{n}" for k, n in CASES])
def test_conv1d_gradient_matches_autograd_and_jax(k, length):
    for b in (1, 2):
        for d in (1, 5, 300):
            for strided in (False, True):
                what = (b, length, d, k, strided)
                xzn, wn, dyn = _inputs(b, length, d, k, k * length + d,
                                       strided)
                xz = torch.from_numpy(xzn).requires_grad_()
                w = torch.from_numpy(wn).requires_grad_()
                y = tc1.trim_conv1d(xz[..., :d], w)
                assert type(y.grad_fn).__name__ == "_TrimConv1dFnBackward"
                dxz, dw = torch.autograd.grad(y, (xz, w),
                                              torch.from_numpy(dyn))
                assert torch.equal(dxz[..., d:], torch.zeros_like(
                    dxz[..., d:]))
                dx = dxz[..., :d]
                xr = torch.from_numpy(xzn[..., :d]).requires_grad_()
                wr = torch.from_numpy(wn).requires_grad_()
                yr = ref.depthwise_conv1d(xr, wr)
                assert torch.equal(y, yr)
                want = torch.autograd.grad(yr, (xr, wr),
                                           torch.from_numpy(dyn))
                jdx, jdw = _jax_vjp(xzn[..., :d], wn, dyn)
                for got, oracle, jgot, name in ((dx, want[0], jdx, "dx"),
                                                (dw, want[1], jdw, "dw")):
                    _close(got, oracle, (name, "autograd") + what)
                    _close(got, jgot, (name, "jax") + what)


@pytest.mark.parametrize("tile_l", [None, 1, 3, 64])
def test_input_grad_plain_is_the_flip_formula_bitwise(tile_l):
    for b, length, d, k in ((2, 17, 5, 4), (1, 300, 33, 9), (2, 2, 8, 3)):
        _, wn, dyn = _inputs(b, length, d, k, length, False)
        dy, w = torch.from_numpy(dyn), torch.from_numpy(wn)
        want = tc1.trim_conv1d_plain(dy.flip(1), w).flip(1)
        assert torch.equal(tc1.trim_conv1d_input_grad_plain(
            dy, w, tile_l=tile_l), want)
        assert torch.equal(tc1.trim_conv1d_input_grad(dy, w,
                                                      tile_l=tile_l), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_input_grad_takes_the_route_plan(dtype):
    """dx is the forward kernel on the reversed cotangent, on the route's
    own plan: at the training rows (c) recurrentgemma-2b's and (d)
    falcon-mamba-7b's, 16-byte rows (4 f32 / 8 bf16 channels a lane),
    runs of 16 steps and whole channel warps; on the CPU its plain
    version is the flip formula bit for bit in either dtype."""
    e = torch.empty((), dtype=dtype).element_size()
    for (b, length, d), d_warps in (((1, 4096, 2560), {4: 20, 2: 10}),
                                    ((2, 1024, 8192), {4: 64, 2: 32})):
        dy = torch.empty((b, length, d), dtype=dtype)
        plan = tc1.plan_for(dy, torch.empty((4, d), dtype=dtype))
        assert (plan.dtype_bytes, plan.vec) == (e, conv_plan.CONV1D_VEC[e])
        assert (plan.tile_l, plan.d_warps) == (16, d_warps[e])
        assert plan.d_warps * plan.tile_d == d
    _, wn, dyn = _inputs(2, 45, 24, 4, 3, False)
    dy, w = torch.from_numpy(dyn).to(dtype), torch.from_numpy(wn).to(dtype)
    want = tc1.trim_conv1d_plain(dy.flip(1), w).flip(1)
    assert torch.equal(tc1.trim_conv1d_input_grad(dy, w), want)
    assert torch.equal(tc1.trim_conv1d_input_grad_plain(dy, w), want)


@pytest.mark.parametrize("tile_l", [None, 1, 5, 8])
def test_wgrad_plain_is_bitwise_repeatable(tile_l):
    """Two calls bitwise equal (the ordered runs and groups); the plan's
    schedule against an unordered f64 sum within TOL."""
    for b, length, d, k in ((2, 300, 40, 4), (3, 17, 5, 9), (1, 100, 300, 2)):
        xzn, _, dyn = _inputs(b, length, d, k, length + k, True)
        x = torch.from_numpy(xzn)[..., :d]
        dy = torch.from_numpy(dyn)
        first = tc1.trim_conv1d_wgrad_plain(x, dy, k, tile_l=tile_l)
        assert torch.equal(first, tc1.trim_conv1d_wgrad_plain(
            x, dy, k, tile_l=tile_l))
        assert torch.equal(first, tc1.trim_conv1d_weight_grad(
            x, dy, k, tile_l=tile_l))
        xp = np.pad(xzn[..., :d].astype(np.float64),
                    ((0, 0), (k - 1, 0), (0, 0)))
        exact = np.stack([(xp[:, i:i + length] * dyn).sum((0, 1))
                          for i in range(k)])
        _close(first, exact, ("dw", b, length, d, k, tile_l))


def test_wgrad_plan_runs_groups_and_scratch():
    # recurrentgemma-2b's training row and mamba's training batch, f32 (4
    # channels a lane) and bf16 (8): the longest run that still gives
    # CONV1D_WGRAD_MIN_BLOCKS blocks, never one whose halo passes a tenth
    rg = Conv1dWeightGradPlan.build((1, 4096, 2560), 4, vec=4)
    assert (rg.tile_l, rg.runs, rg.groups, rg.grid) == (64, 64, 16, (16, 20))
    assert rg.partial_shape == (16, 4, 2560)
    assert rg.min_bytes() == 4 * (2 * 4096 * 2560 + 4 * 2560)
    assert rg.bound()[1] == "bytes"
    assert abs(rg.bound()[0] - 0.025053) < 1e-5
    rg16 = Conv1dWeightGradPlan.build((1, 4096, 2560), 4, dtype_bytes=2,
                                      vec=8)
    assert (rg16.tile_l, rg16.runs, rg16.groups, rg16.grid) == (
        32, 128, 32, (32, 10))
    assert rg16.min_bytes() == 2 * (2 * 4096 * 2560 + 4 * 2560)
    assert abs(rg16.bound()[0] - 0.0125264) < 1e-6
    mb = Conv1dWeightGradPlan.build((2, 1024, 8192), 4, vec=4)
    assert (mb.tile_l, mb.runs_per_b, mb.runs, mb.groups, mb.grid) == (
        64, 16, 32, 8, (8, 64))
    mb16 = Conv1dWeightGradPlan.build((2, 1024, 8192), 4, dtype_bytes=2,
                                      vec=8)
    assert (mb16.tile_l, mb16.runs, mb16.groups, mb16.grid) == (
        32, 64, 16, (16, 32))
    # one channel a lane (rows not 16-byte aligned): 32 channels a block
    one = Conv1dWeightGradPlan.build((1, 4096, 2560), 4)
    assert (one.tile_d, one.tile_l, one.grid) == (32, 256, (4, 80))
    for plan in (rg, rg16, mb, mb16, one):
        assert plan.blocks >= conv_plan.CONV1D_WGRAD_MIN_BLOCKS
        assert plan.k - 1 <= conv_plan.CONV1D_WGRAD_HALO_SHARE * plan.tile_l
        assert plan.tile_d == conv_plan.CONV1D_WGRAD_LANES * plan.vec
        bytes_ = plan.hbm_bytes()
        assert bytes_["total"] == sum(v for key, v in bytes_.items()
                                      if key != "total")
        assert bytes_["partials"] == 2 * 4 * plan.groups * plan.k * plan.d
        # the redesign's traffic: halo and partials under 12% of the least
        assert bytes_["total"] <= 1.12 * plan.min_bytes()
    # runs never straddle a sequence; a short L is one run a sequence
    short = Conv1dWeightGradPlan.build((3, 5, 7), 4)
    assert (short.tile_l, short.runs_per_b, short.runs, short.groups) == (
        5, 1, 3, 1)
    ragged = Conv1dWeightGradPlan.build((2, 17, 5), 3, tile_l=8)
    assert (ragged.runs_per_b, ragged.runs, ragged.groups) == (3, 6, 2)
    assert ragged.hbm_bytes()["halo"] == 4 * 2 * 5 * (0 + 2 + 2)
    # a long kernel takes runs long enough for its halo: K 9 -> 128
    assert Conv1dWeightGradPlan.build((1, 4096, 64), 9).tile_l == 128
    for bad in (dict(x_shape=(2, 0, 4), k=4), dict(x_shape=(2, 8, 4), k=1),
                dict(x_shape=(8, 4), k=4),
                dict(x_shape=(2, 8, 4), k=4, tile_l=0),
                dict(x_shape=(2, 8, 6), k=4, vec=4),
                dict(x_shape=(2, 8, 8), k=4, dtype_bytes=2, vec=4),
                dict(x_shape=(2, 8, 8), k=4, dtype_bytes=8),
                dict(x_shape=(2, 8, 256), k=200, dtype_bytes=2, vec=8)):
        with pytest.raises(ValueError):
            Conv1dWeightGradPlan.build(**bad)


def test_wgrad_plan_constants_match_the_kernel():
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 CU.read_text(), re.M):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    assert found == {
        "kRuns": conv_plan.CONV1D_WGRAD_RUNS,
        "kLanes": conv_plan.CONV1D_WGRAD_LANES,
        "kThreads": (conv_plan.CONV1D_WGRAD_RUNS
                     * conv_plan.CONV1D_WGRAD_LANES),
        "kVecF32": conv_plan.CONV1D_WGRAD_VEC[4],
        "kVecBf16": conv_plan.CONV1D_WGRAD_VEC[2],
        "kUnroll": conv_plan.CONV1D_WGRAD_UNROLL,
        "kMaxUnrolledK": conv_plan.CONV1D_UNROLLED_K,
        "kSumThreads": conv_plan.CONV1D_WGRAD_SUM_THREADS,
        "kMaxSmemBytes": conv_plan.CONV1D_WGRAD_MAX_SMEM,
    }


def test_ops_routes_the_gradient():
    xzn, wn, dyn = _inputs(2, 40, 6, 4, 7, False)
    out = {}
    for impl in ("trim", "ref"):
        x = torch.from_numpy(xzn).requires_grad_()
        w = torch.from_numpy(wn).requires_grad_()
        y = ops.depthwise_conv1d(x, w, impl=impl)
        name = type(y.grad_fn).__name__
        assert (name == "_TrimConv1dFnBackward") == (impl == "trim"), name
        out[impl] = (y,) + torch.autograd.grad(y, (x, w),
                                               torch.from_numpy(dyn))
    assert torch.equal(out["trim"][0], out["ref"][0])
    for got, want in zip(out["trim"][1:], out["ref"][1:]):
        _close(got, want, impl)
    # only w needs a gradient: dx is not computed
    tc1.reset_launch_counts()
    w = torch.from_numpy(wn).requires_grad_()
    y = tc1.trim_conv1d(torch.from_numpy(xzn), w)
    (dw,) = torch.autograd.grad(y, (w,), torch.from_numpy(dyn))
    assert torch.equal(dw, tc1.trim_conv1d_wgrad_plain(
        torch.from_numpy(xzn), torch.from_numpy(dyn), 4))
    assert tc1.LAUNCHES == {"trim_conv1d": 0, "trim_conv1d_bf16": 0}
    assert tc1.BWD_LAUNCHES == {"trim_conv1d_dx": 0, "trim_conv1d_wgrad": 0,
                                "trim_conv1d_dx_bf16": 0,
                                "trim_conv1d_wgrad_bf16": 0}


def test_backward_wrappers_reject_what_the_kernels_cannot_take():
    x, w = torch.zeros((2, 8, 4)), torch.zeros((4, 4))
    with pytest.raises(ValueError, match="x's shape"):
        tc1.trim_conv1d_weight_grad(x, torch.zeros((2, 7, 4)), 4)
    with pytest.raises(ValueError, match="float32"):
        tc1.trim_conv1d_weight_grad(x, x.double(), 4)
    with pytest.raises(ValueError, match="K=1"):
        tc1.trim_conv1d_weight_grad(x, x, 1)
    with pytest.raises(ValueError, match="float32"):
        tc1.trim_conv1d_input_grad(x.double(), w)
    # a cotangent without a contiguous channel axis is copied, not refused
    dy = torch.arange(64.0).reshape(2, 4, 8).transpose(1, 2)
    assert torch.equal(tc1.trim_conv1d_input_grad(dy, w),
                       tc1.trim_conv1d_input_grad(dy.contiguous(), w))
    assert Conv1dPlan.build((2, 8, 4), (4, 4)).k == 4
