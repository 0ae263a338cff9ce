"""The port's causal depthwise conv1d against the JAX package on the CPU.

Inputs come from a numpy seed and go to both packages.  On the CPU the
port's ``trim_conv1d`` runs its plain version (the kernel's runs and halos
in PyTorch); it is held against JAX ``trim_conv1d`` in Pallas interpret
mode and JAX ``ref.depthwise_conv1d`` on the JAX test grid
(``tests/test_kernels.py:148``) plus a strided view like the Mamba mixer's,
within 1e-5 * max(1, max|ref|) (f32 sums of K <= 4 products; XLA may
contract a product and its add), and against the port's own oracle bit
for bit (same products, same order).  Also: the decode step against the
full conv, the operator's routing, ``Conv1dPlan``'s geometry, bytes and
errors.  The kernel itself runs on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.trim_conv1d import trim_conv1d as jtrim_conv1d
from repro_torch.core.conv_plan import CONV1D_UNROLLED_K, Conv1dPlan
from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv1d as tc1

TOL = 1e-5
GRID = [(2, 16, 8, 4), (1, 100, 24, 4), (3, 7, 5, 2), (2, 33, 16, 3)]


def _inputs(b, length, d, k, seed=0, strided=False):
    rng = np.random.default_rng(seed)
    width = 2 * d if strided else d
    xz = rng.standard_normal((b, length, width)).astype(np.float32)
    w = rng.standard_normal((k, d)).astype(np.float32)
    return xz, w


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("case", GRID + [(2, 40, 24, 4, "strided")],
                         ids=["2x16x8k4", "1x100x24k4", "3x7x5k2",
                              "2x33x16k3", "strided"])
def test_conv1d_matches_jax_kernel_and_oracle(case):
    b, length, d, k = case[:4]
    strided = len(case) > 4
    xz, w = _inputs(b, length, d, k, strided=strided)
    xn = xz[..., :d]
    want = np.asarray(jref.depthwise_conv1d(jnp.asarray(xn), jnp.asarray(w)))
    pallas = np.asarray(jtrim_conv1d(jnp.asarray(xn), jnp.asarray(w),
                                     interpret=True))
    x = torch.from_numpy(xz)[..., :d]          # a view when strided
    assert x.is_contiguous() != strided
    got = tc1.trim_conv1d(x, torch.from_numpy(w))
    _close(got, want)
    _close(got, pallas)
    assert torch.equal(got, ref.depthwise_conv1d(x, torch.from_numpy(w)))


@pytest.mark.parametrize("k", [9, 12, 16])
def test_conv1d_above_the_unrolled_k_matches_jax(k):
    """K > 8 runs the kernel's runtime-K instance on the card; the port
    takes it as JAX does (which asserts only K >= 2), within TOL of the
    Pallas kernel and the oracle, and equal to its own oracle bitwise,
    with runs shorter than K-1 as well."""
    assert k > CONV1D_UNROLLED_K
    xz, w = _inputs(2, 40, 24, k, seed=k, strided=True)
    xn = xz[..., :24]
    want = np.asarray(jref.depthwise_conv1d(jnp.asarray(xn), jnp.asarray(w)))
    pallas = np.asarray(jtrim_conv1d(jnp.asarray(xn), jnp.asarray(w),
                                     interpret=True))
    x, wt = torch.from_numpy(xz)[..., :24], torch.from_numpy(w)
    got = ops.depthwise_conv1d(x, wt)
    _close(got, want)
    _close(got, pallas)
    assert torch.equal(got, ref.depthwise_conv1d(x, wt))
    assert torch.equal(tc1.trim_conv1d(x, wt, tile_l=3), got)
    plan = Conv1dPlan.build(tuple(x.shape), tuple(wt.shape), tile_l=3)
    assert plan.halo_rows == sum(min(k - 1, t0) for t0 in range(3, 40, 3))


@pytest.mark.parametrize("tile_l", [1, 2, 3, 5, 16, 64])
def test_plain_runs_and_halos_equal_the_oracle_bitwise(tile_l):
    """Every run length gives the oracle's bits: each run's window holds
    its K-1 predecessors (or the zero padding)."""
    xz, w = _inputs(3, 37, 40, 4, seed=tile_l)
    x, wt = torch.from_numpy(xz), torch.from_numpy(w)
    got = tc1.trim_conv1d(x, wt, tile_l=tile_l)
    assert got.is_contiguous()
    assert torch.equal(got, ref.depthwise_conv1d(x, wt))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_decode_step_walks_the_full_conv(k):
    """The decode state is the shadow registers: stepping one token at a
    time gives the full conv bit for bit, and JAX's step within TOL."""
    xz, w = _inputs(2, 10, 8, k, seed=k)
    x, wt = torch.from_numpy(xz), torch.from_numpy(w)
    full = ops.depthwise_conv1d(x, wt)
    state = torch.zeros((2, k - 1, 8))
    jstate = jnp.zeros((2, k - 1, 8))
    for t in range(10):
        state, y = ops.depthwise_conv1d_step(state, x[:, t], wt)
        jstate, jy = jref.depthwise_conv1d_step(jstate, jnp.asarray(xz[:, t]),
                                                jnp.asarray(w))
        assert torch.equal(y, full[:, t])
        _close(y, jy)
        _close(state, jstate)


def test_op_routes_impls_as_jax():
    xz, w = _inputs(2, 9, 6, 4)
    x, wt = torch.from_numpy(xz), torch.from_numpy(w)
    assert torch.equal(ops.depthwise_conv1d(x, wt),
                       ops.depthwise_conv1d(x, wt, impl="ref"))
    # K = 1 goes to the oracle, which the kernel does not take
    w1 = wt[:1]
    assert torch.equal(ops.depthwise_conv1d(x, w1), x * w1[0])
    with pytest.raises(ValueError, match="impl"):
        ops.depthwise_conv1d(x, wt, impl="pallas")


def test_plan_at_the_mamba_prefill_shape():
    """falcon-mamba-7b prefill, 2 x 2048 tokens, d_inner 8192, K 4."""
    plan = Conv1dPlan.build((2, 2048, 8192), (4, 8192))
    assert (plan.tile_l, plan.tile_d) == (32, 256)
    assert plan.grid == (2, 32, 64) and plan.blocks == 4096
    # three full waves of resident blocks (8 of 256 threads an SM)
    assert plan.blocks >= 3 * 132 * 8
    assert plan.flops == 2 * 2 * 2048 * 8192 * 4
    assert plan.min_bytes() == 4 * (2 * 2 * 2048 * 8192 + 4 * 8192)
    ms, by = plan.bound()
    assert by == "bytes" and abs(ms - 0.0802) < 1e-3
    hbm = plan.hbm_bytes()
    assert hbm["halo"] == 4 * 2 * 8192 * 3 * 63
    assert hbm["total"] == sum(v for key, v in hbm.items() if key != "total")


@pytest.mark.parametrize("length,tile_l,k", [(37, 5, 4), (37, 1, 4),
                                             (37, 2, 8), (7, 7, 2),
                                             (100, 8, 3), (2, 1, 4)])
def test_plan_halo_rows_count_the_reread_inputs(length, tile_l, k):
    plan = Conv1dPlan.build((1, length, 32), (k, 32), tile_l=tile_l)
    rows = sum(min(k - 1, t0) for t0 in range(tile_l, length, tile_l))
    assert plan.halo_rows == rows
    assert plan.runs == -(-length // tile_l)


def test_plan_defaults_and_small_shapes():
    plan = Conv1dPlan.build((3, 7, 5), (2, 5))
    assert plan.tile_d == 32 and plan.tile_l == 7 and plan.grid == (3, 1, 1)
    assert Conv1dPlan.build((1, 1, 24), (4, 24)).tile_l == 1
    assert Conv1dPlan.build((1, 100, 300), (4, 300)).tile_d == 256


@pytest.mark.parametrize("x_shape,w_shape,kw,match", [
    ((2, 8, 4), (1, 4), {}, "K=1"),
    ((2, 8, 4), (4, 5), {}, "channels"),
    ((2, 0, 4), (4, 4), {}, "empty"),
    ((2, 8, 0), (4, 0), {}, "empty"),
    ((2, 8, 4), (4,), {}, r"\(K, D\)"),
    ((2, 8, 4), (4, 4), {"tile_l": 0}, "tile_l"),
    ((70000, 8, 4), (4, 4), {}, "65535"),
    ((8, 4), (4, 4), {}, r"\(B, L, D\)"),
])
def test_plan_rejects_what_the_kernel_cannot_take(x_shape, w_shape, kw,
                                                  match):
    with pytest.raises(ValueError, match=match):
        Conv1dPlan.build(x_shape, w_shape, **kw)
