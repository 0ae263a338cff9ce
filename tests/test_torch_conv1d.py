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
errors (at the main-path rows in f32 and bf16: no idle lane, the halo
share, the bytes in flight, the bytes of a walk over the runs; its
constants parsed from ``csrc/trim_conv1d.cu``), and when the f32 route
takes 16-byte rows (aligned views, the input gradient's reversed
launch).  The kernel itself runs on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.trim_conv1d import trim_conv1d as jtrim_conv1d
from repro_torch.core import conv_plan
from repro_torch.core.conv_plan import (CONV1D_AHEAD, CONV1D_HALO_SHARE,
                                        CONV1D_INFLIGHT_BYTES,
                                        CONV1D_RESIDENT_WARPS,
                                        CONV1D_UNROLLED_K, CONV1D_VEC, SMS,
                                        Conv1dPlan)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv1d as tc1

CU = Path(tc1.__file__).resolve().parent / "csrc" / "trim_conv1d.cu"

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
    """falcon-mamba-7b prefill, 2 x 2048 tokens, d_inner 8192, K 4, on the
    f32 route's 16-byte rows (4 channels a lane)."""
    plan = Conv1dPlan.build((2, 2048, 8192), (4, 8192), vec=4)
    assert (plan.tile_l, plan.tile_d) == (16, 128)
    assert plan.grid == (128 * 64, 2) and plan.blocks == 16384
    # the shortest run whose K-1 halo rows stay within the share
    assert plan.k - 1 <= CONV1D_HALO_SHARE * plan.tile_l
    assert plan.k - 1 > CONV1D_HALO_SHARE * plan.tile_l / 2
    assert plan.inflight_bytes >= CONV1D_INFLIGHT_BYTES
    assert plan.flops == 2 * 2 * 2048 * 8192 * 4
    assert plan.min_bytes() == 4 * (2 * 2 * 2048 * 8192 + 4 * 8192)
    ms, by = plan.bound()
    assert by == "bytes" and abs(ms - 0.0802) < 1e-3
    hbm = plan.hbm_bytes()
    assert hbm["halo"] == 4 * 2 * 8192 * 3 * 127
    assert hbm["total"] == sum(v for key, v in hbm.items() if key != "total")


# (a) falcon-mamba-7b prefill, (b) recurrentgemma-2b prefill (forward);
# (c) recurrentgemma-2b training, (d) falcon-mamba-7b training (dx)
MAIN_ROWS = {"a": (2, 2048, 8192), "b": (2, 4096, 2560),
             "c": (1, 4096, 2560), "d": (2, 1024, 8192)}
# (tile_l, channel warps) of each row on the f32 and the bf16 route
MAIN_PLANS = {("a", 4): (16, 64), ("b", 4): (16, 20), ("c", 4): (16, 20),
              ("d", 4): (16, 64), ("a", 2): (16, 32), ("b", 2): (16, 10),
              ("c", 2): (16, 10), ("d", 2): (16, 32)}


@pytest.mark.parametrize("row,dtype_bytes", sorted(MAIN_PLANS),
                         ids=[f"{r}-{'f32' if e == 4 else 'bf16'}"
                              for r, e in sorted(MAIN_PLANS)])
def test_plan_at_the_main_path_rows(row, dtype_bytes):
    """At every main-path row, on each route's 16-byte rows: no idle lane
    (D 2560 and 8192 are whole channel warps), runs whose K-1 halo rows
    stay within CONV1D_HALO_SHARE, at least Little's law's bytes in flight
    on an SM, and hbm_bytes() equal to the bytes of a walk over the
    runs."""
    b, length, d = MAIN_ROWS[row]
    plan = Conv1dPlan.build((b, length, d), (4, d), dtype_bytes=dtype_bytes,
                            vec=CONV1D_VEC[dtype_bytes])
    assert (plan.tile_l, plan.d_warps) == MAIN_PLANS[row, dtype_bytes]
    assert plan.tile_d == 32 * plan.vec and plan.threads == 32
    # every launched lane owns channels: no idle lane anywhere
    assert plan.d_warps * plan.tile_d == d
    assert plan.grid == (plan.runs * plan.d_warps, b)
    assert plan.blocks == b * plan.runs * plan.d_warps
    assert plan.k - 1 <= CONV1D_HALO_SHARE * plan.tile_l
    assert plan.halo_share <= CONV1D_HALO_SHARE
    assert plan.warp_inflight_bytes == 2 * CONV1D_AHEAD * 32 * 16
    # every SM holds its resident warps: 2,560 warps and more
    assert plan.blocks >= SMS * CONV1D_RESIDENT_WARPS
    assert plan.inflight_bytes == CONV1D_RESIDENT_WARPS \
        * plan.warp_inflight_bytes >= CONV1D_INFLIGHT_BYTES
    e = dtype_bytes
    walked = e * plan.k * d                          # the taps, once
    for _ in range(b):
        for t0 in range(0, length, plan.tile_l):
            t1 = min(t0 + plan.tile_l, length)
            walked += e * d * ((t1 - t0)            # the run's rows
                               + min(plan.k - 1, t0)   # its halo
                               + (t1 - t0))          # its output
    assert plan.hbm_bytes()["total"] == walked
    # the halo is the schedule's only traffic beyond the least
    assert walked - plan.min_bytes() == plan.hbm_bytes()["halo"] \
        <= CONV1D_HALO_SHARE * plan.min_bytes() / 2


@pytest.mark.parametrize("d,vec", [(5, 1), (100, 1), (2600, 4), (2056, 8),
                                   (33, 1)])
def test_plan_idles_only_the_last_channel_warp(d, vec):
    """Where D is not a multiple of a warp's channels, only each row's
    last channel warp holds lanes past D, and it holds at least one busy
    lane."""
    plan = Conv1dPlan.build((2, 300, d), (4, d), dtype_bytes=2 if vec == 8
                            else 4, vec=vec)
    lanes = -(-d // vec)                   # lanes that own channels
    idle = plan.d_warps * 32 - lanes
    assert 0 <= idle < 32 and (idle == 0) == (d % plan.tile_d == 0)
    assert (plan.d_warps - 1) * plan.tile_d < d <= plan.d_warps * plan.tile_d


def test_plan_constants_match_the_kernel():
    """Each constexpr of csrc/trim_conv1d.cu against its CONV1D_* mirror."""
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 CU.read_text(), re.M):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    assert found == {
        "kLanes": conv_plan.CONV1D_LANES,
        "kVecF32": CONV1D_VEC[4],
        "kVecBf16": CONV1D_VEC[2],
        "kAhead": CONV1D_AHEAD,
        "kMinBlocks": CONV1D_RESIDENT_WARPS,
        "kMaxUnrolledK": CONV1D_UNROLLED_K,
    }


def _aligned(shape, width=None, offset=0):
    """A float32 (B, L, D) view on 16-byte-aligned storage: the first D
    of ``width`` channels, starting ``offset`` elements in."""
    b, length, d = shape
    width = width or d
    base = torch.zeros(b * length * width + offset + 8)
    start = (-base.data_ptr() // 4) % 4 + offset      # 16-byte boundary
    return base[start:start + b * length * width].view(b, length,
                                                       width)[..., :d]


def test_f32_vec_eligibility():
    """4 channels a lane (one float4 a row) where D, the strides and the
    pointers hold whole 16-byte vectors; one channel elsewhere; the input
    gradient's reversed launch keeps its 16-byte rows."""
    w = _aligned((1, 4, 64))[0]
    view = _aligned((2, 10, 64), width=128)          # the mixer's half
    assert not view.is_contiguous() and tc1.f32_vec(view, w) == 4
    assert tc1.plan_for(view, w).vec == 4
    assert tc1.f32_vec(_aligned((2, 10, 64), width=128, offset=1), w) == 1
    assert tc1.f32_vec(_aligned((2, 10, 62)), _aligned((1, 4, 62))[0]) == 1
    assert tc1.f32_vec(_aligned((2, 10, 64), width=130), w) == 1
    assert tc1.plan_for(view.bfloat16(), w.bfloat16()).dtype_bytes == 2
    # dx: dy and dx read from row L-1 with negated time strides
    dy = _aligned((2, 10, 64))
    plan = tc1.plan_for(dy, w)
    args = tc1._launch_args(dy, w, torch.empty_like(dy), plan,
                            reverse=True)
    x_ptr, w_ptr, y_ptr, b, length, d, k, x_sb, x_sl, y_sb, y_sl = args[:11]
    assert plan.vec == 4 and args[11:] == (plan.tile_l, 128, 4)
    assert x_sl == y_sl == -64 and x_sb == y_sb == 640
    assert x_ptr == dy.data_ptr() + 4 * 9 * 64
    assert all(p % 16 == 0 for p in (x_ptr, w_ptr, y_ptr))
    assert all(s % 4 == 0 for s in (x_sb, x_sl, y_sb, y_sl, d))


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
    assert plan.tile_d == 32 and plan.tile_l == 7 and plan.grid == (1, 3)
    assert Conv1dPlan.build((1, 1, 24), (4, 24)).tile_l == 1
    wide = Conv1dPlan.build((1, 100, 300), (4, 300))
    assert (wide.tile_d, wide.d_warps, wide.tile_l) == (32, 10, 16)
    assert Conv1dPlan.build((1, 100, 300), (4, 300), vec=4).tile_d == 128


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
