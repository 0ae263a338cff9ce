"""Causal depthwise conv1d (the Mamba / RG-LRU temporal conv): the wrappers
of the Hopper kernels, forward and backward, and their plain PyTorch
versions (the counterpart of ``repro/kernels/trim_conv1d.py``, f32 and
bf16).

``trim_conv1d`` launches the hand-written kernel of ``csrc/trim_conv1d.cu``
on CUDA tensors and runs :func:`trim_conv1d_plain` on CPU tensors; nothing
falls back.  Both compute ``_kernel`` (``repro/kernels/trim_conv1d.py:29``):
``y[b, t, d] = sum_{i < K} x[b, t-K+1+i, d] * w[i, d]`` with zero left
padding, summed from 0 in the order i = 0..K-1 with every product rounded
before its add, so the kernel, its plain version and
``ref.depthwise_conv1d`` agree bit for bit.  The geometry (a block one
warp, over one run of ``tile_l`` steps and one channel warp of
``tile_d`` channels, ``vec`` a lane) is ``core.conv_plan.Conv1dPlan``'s,
built for the route by :func:`plan_for`.  The input may be a strided
view with a contiguous channel axis (the mixer's half of the
in-projection); it is read in place.  Where rows are 16-byte aligned a
lane owns 4 f32 (:func:`f32_vec`) or 8 bf16 (:func:`bf16_vec`) channels
and moves a row with one 16-byte load or store.

bf16 x and w launch ``trim_conv1d_bf16``, the same kernel on bf16
operands: every value widened to f32 (exact), products exact in f32, the
f32 sum from 0 in tap order rounded once to bf16 at the store, which is
``_kernel``'s ``acc.astype(o_ref.dtype)`` (``repro/kernels/
trim_conv1d.py:38-40``); the plain version computes the same in f32 and
casts once, so the three agree bit for bit.  (``ref.depthwise_conv1d``
on bf16 rounds every product and sum to bf16, as JAX's oracle does, and
differs.)

Under autograd ``trim_conv1d`` is ``_TrimConv1dFn`` (it saves x and w),
the counterpart of JAX's autodiff of ``ref.depthwise_conv1d`` (the JAX
package has no conv1d backward kernel).  Its backward runs two kernels,
each on f32 or bf16 operands, and returns dx and dw in their operands'
dtype:

* dx, :func:`trim_conv1d_input_grad`: ``dx[t] = sum_i w[i] dy[t+K-1-i]``,
  which in reversed time (``r = L-1-t``) is the forward's causal conv of
  the reversed cotangent with the same taps in the same order.  So it is
  the forward kernel (``trim_conv1d_f32`` or ``trim_conv1d_bf16``)
  launched on dy and dx as reversed views (the base pointer at row L-1,
  the time stride negated; no copy), and its plain version is
  ``trim_conv1d_plain(dy.flip(1), w).flip(1)``, bit for bit.
* dw, :func:`trim_conv1d_weight_grad`: the kernel of
  ``csrc/trim_conv1d_wgrad.cu`` (``trim_conv1d_wgrad_f32`` or
  ``_bf16``) on ``core.conv_plan.Conv1dWeightGradPlan``'s runs and
  groups, the f32 partials added in group order (no atomics) and rounded
  once to the operands' dtype, equal to :func:`trim_conv1d_wgrad_plain`
  bit for bit.  In bf16 both widen x and dy (exact products) and sum in
  f32: JAX's ``ref.depthwise_conv1d`` on bf16 rounds after every
  operation instead, so the two part by up to a few bf16 ulps (ROADMAP
  Queue 3).

``LAUNCHES`` counts the forward kernel's launches by route
(``trim_conv1d``: f32, ``trim_conv1d_bf16``), ``BWD_LAUNCHES`` the
backward's (``trim_conv1d_dx``: the forward kernel on the reversed
cotangent; ``trim_conv1d_wgrad``: one a call, its two launches together;
the bf16 route's under the same names with ``_bf16``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.conv_plan import (CONV1D_VEC, CONV1D_WGRAD_RUNS,
                                         CONV1D_WGRAD_VEC, Conv1dPlan,
                                         Conv1dWeightGradPlan)
from repro_torch.kernels import build

# Kernel launches: each successful launch adds one, under its route's key.
LAUNCHES = {"trim_conv1d": 0, "trim_conv1d_bf16": 0}
BWD_LAUNCHES = {"trim_conv1d_dx": 0, "trim_conv1d_wgrad": 0,
                "trim_conv1d_dx_bf16": 0, "trim_conv1d_wgrad_bf16": 0}
# The geometry of the forward kernel's last launch (grid, threads a block,
# D, L, tile_l, tile_d, vec), as the wrapper passed it.
LAST_LAUNCH: dict = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _check(x: torch.Tensor, w: torch.Tensor, *,
           dtypes=(torch.float32, torch.bfloat16)) -> None:
    for name, t in (("x", x), ("w", w)):
        if t.device.type not in ("cpu", "cuda") or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}: "
                             "x and w must share a CPU or CUDA device")
        if t.dtype not in dtypes or t.dtype != x.dtype:
            raise ValueError(
                f"{name} is {t.dtype}, x {x.dtype}; this kernel takes "
                f"x and w both of one of {[str(d) for d in dtypes]}")
    if x.dim() == 3 and x.stride(2) != 1:
        raise ValueError(f"x must have a contiguous channel axis; got "
                         f"strides {x.stride()}")


def _row_vec(x: torch.Tensor, w: torch.Tensor, v: int) -> int:
    """``v`` where x's rows, w's contiguous rows and the output's hold
    whole 16-byte vectors of ``v`` channels (D and x's batch and time
    strides multiples of ``v``, the pointers of 16 bytes), else 1."""
    ok = (x.shape[-1] % v == 0 and x.stride(0) % v == 0
          and x.stride(1) % v == 0 and x.data_ptr() % 16 == 0
          and w.data_ptr() % 16 == 0)
    return v if ok else 1


def f32_vec(x: torch.Tensor, w: torch.Tensor) -> int:
    """Channels a lane of the f32 route: ``CONV1D_VEC[4]`` (one float4 a
    row) where rows are 16-byte aligned, else 1."""
    return _row_vec(x, w, CONV1D_VEC[4])


def bf16_vec(x: torch.Tensor, w: torch.Tensor) -> int:
    """Channels a lane of the bf16 route: ``CONV1D_VEC[2]`` (one uint4 a
    row) where rows are 16-byte aligned, else 1."""
    return _row_vec(x, w, CONV1D_VEC[2])


def plan_for(x: torch.Tensor, w: torch.Tensor,
             tile_l: int | None = None) -> Conv1dPlan:
    """The plan of x's route: bf16 (2-byte elements, :func:`bf16_vec`) or
    f32 (:func:`f32_vec`; a float64 oracle's too, one channel a lane)."""
    if x.dtype == torch.bfloat16:
        return Conv1dPlan.build(tuple(x.shape), tuple(w.shape),
                                tile_l=tile_l, dtype_bytes=2,
                                vec=bf16_vec(x, w))
    return Conv1dPlan.build(
        tuple(x.shape), tuple(w.shape), tile_l=tile_l,
        vec=f32_vec(x, w) if x.dtype == torch.float32 else 1)


def trim_conv1d_plain(x: torch.Tensor, w: torch.Tensor, *,
                      tile_l: int | None = None) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch, on x's route's plan: the
    sequence cut into runs of ``tile_l`` steps, each run's window holding
    its ``K-1`` predecessors (the halo; zeros before t = 0), the channels
    cut into channel warps of ``tile_d`` (the last one's lanes past D
    computing on zeros, then dropped), and the taps summed over every
    run and channel warp at once in the kernel's order, in f32 (bf16
    operands widened: exact products), cast once to x's dtype.  x: (B, L,
    D); w: (K, D)."""
    plan = plan_for(x, w.contiguous(), tile_l)
    b, length, d = x.shape
    k, tl, td = plan.k, plan.tile_l, plan.tile_d
    padded, wide = plan.runs * tl, plan.d_warps * td
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_dtype), (0, wide - d, k - 1, padded - length))
    win = xp.unfold(1, tl + k - 1, tl)      # (B, runs, wide, tl + K - 1)
    win = win.reshape(b, plan.runs, plan.d_warps, td, tl + k - 1)
    wf = F.pad(w.to(acc_dtype), (0, wide - d)).reshape(k, plan.d_warps,
                                                       td, 1)
    acc = 0
    for i in range(k):
        acc = acc + win[..., i:i + tl] * wf[i]
    y = acc.permute(0, 1, 4, 2, 3).reshape(b, padded, wide)
    return y[:, :length, :d].to(x.dtype).contiguous()


def _launch_args(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                 plan: Conv1dPlan, *, reverse: bool = False) -> tuple:
    """The C entry's arguments but the stream: x, w and y (B, L, D) as
    the kernel reads them; with ``reverse``, x and y in reversed time
    (the base pointers at row L-1, the time strides negated), which is
    the input gradient's launch."""
    b, length, d = x.shape
    x_ptr, x_sl = x.data_ptr(), x.stride(1)
    y_ptr, y_sl = y.data_ptr(), y.stride(1)
    if reverse:
        x_ptr += x.element_size() * (length - 1) * x_sl
        y_ptr += y.element_size() * (length - 1) * y_sl
        x_sl, y_sl = -x_sl, -y_sl
    return (x_ptr, w.data_ptr(), y_ptr, b, length, d, plan.k, x.stride(0),
            x_sl, y.stride(0), y_sl, plan.tile_l, plan.tile_d, plan.vec)


def _launch(x: torch.Tensor, w: torch.Tensor, plan: Conv1dPlan, *,
            reverse: bool = False) -> torch.Tensor:
    """One launch of ``trim_conv1d_f32`` (or, for a bf16 plan,
    ``trim_conv1d_bf16``) on x, on the plan's grid (:data:`LAST_LAUNCH`
    records it); with ``reverse``, the input gradient's launch
    (:func:`_launch_args`)."""
    y = torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)
    args = _launch_args(x, w, y, plan, reverse=reverse)
    lib = build.library("trim_conv1d")
    entry = lib.trim_conv1d_bf16 if plan.dtype_bytes == 2 \
        else lib.trim_conv1d_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv1d kernel launch failed: CUDA error {err} "
            f"({lib.trim_conv1d_error_string(err).decode()}) for x "
            f"{tuple(x.shape)} {x.dtype} strides {x.stride()}, K={plan.k}, "
            f"tile_l={plan.tile_l}, tile_d={plan.tile_d}, vec={plan.vec}, "
            f"reverse={reverse} (a refused tile_d means the plan's "
            "CONV1D_* constants and the .cu's disagree)")
    LAST_LAUNCH.update(grid=plan.grid, threads=plan.threads, d=plan.d,
                       length=plan.length, tile_l=plan.tile_l,
                       tile_d=plan.tile_d, vec=plan.vec)
    return y


def _forward(x: torch.Tensor, w: torch.Tensor,
             tile_l: int | None) -> torch.Tensor:
    w = w.contiguous()
    plan = plan_for(x, w, tile_l)
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv1d_plain(x, w, tile_l=plan.tile_l)
    y = _launch(x, w, plan)
    LAUNCHES["trim_conv1d_bf16" if x.dtype == torch.bfloat16
             else "trim_conv1d"] += 1
    return y


def _channels_contiguous(dy: torch.Tensor) -> torch.Tensor:
    """The cotangent with a contiguous channel axis, as the kernels read
    it (a copy only where it has none)."""
    return dy if dy.dim() != 3 or dy.stride(2) == 1 else dy.contiguous()


def trim_conv1d_input_grad(dy: torch.Tensor, w: torch.Tensor, *,
                           tile_l: int | None = None) -> torch.Tensor:
    """dx (B, L, D) of ``y = trim_conv1d(x, w)`` from dy (B, L, D): the
    forward kernel on dy and dx in reversed time (module docstring),
    counted in ``BWD_LAUNCHES["trim_conv1d_dx"]`` (bf16:
    ``"trim_conv1d_dx_bf16"``, the ``trim_conv1d_bf16`` route); on CPU tensors its plain version,
    :func:`trim_conv1d_input_grad_plain`.  dy and w share f32 or bf16."""
    dy = _channels_contiguous(dy)
    _check(dy, w)
    w = w.contiguous()
    plan = plan_for(dy, w, tile_l)
    if dy.device.type == "cpu":
        with torch.no_grad():
            return trim_conv1d_input_grad_plain(dy, w, tile_l=plan.tile_l)
    dx = _launch(dy, w, plan, reverse=True)
    BWD_LAUNCHES["trim_conv1d_dx_bf16" if dy.dtype == torch.bfloat16
                 else "trim_conv1d_dx"] += 1
    return dx


def trim_conv1d_input_grad_plain(dy: torch.Tensor, w: torch.Tensor, *,
                                 tile_l: int | None = None) -> torch.Tensor:
    """The input gradient's plain version: the forward's plain version on
    the reversed cotangent, reversed back."""
    return trim_conv1d_plain(dy.flip(1), w, tile_l=tile_l).flip(1)


def wgrad_vec(x: torch.Tensor, dy: torch.Tensor) -> int:
    """Channels a lane of the weight-gradient kernel:
    ``CONV1D_WGRAD_VEC`` of the element size (4 f32, 8 bf16) where x's
    and dy's rows are 16-byte aligned (D and both tensors' batch and time
    strides multiples of it, the pointers of 16 bytes), else 1."""
    v = CONV1D_WGRAD_VEC.get(x.element_size(), 1)     # float64: 1
    ok = x.shape[-1] % v == 0 and all(
        t.stride(0) % v == 0 and t.stride(1) % v == 0
        and t.data_ptr() % 16 == 0 for t in (x, dy))
    return v if ok else 1


def _wgrad_plan(x, dy, k, tile_l) -> Conv1dWeightGradPlan:
    """The weight-gradient plan of x and dy (a float64 oracle's: f32's
    geometry, one channel a lane)."""
    return Conv1dWeightGradPlan.build(
        tuple(x.shape), k, tile_l=tile_l,
        dtype_bytes=2 if x.dtype == torch.bfloat16 else 4,
        vec=wgrad_vec(x, dy))


def trim_conv1d_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, k: int, *,
                            tile_l: int | None = None) -> torch.Tensor:
    """The weight-gradient kernel's schedule in plain PyTorch -> dw (K, D)
    of x's dtype: each run of the plan's ``tile_l`` steps summed from 0
    in time order (every product rounded before its add) with its
    window's ``K-1`` predecessors (zeros before t = 0), the runs of each
    group of ``CONV1D_WGRAD_RUNS`` added in run order, then the groups in
    group order, every run, group and channel at once, in f32 (bf16
    operands widened: exact products; float64 operands in float64, an
    oracle), cast once to x's dtype."""
    plan = _wgrad_plan(x, dy, k, tile_l)
    b, length, d = x.shape
    tl, rpb = plan.tile_l, plan.runs_per_b
    padded = rpb * tl
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xw = F.pad(x.to(acc_dtype), (0, 0, k - 1, padded - length)).unfold(
        1, tl + k - 1, tl)
    gw = F.pad(dy.to(acc_dtype), (0, 0, 0, padded - length)).unfold(1, tl,
                                                                      tl)
    acc = torch.zeros((b, rpb, d, k), dtype=acc_dtype, device=x.device)
    for j in range(tl):                 # (B, runs, D, tl [+ K-1])
        acc = acc + xw[..., j:j + k] * gw[..., j:j + 1]
    runs = F.pad(acc.reshape(b * rpb, d, k),
                 (0, 0, 0, 0, 0, plan.groups * CONV1D_WGRAD_RUNS - plan.runs))
    runs = runs.reshape(plan.groups, CONV1D_WGRAD_RUNS, d, k)
    part = torch.zeros((plan.groups, d, k), dtype=acc_dtype,
                       device=x.device)
    for r in range(CONV1D_WGRAD_RUNS):
        part = part + runs[:, r]
    dw = torch.zeros((d, k), dtype=acc_dtype, device=x.device)
    for g in range(plan.groups):
        dw = dw + part[g]
    return dw.t().contiguous().to(x.dtype)


def trim_conv1d_weight_grad(x: torch.Tensor, dy: torch.Tensor, k: int, *,
                            tile_l: int | None = None) -> torch.Tensor:
    """dw (K, D) of x's dtype of ``y = trim_conv1d(x, w)`` from x and dy
    (B, L, D), both f32 or both bf16, x read through its strides: the
    kernel of ``csrc/trim_conv1d_wgrad.cu`` (two launches, counted once in
    ``BWD_LAUNCHES["trim_conv1d_wgrad"]``, bf16 under
    ``"trim_conv1d_wgrad_bf16"``); on CPU tensors
    :func:`trim_conv1d_wgrad_plain`."""
    dy = _channels_contiguous(dy)
    _check(x, dy)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not of x's shape "
                         f"{tuple(x.shape)}")
    plan = _wgrad_plan(x, dy, k, tile_l)
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv1d_wgrad_plain(x, dy, k, tile_l=plan.tile_l)
    bf16 = x.dtype == torch.bfloat16
    b, length, d = x.shape
    partial = torch.empty(plan.partial_shape, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((k, d), dtype=x.dtype, device=x.device)
    lib = build.library("trim_conv1d_wgrad")
    entry = lib.trim_conv1d_wgrad_bf16 if bf16 else lib.trim_conv1d_wgrad_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            b, length, d, k, x.stride(0), x.stride(1), dy.stride(0),
            dy.stride(1), plan.tile_l, plan.groups, plan.vec, stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv1d_wgrad kernel launch failed: CUDA error {err} "
            f"({lib.trim_conv1d_wgrad_error_string(err).decode()}) for x "
            f"{tuple(x.shape)} {x.dtype} strides {x.stride()}, K={k}, "
            f"tile_l={plan.tile_l}, groups={plan.groups}, vec={plan.vec} "
            "(a wrong group count means the plan's CONV1D_WGRAD_* "
            "constants and the .cu's disagree)")
    BWD_LAUNCHES["trim_conv1d_wgrad_bf16" if bf16
                 else "trim_conv1d_wgrad"] += 1
    return dw


class _TrimConv1dFn(torch.autograd.Function):
    """The conv1d with the kernels' gradient: the forward keeps (x, w),
    the backward runs :func:`trim_conv1d_input_grad` and
    :func:`trim_conv1d_weight_grad` (each only where its input needs a
    gradient)."""

    @staticmethod
    def forward(ctx, x, w, tile_l):
        ctx.save_for_backward(x, w)
        return _forward(x, w, tile_l)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = trim_conv1d_input_grad(dy, w) if ctx.needs_input_grad[0] \
            else None
        dw = trim_conv1d_weight_grad(x, dy, w.shape[0]) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def trim_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                tile_l: int | None = None) -> torch.Tensor:
    """x: (B, L, D) f32 or bf16 with a contiguous channel axis (other
    strides are read as they are); w: (K, D) of x's dtype, K >= 2 -> y
    (B, L, D) of x's dtype.

    On CUDA tensors, one launch of the hand-written kernel's route for
    the dtype (counted in ``LAUNCHES``); on CPU tensors,
    :func:`trim_conv1d_plain`.  Under autograd, with x or w requiring
    grad, through ``_TrimConv1dFn``, whose backward runs the backward
    kernels on the operands' dtype (module docstring).  Raises
    ``ValueError`` for what the kernel cannot take: another dtype, mixed
    dtypes or devices, K < 2, or an empty B, L or D.  ``tile_l`` left as
    ``None`` takes ``Conv1dPlan.build``'s choice.
    """
    _check(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _TrimConv1dFn.apply(x, w, tile_l)
    return _forward(x, w, tile_l)
