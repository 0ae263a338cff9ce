"""Fused residency groups: conv→[pool]→conv chains in one launch (the
counterpart of ``repro/kernels/trim_conv2d_fused.py``; DESIGN.md §8).

* :func:`trim_conv2d_fused` — the kernel wrapper.  On a CUDA tensor it
  launches the hand-written kernel of ``csrc/trim_conv2d_fused.cu``
  (counted in ``LAUNCHES["fused"]``; on bf16 operands its bf16 instance,
  ``trim_conv2d_fused_bf16``, in ``LAUNCHES["fused_bf16"]``) or raises;
  on a CPU tensor it runs :func:`trim_conv2d_fused_plain`, which walks the
  same tile geometry.
* :func:`reference_chain` — the per-layer execution of the same group
  (``ops.conv_pool_chain``: a conv launch and a separate max-pool per
  stage).  The kernel is bitwise equal to it on the card (the same order
  per element: the fmaf chain in f32 and on bf16 route ``"ffma"``, the
  k-steps of ``csrc/bf16_mma.cuh`` on bf16 route ``"mma"``), and it is the
  recompute path of the backward.
* :func:`fused_group_apply` — the differentiable entry point: forward on
  the fused kernel, backward by recomputing :func:`reference_chain`
  under autograd (``_FusedGroupFn``, the counterpart of the JAX
  ``_fused_vjp``), so cotangents run on the carry and weight-gradient
  kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.conv_plan import BF16_ROUTES
from repro_torch.kernels import build, ops
from repro_torch.kernels.ref import ACTIVATIONS, epilogue
from repro_torch.kernels.trim_conv2d import (ACTIVATION_CODES,
                                             FLOAT_KERNELS, LAUNCHES,
                                             _check_operands, fmaf_taps)


def _validate(x, weights, biases, group, activation) -> None:
    """The JAX wrapper's checks (``trim_conv2d_fused.py:232-260``)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"choose from {sorted(ACTIVATIONS, key=str)}")
    if len(weights) != group.depth or len(biases) != group.depth:
        raise ValueError(
            f"group depth {group.depth} needs {group.depth} weights/"
            f"biases, got {len(weights)}/{len(biases)}")
    s0 = group.stages[0]
    if tuple(x.shape) != (group.n, s0.h_in, s0.w_in, s0.cin):
        raise ValueError(
            f"input {tuple(x.shape)} does not match the group's stage-0 "
            f"problem {(group.n, s0.h_in, s0.w_in, s0.cin)}")
    for st, w, b in zip(group.stages, weights, biases):
        if tuple(w.shape) != st.weight_shape:
            raise ValueError(
                f"stage {st.name}: weight {tuple(w.shape)} != planned "
                f"{st.weight_shape}")
        if b is not None and tuple(b.shape) != (st.cout,):
            raise ValueError(f"stage {st.name}: bias {tuple(b.shape)} != "
                             f"({st.cout},)")


def _tile_index(start, step, size, count, extent, device):
    """Global indices ``(count, size)`` of an affine tile range, clamped
    into ``[0, extent)``, and where they were inside it."""
    idx = (start + step * torch.arange(count, device=device)[:, None]
           + torch.arange(size, device=device)[None, :])
    return idx.clamp(0, extent - 1), (idx >= 0) & (idx < extent)


def trim_conv2d_fused_plain(x: torch.Tensor, weights, biases, *, group,
                            activation: str | None = "relu") -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's tiles.

    All tiles at once: the stage-0 windows are gathered into ``(N,
    strips, bands, in_rows, in_cols, Cin)`` with zeros outside the image;
    each stage runs ``_stage_conv``'s tap matmuls over the tile in
    ``(ki, kj)`` order, the bias + activation epilogue, ``_stage_pool``'s
    max over shifted strided views, and zeroes the rows and columns
    outside its valid pooled extent; the last stage's tiles are stitched
    into the output.  A wrong range in the geometry changes the result,
    so the CPU tests check the geometry through this function.  bf16
    operands are summed by :func:`~repro_torch.kernels.trim_conv2d.
    fmaf_taps` (the kernel's chain), the epilogue is f32, and each stage
    is rounded to bf16 before its pool, as the JAX kernel casts it into
    its scratch: so the result is bitwise the plain per-layer bf16
    chain's."""
    dev, bf16 = x.device, x.dtype == torch.bfloat16
    s0 = group.stages[0]
    ns, nb = group.n_strips, group.n_bands
    ri, rv = _tile_index(s0.in_start, s0.in_step, s0.in_rows, ns, s0.h_in,
                         dev)
    ci, cv = _tile_index(s0.in_col_start, s0.in_col_step, s0.in_cols, nb,
                         s0.w_in, dev)
    t = x[:, ri][:, :, :, ci].permute(0, 1, 3, 2, 4, 5)
    mask = (rv[:, None, :, None] & cv[None, :, None, :])[None, ..., None]
    t = torch.where(mask, t, torch.zeros((), device=dev))
    for st, w, b in zip(group.stages, weights, biases):
        k, s = st.kernel, st.stride
        rows, cols = st.conv_rows, st.conv_cols
        acc = torch.zeros(t.shape[:3] + (rows, cols, st.cout),
                          dtype=torch.float32, device=dev)
        wf = w.float()
        for ki in range(k):
            for kj in range(k):
                # one (positions, Cin) x (Cin, Cout) product a tap on a
                # contiguous copy, as trim_conv2d_plain takes it: a
                # matmul on the strided view may round differently
                taps = t[:, :, :, ki:ki + (rows - 1) * s + 1:s,
                         kj:kj + (cols - 1) * s + 1:s, :]
                if bf16:
                    fmaf_taps(acc, taps.float(), wf[ki, kj])
                else:
                    acc += (taps.reshape(-1, st.cin) @ wf[ki, kj]) \
                        .reshape(acc.shape)
        y = epilogue(acc, None if b is None else b.float(),
                     activation).to(x.dtype)
        if st.pooled:
            ps, pw = st.pool_stride, st.pool_window
            pr, pc = st.pool_rows, st.pool_cols
            y = torch.stack([
                y[:, :, :, wi:wi + (pr - 1) * ps + 1:ps,
                  wj:wj + (pc - 1) * ps + 1:ps, :]
                for wi in range(pw) for wj in range(pw)]).amax(0)
        _, rv = _tile_index(st.pool_start, st.pool_step, st.pool_rows, ns,
                            st.h_pool, dev)
        _, cv = _tile_index(st.pool_col_start, st.pool_col_step,
                            st.pool_cols, nb, st.w_pool, dev)
        mask = (rv[:, None, :, None] & cv[None, :, None, :])[None, ..., None]
        t = torch.where(mask, y, torch.zeros((), device=dev))
    n, lt = x.shape[0], group.last
    out = t.permute(0, 1, 3, 2, 4, 5).reshape(
        n, ns * group.strip_rows, nb * group.band_cols, lt.cout)
    return out[:, :lt.h_pool, :lt.w_pool].contiguous()


# The layout of kernel_geometry: kHeader and kStageFields of the .cu file
GEOM_HEADER = 9
GEOM_STAGE_FIELDS = 22


def kernel_geometry(group) -> list[int]:
    """The kernel's host geometry (``make_args`` in the ``.cu`` file):
    :data:`GEOM_HEADER` ints (the problem, the tiles and the buffers),
    then :data:`GEOM_STAGE_FIELDS` per stage (its problem, tile ranges,
    C_out tile and channel pitch, those two of the group's
    :attr:`~repro_torch.core.fuse_plan.FusedGroup.layouts`).  The kernel
    derives each stage's threads or warps along C_out and positions a
    thread, and the weight ring's row, from these."""
    s0 = group.stages[0]
    buf0, buf1 = group.buffer_elems
    geom = [group.n, s0.h_in, s0.w_in, s0.cin, group.depth, group.n_strips,
            group.n_bands, buf0, buf1]
    for st, lay in zip(group.stages, group.layouts):
        geom += [st.cin, st.cout, st.kernel, st.stride, st.pool_stride,
                 st.pool_window, st.h_pool, st.w_pool, st.in_rows,
                 st.in_cols, st.pool_rows, st.pool_cols, st.in_start,
                 st.in_step, st.in_col_start, st.in_col_step,
                 st.pool_start, st.pool_step, st.pool_col_start,
                 st.pool_col_step, lay.tile_cout, lay.pitch]
    return geom


def trim_conv2d_fused(x: torch.Tensor, weights, biases, *, group,
                      activation: str | None = "relu") -> torch.Tensor:
    """One fused group, not differentiable: x (N, H, W, Cin0) f32 or bf16,
    per stage ``w (K, K, Cin, Cout)`` and ``b (Cout,)`` or None (zeros), of
    x's dtype.  Returns the last stage's pooled output (N, Hp, Wp, Cout)
    in x's dtype.  The group's tile is planned for one element size
    (:class:`~repro_torch.core.fuse_plan.BF16FusedGroup` for bf16); a
    bf16 group's tile may not fit the f32 kernel, which then raises."""
    _validate(x, weights, biases, group, activation)
    floats = tuple(FLOAT_KERNELS)
    _check_operands(floats, x=x,
                    **{f"w{i}": w for i, w in enumerate(weights)})
    for b in biases:
        if b is not None:
            _check_operands(floats, x=x, bias=b)
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv2d_fused_plain(x, weights, biases, group=group,
                                           activation=activation)
    suffix = FLOAT_KERNELS[x.dtype][1]
    lib = build.library("trim_conv2d_fused")
    y = torch.empty(group.out_shape, dtype=x.dtype, device=x.device)
    ptrs = [p for w, b in zip(weights, biases)
            for p in (w.data_ptr(), None if b is None else b.data_ptr())]
    wb = (ctypes.c_void_p * len(ptrs))(*ptrs)
    geom = kernel_geometry(group)
    geom_arr = (ctypes.c_int * len(geom))(*geom)
    # the bf16 entry takes each stage's route (checked there)
    routes = [] if not suffix else [(ctypes.c_int * group.depth)(
        *(BF16_ROUTES.index(lay.route) for lay in group.layouts))]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"trim_conv2d_fused{suffix}")(
            x.data_ptr(), y.data_ptr(), wb, geom_arr, *routes,
            ACTIVATION_CODES[activation], stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv2d_fused{suffix} kernel launch failed: CUDA error "
            f"{err} ({lib.trim_conv2d_fused_error_string(err).decode()}) for "
            f"group {group.label} (T={group.strip_rows}, "
            f"B={group.band_cols}, n={group.n})")
    LAUNCHES["fused" + suffix] += 1
    return y


def reference_chain(x: torch.Tensor, weights, biases, *, group,
                    activation: str | None = "relu") -> torch.Tensor:
    """The per-layer execution of the same group: ``ops.conv_pool_chain``
    (the carry kernel, 'same' pads virtual, and a separate max-pool per
    stage) — the differential oracle of the fused kernel and the
    recompute path of its backward."""
    steps = [(st.stride, st.padding, 1, st.pool_stride, st.pool_window)
             for st in group.stages]
    return ops.conv_pool_chain(x, weights, biases, steps,
                               activation=activation)


class _FusedGroupFn(torch.autograd.Function):
    """Fused forward, per-layer recompute backward (``_fused_vjp_fwd`` /
    ``_fused_vjp_bwd`` of ``repro/kernels/trim_conv2d_fused.py``)."""

    @staticmethod
    def forward(ctx, cfg, x, *params):
        group, activation = cfg
        d = group.depth
        ctx.cfg = cfg
        ctx.save_for_backward(x, *params)
        return trim_conv2d_fused(x, list(params[:d]), list(params[d:]),
                                 group=group, activation=activation)

    @staticmethod
    def backward(ctx, gy):
        group, activation = ctx.cfg
        d = group.depth
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, needs)]
            out = reference_chain(leaves[0], leaves[1:1 + d],
                                  leaves[1 + d:], group=group,
                                  activation=activation)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, gy))
        return (None,) + tuple(
            next(grads) if t is not None and t.requires_grad else None
            for t in leaves)


def fused_group_apply(x: torch.Tensor, weights, biases, *, group,
                      activation: str | None = "relu") -> torch.Tensor:
    """Run one fused residency group: ``x (N, H, W, Cin)`` through the
    group's conv→[pool] stages in one launch.  ``weights``/``biases`` are
    per-stage lists (``(K, K, Cin, Cout)`` and ``(Cout,)``; a ``None``
    bias is zeros).  Under grad, the backward recomputes the per-layer
    chain, so cotangents run on the carry and weight-gradient kernels."""
    operands = [x, *weights, *(b for b in biases if b is not None)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _FusedGroupFn.apply((group, activation), x, *weights,
                                   *biases)
    return trim_conv2d_fused(x, weights, biases, group=group,
                             activation=activation)
