"""Causal depthwise conv1d (the Mamba / RG-LRU temporal conv): the wrapper
of the Hopper kernel and its plain PyTorch version (the counterpart of
``repro/kernels/trim_conv1d.py``, f32).

``trim_conv1d`` launches the hand-written kernel of ``csrc/trim_conv1d.cu``
on CUDA tensors and runs :func:`trim_conv1d_plain` on CPU tensors; nothing
falls back.  Both compute ``_kernel`` (``repro/kernels/trim_conv1d.py:29``):
``y[b, t, d] = sum_{i < K} x[b, t-K+1+i, d] * w[i, d]`` with zero left
padding, summed from 0 in the order i = 0..K-1 with every product rounded
before its add, so the kernel, its plain version and
``ref.depthwise_conv1d`` agree bit for bit.  The geometry (runs of
``tile_l`` steps, ``tile_d`` channels a block) is ``core.conv_plan.
Conv1dPlan``'s.  The input may be a strided view with a contiguous channel
axis (the mixer's half of the in-projection); it is read in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.conv_plan import Conv1dPlan
from repro_torch.kernels import build

# Kernel launches: each successful launch adds one.
LAUNCHES = {"trim_conv1d": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    for name, t in (("x", x), ("w", w)):
        if t.device.type not in ("cpu", "cuda") or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}: "
                             "x and w must share a CPU or CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; this kernel takes "
                             "float32 only (bf16 is ROADMAP Queue 1 item 2g)")
    if x.dim() == 3 and x.stride(2) != 1:
        raise ValueError(f"x must have a contiguous channel axis; got "
                         f"strides {x.stride()}")


def trim_conv1d_plain(x: torch.Tensor, w: torch.Tensor, *,
                      tile_l: int | None = None) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: the sequence cut into runs
    of the plan's ``tile_l`` steps, each run's window holding its ``K-1``
    predecessors (the halo; zeros before t = 0), and the taps summed over
    every run at once in the kernel's order.  x: (B, L, D); w: (K, D)."""
    plan = Conv1dPlan.build(tuple(x.shape), tuple(w.shape), tile_l=tile_l)
    b, length, d = x.shape
    k, tl = plan.k, plan.tile_l
    padded = plan.runs * tl
    xp = F.pad(x, (0, 0, k - 1, padded - length))
    win = xp.unfold(1, tl + k - 1, tl)            # (B, runs, D, tl + K - 1)
    acc = 0
    for i in range(k):
        acc = acc + win[..., i:i + tl] * w[i][:, None]
    y = acc.permute(0, 1, 3, 2).reshape(b, padded, d)
    return y[:, :length].contiguous()


def trim_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                tile_l: int | None = None) -> torch.Tensor:
    """x: (B, L, D) f32 with a contiguous channel axis (other strides are
    read as they are); w: (K, D) f32, K >= 2 -> y (B, L, D).

    On CUDA tensors, one launch of the hand-written kernel (counted in
    ``LAUNCHES``); on CPU tensors, :func:`trim_conv1d_plain`.  Raises
    ``ValueError`` for what the kernel cannot take: another dtype, mixed
    devices, K < 2, or an empty B, L or D.  ``tile_l`` left as
    ``None`` takes ``Conv1dPlan.build``'s choice.  It has no backward:
    under autograd, with x or w requiring grad, it raises
    ``NotImplementedError`` rather than give a result no gradient reaches.
    """
    _check(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "trim_conv1d has no backward (ROADMAP Queue 1 item 2f, ssm and "
            "hybrid training); call it under torch.no_grad() or on "
            "detached tensors")
    plan = Conv1dPlan.build(tuple(x.shape), tuple(w.shape), tile_l=tile_l)
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv1d_plain(x, w, tile_l=plan.tile_l)
    b, length, d = x.shape
    wc = w.contiguous()
    y = torch.empty((b, length, d), dtype=torch.float32, device=x.device)
    lib = build.library("trim_conv1d")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.trim_conv1d_f32(
            x.data_ptr(), wc.data_ptr(), y.data_ptr(), b, length, d, plan.k,
            x.stride(0), x.stride(1), y.stride(0), y.stride(1), plan.tile_l,
            plan.tile_d, stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv1d kernel launch failed: CUDA error {err} "
            f"({lib.trim_conv1d_error_string(err).decode()}) for x "
            f"{tuple(x.shape)} strides {x.stride()}, K={plan.k}, "
            f"tile_l={plan.tile_l}, tile_d={plan.tile_d}")
    LAUNCHES["trim_conv1d"] += 1
    return y
