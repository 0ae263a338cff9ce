"""3D-TrIM convolution: the wrapper of the Hopper kernels and their plain
PyTorch version.

``trim_conv2d`` is the counterpart of ``repro.kernels.trim_conv2d.
trim_conv2d`` (forward, f32).  On a CUDA tensor it launches the hand-written
kernel of ``csrc/trim_conv2d.cu`` for the chosen dataflow — ``"carry"`` (the
paper's shadow registers) or ``"halo"`` (TrIM's over-fetch) — or raises;
on a CPU tensor it runs :func:`trim_conv2d_plain`.  Nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.core.conv_plan import DATAFLOWS, ConvPlan, normalize_pad
from repro_torch.kernels import build
from repro_torch.kernels.ref import ACTIVATIONS, epilogue, pad_nhwc

ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}

# Kernel launches per dataflow: each successful launch adds one.
LAUNCHES = {"carry": 0, "halo": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def trim_conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None, *, stride: int = 1,
                      pad=0, groups: int = 1,
                      activation: str | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``_tap_matmuls``
    (``repro/kernels/trim_conv2d.py:82``) as K^2 shifted strided views of
    the padded input times ``w[ki, kj]``, accumulated in f32 in
    ``(ki, kj)`` order, then ``_epilogue_store``'s bias and activation."""
    k, s = w.shape[0], stride
    xp = pad_nhwc(x, normalize_pad(pad))
    n, hp, wp, cin = xp.shape
    cin_pg, cout = w.shape[2], w.shape[3]
    h_out, w_out = (hp - k) // s + 1, (wp - k) // s + 1
    acc = torch.zeros((n * h_out * w_out, groups, cout // groups),
                      dtype=torch.float32, device=x.device)
    for ki in range(k):
        for kj in range(k):
            rows = xp[:, ki:ki + (h_out - 1) * s + 1:s,
                      kj:kj + (w_out - 1) * s + 1:s, :]
            taps = w[ki, kj].reshape(cin_pg, groups, cout // groups)
            acc += torch.einsum("mgc,cgo->mgo",
                                rows.reshape(-1, groups, cin_pg), taps)
    return epilogue(acc.reshape(n, h_out, w_out, cout), bias, activation)


def _check(x, w, bias, activation, dataflow) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"choose from {sorted(ACTIVATIONS, key=str)}")
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}; choose from "
                         f"{DATAFLOWS}")
    tensors = {"x": x, "w": w} if bias is None else \
        {"x": x, "w": w, "bias": bias}
    for name, t in tensors.items():
        if t.device.type not in ("cpu", "cuda") or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}: "
                             "all operands must share a CPU or CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; this kernel takes "
                            "float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "trim_conv2d has no backward yet (ROADMAP: training "
                "slice); call it under torch.no_grad()")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin) and w (K, K, Cin/g, "
                         f"Cout); got {tuple(x.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"bias must be ({w.shape[3]},), got "
                         f"{tuple(bias.shape)}")


def trim_conv2d(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None, *, stride: int = 1,
                pad=0, groups: int = 1, activation: str | None = None,
                dataflow: str = "carry", tile_h: int | None = None,
                tile_cout: int | None = None) -> torch.Tensor:
    """Strided (grouped) 2D convolution with fused bias + activation.

    x: (N, H, W, Cin) f32; w: (K, K, Cin/groups, Cout) f32; bias: (Cout,)
    or None.  ``pad`` is an int (symmetric) or ``((top, bottom), (left,
    right))`` zero padding, applied inside the kernel.  ``activation`` is
    one of ``None | "relu" | "gelu" | "silu"``.  ``tile_h`` / ``tile_cout``
    override the plan's strip height (input rows) and C_out tile.
    Returns (N, H_out, W_out, Cout) f32.
    """
    _check(x, w, bias, activation, dataflow)
    plan = ConvPlan.build(tuple(x.shape), tuple(w.shape), stride=stride,
                          pad=pad, groups=groups, tile_h=tile_h,
                          tile_cout=tile_cout, dataflow=dataflow)
    if x.device.type == "cpu":
        return trim_conv2d_plain(x, w, bias, stride=stride, pad=plan.pads,
                                 groups=groups, activation=activation)
    lib = build.library("trim_conv2d")
    launch = lib.trim_conv2d_carry if dataflow == "carry" \
        else lib.trim_conv2d_halo
    y = torch.empty(plan.out_shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            plan.n, plan.h, plan.w, plan.cin, plan.cout, plan.k,
            plan.stride, plan.pads[0][0], plan.pads[1][0], plan.groups,
            plan.h_out, plan.w_out, plan.th_out, plan.tile_w,
            plan.tile_cout, plan.threads_cout, ACTIVATION_CODES[activation],
            stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv2d {dataflow} kernel launch failed: CUDA error {err} "
            f"({lib.trim_conv2d_error_string(err).decode()}) for {plan}")
    LAUNCHES[dataflow] += 1
    return y
