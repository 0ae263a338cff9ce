"""3D-TrIM convolution and its two cotangents: the wrappers of the Hopper
kernels and their plain PyTorch versions (the counterpart of
``repro/kernels/trim_conv2d.py``, f32).

* ``trim_conv2d`` — the forward conv.  On a CUDA tensor it launches the
  hand-written kernel of ``csrc/trim_conv2d.cu`` for the chosen dataflow,
  ``"carry"`` (the paper's shadow registers) or ``"halo"`` (TrIM's
  over-fetch); on a CPU tensor it runs :func:`trim_conv2d_plain`.
* ``trim_conv2d_input_grad`` — dx, itself a TrIM conv: the stride-dilated
  cotangent through the same forward kernel, with the flipped, transposed
  weights and the edge pads applied virtually.
* ``trim_conv2d_weight_grad`` — dw through the kernel of
  ``csrc/trim_conv2d_wgrad.cu``; :func:`trim_conv2d_weight_grad_plain` on a
  CPU tensor.

A wrapper given a CUDA tensor launches its kernel or raises; nothing falls
back.  The wrappers are not differentiable themselves (their results never
require grad): ``kernels/ops.py`` wraps them in a ``torch.autograd.Function``.
"""

from __future__ import annotations

import torch

from repro_torch.core.conv_plan import (DATAFLOWS, ConvPlan, WeightGradPlan,
                                        input_grad_geometry, normalize_pad)
from repro_torch.kernels import build
from repro_torch.kernels.ref import ACTIVATIONS, epilogue, pad_nhwc

ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}

# Kernel launches: each successful launch of a forward dataflow adds one to
# its key (input gradients included: they run the forward kernel), each
# weight-gradient call one to "wgrad", each fused-group launch
# (``kernels/trim_conv2d_fused.py``) one to "fused".
LAUNCHES = {"carry": 0, "halo": 0, "wgrad": 0, "fused": 0}


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


def _check_operands(**tensors) -> None:
    """Every operand f32, contiguous and on the first one's CPU or CUDA
    device."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type not in ("cpu", "cuda") or t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the first operand "
                             f"on {first.device}: all operands must share "
                             "a CPU or CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; this kernel takes "
                            "float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4 and name != "bias":
            raise ValueError(f"{name} must be 4-D (NHWC activations, "
                             f"(K, K, Cin/g, Cout) weights); got "
                             f"{tuple(t.shape)}")


def _check(x, w, bias, activation, dataflow) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"choose from {sorted(ACTIVATIONS, key=str)}")
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}; choose from "
                         f"{DATAFLOWS}")
    if bias is None:
        _check_operands(x=x, w=w)
    else:
        _check_operands(x=x, w=w, bias=bias)
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
        with torch.no_grad():
            return trim_conv2d_plain(x, w, bias, stride=stride,
                                     pad=plan.pads, groups=groups,
                                     activation=activation)
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
            plan.tile_cout, plan.strips_per_segment, plan.ring_rows,
            plan.cin_stride, ACTIVATION_CODES[activation], stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv2d {dataflow} kernel launch failed: CUDA error {err} "
            f"({lib.trim_conv2d_error_string(err).decode()}) for {plan}")
    LAUNCHES[dataflow] += 1
    return y


# ---------------------------------------------------------------------------
# Cotangents
# ---------------------------------------------------------------------------

def transpose_conv_weights(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Flip the spatial taps and swap the channel roles per group:
    ``(K, K, Cin/g, Cout) -> (K, K, Cout/g, Cin)`` with the output (= the
    forward input) channels group-major — the weights of the
    input-gradient conv (``repro/kernels/trim_conv2d.py:384``)."""
    kh, kw, cin_pg, cout = w.shape
    wt = w.flip(0, 1).reshape(kh, kw, cin_pg, groups, cout // groups)
    return wt.permute(0, 1, 4, 3, 2).reshape(
        kh, kw, cout // groups, groups * cin_pg).contiguous()


def dilate_cotangent(g: torch.Tensor, stride: int) -> torch.Tensor:
    """Zeros between the cotangent's rows and columns (``stride - 1`` of
    each); the cotangent itself at stride 1."""
    if stride == 1:
        return g
    n, ho, wo, c = g.shape
    gd = g.new_zeros((n, (ho - 1) * stride + 1, (wo - 1) * stride + 1, c))
    gd[:, ::stride, ::stride, :] = g
    return gd


def trim_conv2d_input_grad(g: torch.Tensor, w: torch.Tensor, *,
                           x_shape, stride: int = 1, pad=0, groups: int = 1,
                           dataflow: str = "carry") -> torch.Tensor:
    """Input cotangent of :func:`trim_conv2d` — itself a TrIM conv
    (``repro/kernels/trim_conv2d.py:398``).

    g: (N, H_out, W_out, Cout) output cotangent; w: (K, K, Cin/g, Cout) the
    forward weights; ``x_shape``, ``stride``, ``pad`` and ``groups``
    describe the FORWARD problem (``pad`` an int or ``((top, bottom),
    (left, right))``).  Only the stride dilation is materialised; the edge
    pads of :func:`~repro_torch.core.conv_plan.input_grad_geometry` are the
    forward kernel's virtual pads, and the conv runs at stride 1 with
    :func:`transpose_conv_weights` through the ``dataflow`` kernel (its
    launch counts under that key).  Returns dx with shape ``x_shape``.
    """
    _check_operands(g=g, w=w)
    geo = input_grad_geometry(tuple(x_shape), tuple(w.shape), stride=stride,
                              pad=pad, groups=groups)
    if tuple(g.shape) != (x_shape[0], geo["h_out"], geo["w_out"],
                          w.shape[3]):
        raise ValueError(f"cotangent shape {tuple(g.shape)} does not match "
                         f"the forward geometry of x={tuple(x_shape)}, "
                         f"w={tuple(w.shape)}, stride={stride}, pad={pad}")
    return trim_conv2d(dilate_cotangent(g, stride),
                       transpose_conv_weights(w, groups), stride=1,
                       pad=(geo["pad_h"], geo["pad_w"]), groups=groups,
                       dataflow=dataflow)


def trim_conv2d_weight_grad_plain(x: torch.Tensor, g: torch.Tensor, *,
                                  kernel_size: int, stride: int = 1, pad=0,
                                  groups: int = 1) -> torch.Tensor:
    """The weight-gradient kernel's function in plain PyTorch, as
    ``_weight_grad_kernel``'s tap loop computes it
    (``repro/kernels/trim_conv2d.py:429``): for each tap, the shifted
    strided view of the padded input contracted with the cotangent over
    (n, oh, ow) by ``einsum``, accumulated in f32."""
    k, s = kernel_size, stride
    xp = pad_nhwc(x, normalize_pad(pad))
    n, ho, wo, cout = g.shape
    cin_pg = x.shape[3] // groups
    gg = g.reshape(-1, groups, cout // groups)
    dw = torch.empty((k, k, cin_pg, groups, cout // groups),
                     dtype=torch.float32, device=x.device)
    for ki in range(k):
        for kj in range(k):
            rows = xp[:, ki:ki + (ho - 1) * s + 1:s,
                      kj:kj + (wo - 1) * s + 1:s, :]
            dw[ki, kj] = torch.einsum(
                "mgc,mgo->cgo", rows.reshape(-1, groups, cin_pg), gg)
    return dw.reshape(k, k, cin_pg, cout)


def trim_conv2d_weight_grad(x: torch.Tensor, g: torch.Tensor, *,
                            kernel_size: int, stride: int = 1, pad=0,
                            groups: int = 1,
                            tile_go: int | None = None) -> torch.Tensor:
    """Weight cotangent of :func:`trim_conv2d`
    (``repro/kernels/trim_conv2d.py:458``).

    x: (N, H, W, Cin) the forward input; g: (N, H_out, W_out, Cout) the
    output cotangent; ``kernel_size``, ``stride``, ``pad`` and ``groups``
    as in the forward call (the padding is virtual: no padded copy of
    ``x`` is made).  ``tile_go`` overrides the plan's chunk height.
    Returns dw (K, K, Cin/groups, Cout) f32, bitwise the same on every
    launch with the same inputs (no float atomics).
    """
    _check_operands(x=x, g=g)
    k = kernel_size
    plan = WeightGradPlan.build(tuple(x.shape),
                                (k, k, x.shape[3] // groups, g.shape[3]),
                                stride=stride, pad=pad, groups=groups,
                                tile_go=tile_go)
    if tuple(g.shape) != (plan.n, plan.h_out, plan.w_out, plan.cout):
        raise ValueError(f"cotangent shape {tuple(g.shape)} does not match "
                         f"the forward geometry of x={tuple(x.shape)}, "
                         f"K={k}, stride={stride}, pad={pad}")
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv2d_weight_grad_plain(
                x, g, kernel_size=k, stride=stride, pad=plan.pads,
                groups=groups)
    lib = build.library("trim_conv2d_wgrad")
    dw = torch.empty(plan.dw_shape, dtype=torch.float32, device=x.device)
    ws = dw if plan.chunks == 1 else torch.empty(
        (plan.chunks * plan.dw_elems,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.trim_conv2d_wgrad(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(),
            plan.n, plan.h, plan.w, plan.cin, plan.cout, plan.k,
            plan.stride, plan.pads[0][0], plan.pads[1][0], plan.groups,
            plan.h_out, plan.w_out, plan.tile_go,
            int(plan.route == "depthwise"), plan.tile_cout, plan.blocks,
            stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv2d_wgrad kernel launch failed: CUDA error {err} "
            f"({lib.trim_conv2d_wgrad_error_string(err).decode()}) for "
            f"{plan}")
    LAUNCHES["wgrad"] += 1
    return dw
