"""3D-TrIM convolution and its two cotangents: the wrappers of the Hopper
kernels and their plain PyTorch versions (the counterpart of
``repro/kernels/trim_conv2d.py``, f32 and bf16).

* ``trim_conv2d`` — the forward conv.  On a CUDA tensor it launches the
  hand-written kernel of ``csrc/trim_conv2d.cu`` for the chosen dataflow,
  ``"carry"`` (the paper's shadow registers) or ``"halo"`` (TrIM's
  over-fetch), in f32 or, on bf16 operands, its bf16 entries
  (``trim_conv2d_carry_bf16`` / ``trim_conv2d_halo_bf16``: products
  exact, one f32 sum, one rounding to bf16 at the store, as JAX's
  ``_tap_matmuls`` and ``_epilogue_store`` on bf16) on the plan's route,
  :func:`~repro_torch.core.conv_plan.bf16_route` of the layer: ``"mma"``
  (Cin/g a multiple of 16) sums on the bf16 tensor cores in the one
  k-order of ``csrc/bf16_mma.cuh``, ``"ffma"`` (the rest) takes the f32
  kernel's fmaf chain; on a CPU tensor it runs :func:`trim_conv2d_plain`,
  the fmaf chain, which the ``mma`` route no longer equals bit for bit
  (the tensor core adds in its own order; ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py`` hold it against a float64 oracle).
* ``trim_conv2d_input_grad`` — dx, itself a TrIM conv: the stride-dilated
  cotangent through the same forward kernel (its bf16 instance on bf16
  operands), with the flipped, transposed weights and the edge pads
  applied virtually.
* ``trim_conv2d_weight_grad`` — dw through the kernel of
  ``csrc/trim_conv2d_wgrad.cu`` (``trim_conv2d_wgrad``, or on bf16
  operands ``trim_conv2d_wgrad_bf16`` on the plan's route,
  :func:`~repro_torch.core.conv_plan.wgrad_route` of the layer: ``"mma"``
  (Cin/g a multiple of 16, Cout/g of 8) sums on the bf16 tensor cores in
  the order stated atop the ``.cu``; ``"gemm"`` / ``"depthwise"`` widen
  the operands into the f32 kernel's sums, so their f32 dw is bitwise the
  f32 entry's on the widened operands); f32 dw either way, which the
  caller rounds once; :func:`trim_conv2d_weight_grad_plain` on a CPU
  tensor, the f32 einsum, which route mma does not equal bit for bit.
* ``trim_conv2d_q8`` — the int8 route of the forward conv (the JAX
  ``trim_conv2d`` with a ``scale``): int8 operands, an exact int32
  accumulator and the dequant epilogue ``(acc + bias_q) * scale``, f32
  out, through the kernel of ``csrc/trim_conv2d_q8.cu`` (carry or halo);
  :func:`trim_conv2d_q8_plain` on a CPU tensor.  Inference only.
* ``hbm_traffic_model`` — the forward schedule's device-memory bytes in
  the paper's accounting modes (``ConvPlan.hbm_bytes(mode)``).

A wrapper given a CUDA tensor launches its kernel or raises; nothing falls
back.  The wrappers are not differentiable themselves (their results never
require grad): ``kernels/ops.py`` wraps them in a ``torch.autograd.Function``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.conv_plan import (BF16_ROUTES, DATAFLOWS, Q8_ROUTES,
                                        WGRAD_ROUTES, ConvPlan,
                                        WeightGradPlan, input_grad_geometry,
                                        normalize_pad, q8_kpad, q8_tap_bytes)
from repro_torch.kernels import build
from repro_torch.kernels.ref import (ACTIVATIONS, epilogue,
                                     exact_int_products, pad_nhwc)

ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}

# Kernel launches: each successful launch of a forward dataflow adds one to
# its key (input gradients included: they run the forward kernel; the bf16
# instance to "carry_bf16" or "halo_bf16"), each weight-gradient call one
# to "wgrad" (bf16: "wgrad_bf16"), each fused-group launch
# (``kernels/trim_conv2d_fused.py``) one to "fused" (bf16: "fused_bf16"),
# each launch of the int8 kernel one to "q8_carry" or "q8_halo".
LAUNCHES = {"carry": 0, "halo": 0, "wgrad": 0, "fused": 0, "q8_carry": 0,
            "q8_halo": 0, "carry_bf16": 0, "halo_bf16": 0, "fused_bf16": 0,
            "wgrad_bf16": 0}
# the float dtypes of the forward, fused and weight-gradient kernels, with
# their plan's dtype_bytes and the suffix of their C entries and launch
# keys
FLOAT_KERNELS = {torch.float32: (4, ""), torch.bfloat16: (2, "_bf16")}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def fmaf_taps(acc: torch.Tensor, rows: torch.Tensor,
              taps: torch.Tensor) -> None:
    """``acc += rows @ taps`` as the bf16 kernels take it: one f32 multiply
    and add an input channel, in channel order, in place.  ``rows`` (...,
    Cin) and ``taps`` (Cin, ...) hold widened bf16 values, whose products
    are exact in f32, so each step rounds once, as the kernel's fmaf does:
    over the (ki, kj) taps in order this is the kernel's chain, bit for
    bit, and a row's result depends on nothing but the row."""
    for ci in range(rows.shape[-1]):
        acc.addcmul_(rows[..., ci:ci + 1], taps[ci])


def trim_conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None, *, stride: int = 1,
                      pad=0, groups: int = 1,
                      activation: str | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``_tap_matmuls``
    (``repro/kernels/trim_conv2d.py:82``) as KH x KW shifted strided views
    of the padded input times ``w[ki, kj]``, accumulated in f32 in
    ``(ki, kj)`` order, then ``_epilogue_store``'s bias and activation.
    bf16 operands are widened and summed by :func:`fmaf_taps` (the
    kernel's chain); bias and activation are f32 and the result is
    rounded to bf16 once."""
    kh, kw, cin_pg, cout = w.shape
    s = stride
    bf16 = x.dtype == torch.bfloat16
    xp = pad_nhwc(x, normalize_pad(pad)).float()
    w = w.float()
    n, hp, wp, cin = xp.shape
    h_out, w_out = (hp - kh) // s + 1, (wp - kw) // s + 1
    acc = torch.zeros((n * h_out * w_out, groups, cout // groups),
                      dtype=torch.float32, device=x.device)
    for ki in range(kh):
        for kj in range(kw):
            rows = xp[:, ki:ki + (h_out - 1) * s + 1:s,
                      kj:kj + (w_out - 1) * s + 1:s, :]
            rows = rows.reshape(-1, groups, cin_pg)
            taps = w[ki, kj].reshape(cin_pg, groups, cout // groups)
            if bf16:
                fmaf_taps(acc, rows, taps)
            else:
                acc += torch.einsum("mgc,cgo->mgo", rows, taps)
    y = epilogue(acc.reshape(n, h_out, w_out, cout),
                 None if bias is None else bias.float(), activation)
    return y.to(x.dtype)


def _check_operands(dtypes=(torch.float32,), **tensors) -> None:
    """Every operand of one dtype of ``dtypes``, contiguous and on the
    first one's CPU or CUDA device."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type not in ("cpu", "cuda") or t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the first operand "
                             f"on {first.device}: all operands must share "
                             "a CPU or CUDA device")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.")
                                for d in dtypes)
            raise TypeError(f"{name} is {t.dtype}; this kernel takes "
                            f"{names} (int8 operands: trim_conv2d_q8)")
        if t.dtype != first.dtype:
            raise TypeError(f"{name} is {t.dtype} but the first operand is "
                            f"{first.dtype}: mixed float dtypes; cast every "
                            "operand to one")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4 and name != "bias":
            raise ValueError(f"{name} must be 4-D (NHWC activations, "
                             f"(KH, KW, Cin/g, Cout) weights); got "
                             f"{tuple(t.shape)}")


def _check(x, w, bias, activation, dataflow) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"choose from {sorted(ACTIVATIONS, key=str)}")
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}; choose from "
                         f"{DATAFLOWS}")
    operands = dict(x=x, w=w) if bias is None else dict(x=x, w=w, bias=bias)
    _check_operands(tuple(FLOAT_KERNELS), **operands)
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"bias must be ({w.shape[3]},), got "
                         f"{tuple(bias.shape)}")


def trim_conv2d(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None, *, stride: int = 1,
                pad=0, groups: int = 1, activation: str | None = None,
                dataflow: str = "carry", tile_h: int | None = None,
                tile_cout: int | None = None) -> torch.Tensor:
    """Strided (grouped) 2D convolution with fused bias + activation.

    x: (N, H, W, Cin) f32 or bf16; w: (KH, KW, Cin/groups, Cout) of x's
    dtype (a square kernel or a rectangular sub-kernel of the kernel
    tiling); bias: (Cout,) of x's dtype, or None.  ``pad`` is an int
    (symmetric) or ``((top, bottom), (left, right))`` zero padding,
    applied inside the kernel.  ``activation`` is
    one of ``None | "relu" | "gelu" | "silu"``.  ``tile_h`` / ``tile_cout``
    override the plan's strip height (input rows) and C_out tile (the
    plan at bf16's 2 bytes an element for bf16).  Returns (N, H_out,
    W_out, Cout) in x's dtype.
    """
    _check(x, w, bias, activation, dataflow)
    dtype_bytes, suffix = FLOAT_KERNELS[x.dtype]
    plan = ConvPlan.build(tuple(x.shape), tuple(w.shape), stride=stride,
                          pad=pad, groups=groups, tile_h=tile_h,
                          tile_cout=tile_cout, dataflow=dataflow,
                          dtype_bytes=dtype_bytes)
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv2d_plain(x, w, bias, stride=stride,
                                     pad=plan.pads, groups=groups,
                                     activation=activation)
    lib = build.library("trim_conv2d")
    launch = getattr(lib, f"trim_conv2d_{dataflow}{suffix}")
    # the bf16 entries take the plan's route and warps (checked there)
    route = [BF16_ROUTES.index(plan.bf16_route), plan.warps_n,
             plan.m_frags] if suffix else []
    y = torch.empty(plan.out_shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            plan.n, plan.h, plan.w, plan.cin, plan.cout, plan.kh, plan.kw,
            plan.stride, plan.pads[0][0], plan.pads[1][0], plan.groups,
            plan.h_out, plan.w_out, plan.th_out, plan.tile_w,
            plan.tile_cout, plan.strips_per_segment, plan.ring_rows,
            plan.cin_stride, ACTIVATION_CODES[activation], *route, stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv2d_{dataflow}{suffix} kernel launch failed: CUDA "
            f"error {err} ({lib.trim_conv2d_error_string(err).decode()}) "
            f"for {plan}")
    LAUNCHES[dataflow + suffix] += 1
    return y


# ---------------------------------------------------------------------------
# Cotangents
# ---------------------------------------------------------------------------

def transpose_conv_weights(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Flip the spatial taps and swap the channel roles per group:
    ``(KH, KW, Cin/g, Cout) -> (KH, KW, Cout/g, Cin)`` with the output (= the
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
                           dataflow: str = "carry", tile_h: int | None = None,
                           tile_cout: int | None = None) -> torch.Tensor:
    """Input cotangent of :func:`trim_conv2d` — itself a TrIM conv
    (``repro/kernels/trim_conv2d.py:398``).

    g: (N, H_out, W_out, Cout) output cotangent; w: (KH, KW, Cin/g, Cout)
    the forward weights; ``x_shape``, ``stride``, ``pad`` and ``groups``
    describe the FORWARD problem (``pad`` an int or ``((top, bottom),
    (left, right))``); g and w f32, or bf16 (dx then bf16, rounded once
    from its f32 sum).  Only the stride dilation is materialised; the edge
    pads of :func:`~repro_torch.core.conv_plan.input_grad_geometry` are the
    forward kernel's virtual pads, and the conv runs at stride 1 with
    :func:`transpose_conv_weights` through the ``dataflow`` kernel (its
    launch counts under that key), ``tile_h`` / ``tile_cout`` its plan's
    knobs.  Returns dx with shape ``x_shape``.
    """
    _check_operands(tuple(FLOAT_KERNELS), g=g, w=w)
    gd, wt, pads = _input_grad_layout(g, w, x_shape, stride, pad, groups)
    return trim_conv2d(gd, wt, stride=1, pad=pads, groups=groups,
                       dataflow=dataflow, tile_h=tile_h, tile_cout=tile_cout)


def _input_grad_layout(g, w, x_shape, stride, pad, groups):
    """The operands of :func:`trim_conv2d_input_grad`'s stride-1 conv:
    the stride-dilated cotangent, the transposed weights and the edge
    pads of :func:`~repro_torch.core.conv_plan.input_grad_geometry`."""
    geo = input_grad_geometry(tuple(x_shape), tuple(w.shape), stride=stride,
                              pad=pad, groups=groups)
    if tuple(g.shape) != (x_shape[0], geo["h_out"], geo["w_out"],
                          w.shape[3]):
        raise ValueError(f"cotangent shape {tuple(g.shape)} does not match "
                         f"the forward geometry of x={tuple(x_shape)}, "
                         f"w={tuple(w.shape)}, stride={stride}, pad={pad}")
    return (dilate_cotangent(g, stride), transpose_conv_weights(w, groups),
            (geo["pad_h"], geo["pad_w"]))


def trim_conv2d_input_grad_plain(g: torch.Tensor, w: torch.Tensor, *,
                                 x_shape, stride: int = 1, pad=0,
                                 groups: int = 1) -> torch.Tensor:
    """:func:`trim_conv2d_input_grad`'s function in plain PyTorch: the
    forward's plain version on the same dilated cotangent, transposed
    weights and edge pads."""
    gd, wt, pads = _input_grad_layout(g, w, x_shape, stride, pad, groups)
    return trim_conv2d_plain(gd, wt, pad=pads, groups=groups)


def _kernel_extents(kernel_size) -> tuple[int, int]:
    """``(KH, KW)`` of a ``kernel_size`` given as an int or a pair."""
    if isinstance(kernel_size, int):
        return kernel_size, kernel_size
    kh, kw = kernel_size
    return int(kh), int(kw)


def trim_conv2d_weight_grad_plain(x: torch.Tensor, g: torch.Tensor, *,
                                  kernel_size, stride: int = 1, pad=0,
                                  groups: int = 1) -> torch.Tensor:
    """The weight-gradient kernel's function in plain PyTorch, as
    ``_weight_grad_kernel``'s tap loop computes it
    (``repro/kernels/trim_conv2d.py:429``): for each tap, the shifted
    strided view of the padded input contracted with the cotangent over
    (n, oh, ow) by ``einsum``, accumulated in f32.  bf16 operands are
    widened to f32 first (their products are exact in f32, as JAX's
    ``preferred_element_type`` sums them).  Returns f32 dw whatever the
    operands' dtype.  ``kernel_size`` is K or ``(KH, KW)``."""
    (kh, kw), s = _kernel_extents(kernel_size), stride
    x, g = x.float(), g.float()
    xp = pad_nhwc(x, normalize_pad(pad))
    n, ho, wo, cout = g.shape
    cin_pg = x.shape[3] // groups
    gg = g.reshape(-1, groups, cout // groups)
    dw = torch.empty((kh, kw, cin_pg, groups, cout // groups),
                     dtype=torch.float32, device=x.device)
    for ki in range(kh):
        for kj in range(kw):
            rows = xp[:, ki:ki + (ho - 1) * s + 1:s,
                      kj:kj + (wo - 1) * s + 1:s, :]
            dw[ki, kj] = torch.einsum(
                "mgc,mgo->cgo", rows.reshape(-1, groups, cin_pg), gg)
    return dw.reshape(kh, kw, cin_pg, cout)


def trim_conv2d_weight_grad(x: torch.Tensor, g: torch.Tensor, *,
                            kernel_size, stride: int = 1, pad=0,
                            groups: int = 1, tile_go: int | None = None
                            ) -> torch.Tensor:
    """Weight cotangent of :func:`trim_conv2d`
    (``repro/kernels/trim_conv2d.py:458``).

    x: (N, H, W, Cin) the forward input; g: (N, H_out, W_out, Cout) the
    output cotangent, both f32 or both bf16; ``kernel_size`` (K, or
    ``(KH, KW)`` for a rectangular sub-kernel), ``stride``, ``pad`` and
    ``groups`` as in the forward call (the padding is virtual: no padded
    copy of ``x`` is made).  ``tile_go`` overrides the plan's chunk
    height.  Returns the f32 sums dw (KH, KW, Cin/groups, Cout) whatever
    the operands' dtype; the caller rounds them once, as
    ``_TrimConv2dFn.backward`` rounds dw to w's dtype like JAX's
    ``_conv_grads`` (``repro/kernels/ops.py:306``; JAX's wrapper casts
    its f32 block to x's dtype at ``repro/kernels/trim_conv2d.py:542``,
    the same single rounding).  Bitwise the same on every launch with the
    same inputs (no float atomics).
    """
    _check_operands(tuple(FLOAT_KERNELS), x=x, g=g)
    dtype_bytes, suffix = FLOAT_KERNELS[x.dtype]
    kh, kw = _kernel_extents(kernel_size)
    plan = WeightGradPlan.build(tuple(x.shape),
                                (kh, kw, x.shape[3] // groups, g.shape[3]),
                                stride=stride, pad=pad, groups=groups,
                                tile_go=tile_go, dtype_bytes=dtype_bytes)
    if tuple(g.shape) != (plan.n, plan.h_out, plan.w_out, plan.cout):
        raise ValueError(f"cotangent shape {tuple(g.shape)} does not match "
                         f"the forward geometry of x={tuple(x.shape)}, "
                         f"K={kh}x{kw}, stride={stride}, pad={pad}")
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv2d_weight_grad_plain(
                x, g, kernel_size=(kh, kw), stride=stride, pad=plan.pads,
                groups=groups)
    if plan.route == "mma":
        # the route's 16-byte copies need 16-byte aligned operands: a view
        # at another offset is copied (never on the main paths, whose
        # activations and cotangents are allocations of their own)
        x, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, g))
    lib = build.library("trim_conv2d_wgrad")
    dw = torch.empty(plan.dw_shape, dtype=torch.float32, device=x.device)
    ws = dw if plan.chunks == 1 else torch.empty(
        (plan.chunks * plan.dw_elems,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"trim_conv2d_wgrad{suffix}")(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(),
            plan.n, plan.h, plan.w, plan.cin, plan.cout, plan.kh, plan.kw,
            plan.stride, plan.pads[0][0], plan.pads[1][0], plan.groups,
            plan.h_out, plan.w_out, plan.tile_go,
            WGRAD_ROUTES.index(plan.route), plan.tile_cout, plan.blocks,
            stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv2d_wgrad{suffix} kernel launch failed: CUDA error "
            f"{err} ({lib.trim_conv2d_wgrad_error_string(err).decode()}) "
            f"for {plan}")
    LAUNCHES["wgrad" + suffix] += 1
    return dw


def plain_versions() -> dict:
    """The three conv wrappers that ``kernels.ops`` calls, keyed by name,
    as their plain versions on tensors of any device, the kernels' knobs
    dropped: what a check swaps into ``kernels.ops`` to run a path with no
    kernel."""
    def forward(x, w, bias=None, *, stride=1, pad=0, groups=1,
                activation=None, **_):
        return trim_conv2d_plain(x, w, bias, stride=stride, pad=pad,
                                 groups=groups, activation=activation)

    def input_grad(g, w, *, x_shape, stride=1, pad=0, groups=1, **_):
        return trim_conv2d_input_grad_plain(g, w, x_shape=x_shape,
                                            stride=stride, pad=pad,
                                            groups=groups)

    def weight_grad(x, g, *, kernel_size, stride=1, pad=0, groups=1, **_):
        return trim_conv2d_weight_grad_plain(x, g, kernel_size=kernel_size,
                                             stride=stride, pad=pad,
                                             groups=groups)
    return {"trim_conv2d": forward, "trim_conv2d_input_grad": input_grad,
            "trim_conv2d_weight_grad": weight_grad}


# ---------------------------------------------------------------------------
# The int8 route
# ---------------------------------------------------------------------------

def pack_q8_weights(w: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's weight layout: ``(K, K, Cin/g, Cout)`` int8 ->
    ``(Cout, kpad)`` int8, K-major rows, one an output channel: ``(K, K,
    C)`` flattened, with C = Cin/g rounded up to 4, or to 32 where Cin/g
    is a multiple of 16 (:func:`~repro_torch.core.conv_plan.
    q8_tap_bytes`: a k-step then never spans two taps), zero-padded to
    ``kpad`` (:func:`~repro_torch.core.conv_plan.q8_kpad`, a multiple of
    the 32-byte k-step).  The channels past Cin/g and the bytes past
    ``K * K * C`` are zero: their products add nothing.  A weight stage
    of the tensor-core routes is then ``tile_cout`` rows of 32-byte
    k-steps that ``ldmatrix`` loads as B fragments; the dp4a route reads
    words of 4 channels from it.  Made once, at quantize time
    (``ops.quantize_conv2d_weights``)."""
    k, _, cin_pg, cout = w.shape
    tap, kpad = q8_tap_bytes(cin_pg), q8_kpad(k, cin_pg)
    rows = F.pad(w, (0, 0, 0, tap - cin_pg)).permute(3, 0, 1, 2) \
        .reshape(cout, k * k * tap)
    return F.pad(rows, (0, kpad - k * k * tap)).contiguous()


def trim_conv2d_q8_plain(x: torch.Tensor, w: torch.Tensor,
                         bias_q: torch.Tensor | None, scale: torch.Tensor,
                         *, zero_point: int = 0, stride: int = 1, pad=0,
                         groups: int = 1,
                         activation: str | None = None) -> torch.Tensor:
    """The int8 kernel's function in plain PyTorch: ``_tap_matmuls``' int32
    route (``repro/kernels/trim_conv2d.py:82-100``) as K^2 shifted strided
    views of the input, padded with the zero point, times ``w[ki, kj]``,
    each tap's products exact (:func:`~repro_torch.kernels.ref.
    exact_int_products`) and accumulated in int32; then
    ``_epilogue_store``'s dequant (``:103-124``): ``acc + bias_q`` in
    int32, one f32 multiply by ``scale``, the activation."""
    k, s = w.shape[0], stride
    (pt, pb), (pl, pr) = normalize_pad(pad)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb), value=int(zero_point))
    n, hp, wp, _ = xp.shape
    cin_pg, cout = w.shape[2], w.shape[3]
    h_out, w_out = (hp - k) // s + 1, (wp - k) // s + 1
    acc = torch.zeros((n * h_out * w_out, groups, cout // groups),
                      dtype=torch.int32, device=x.device)
    for ki in range(k):
        for kj in range(k):
            rows = xp[:, ki:ki + (h_out - 1) * s + 1:s,
                      kj:kj + (w_out - 1) * s + 1:s, :]
            taps = w[ki, kj].reshape(cin_pg, groups, cout // groups)
            acc += exact_int_products(rows.reshape(-1, groups, cin_pg), taps,
                                      "mgc,cgo->mgo")
    acc = acc.reshape(n, h_out, w_out, cout)
    if bias_q is not None:
        acc = acc + bias_q
    return ACTIVATIONS[activation](acc.float() * scale)


def _check_q8(x, w, bias_q, scale, w_packed, zero_point, activation,
              dataflow) -> None:
    """The JAX wrapper's consistency checks (``repro/kernels/
    trim_conv2d.py:231-246``): integer x and w, an int32 requantized bias
    and an f32 scale row together; then the kernel's own."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"choose from {sorted(ACTIVATIONS, key=str)}")
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}; choose from "
                         f"{DATAFLOWS}")
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise TypeError(f"the int8 route requires BOTH integer inputs and a "
                        f"dequant scale: got x.dtype={x.dtype}")
    if w.dtype.is_floating_point or w.dtype.is_complex:
        raise TypeError(f"quantized conv needs integer weights, got "
                        f"{w.dtype}")
    if bias_q is not None and bias_q.dtype != torch.int32:
        raise TypeError("quantized conv takes the requantized int32 bias of "
                        f"ref.dequant_params, got {bias_q.dtype}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"the int8 kernel takes int8 x and w, got {x.dtype} "
                        f"and {w.dtype}")
    if not isinstance(scale, torch.Tensor) or scale.dtype != torch.float32:
        raise TypeError("the int8 route needs the f32 dequant scale row of "
                        "ref.dequant_params")
    if not -128 <= int(zero_point) <= 127:
        raise ValueError(f"zero_point={zero_point} is not an int8 value")
    tensors = dict(x=x, w=w, scale=scale)
    if bias_q is not None:
        tensors["bias_q"] = bias_q
    if w_packed is not None:
        tensors["w_packed"] = w_packed
    dev = x.device
    for name, t in tensors.items():
        if t.device.type not in ("cpu", "cuda") or t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}: all "
                             "operands must share a CPU or CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x and w must be 4-D (NHWC, (K, K, Cin/g, Cout)); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    for name, t in (("scale", scale), ("bias_q", bias_q)):
        if t is not None and tuple(t.shape) != (w.shape[3],):
            raise ValueError(f"{name} must be ({w.shape[3]},), got "
                             f"{tuple(t.shape)}")
    if w_packed is not None:
        k, _, cin_pg, cout = w.shape
        want = (cout, q8_kpad(k, cin_pg))
        if w_packed.dtype != torch.int8 or tuple(w_packed.shape) != want:
            raise ValueError(f"w_packed must be pack_q8_weights(w): int8 "
                             f"{want}, got {w_packed.dtype} "
                             f"{tuple(w_packed.shape)}")


def trim_conv2d_q8(x: torch.Tensor, w: torch.Tensor,
                   bias_q: torch.Tensor | None, scale: torch.Tensor, *,
                   zero_point: int = 0, stride: int = 1, pad=0,
                   groups: int = 1, activation: str | None = None,
                   dataflow: str = "carry", tile_h: int | None = None,
                   tile_cout: int | None = None,
                   w_packed: torch.Tensor | None = None) -> torch.Tensor:
    """Int8 strided (grouped) 2D convolution with the fused dequant + bias
    + activation epilogue (the JAX ``trim_conv2d`` with ``scale``,
    DESIGN.md §11).

    x: (N, H, W, Cin) int8; w: (K, K, Cin/groups, Cout) int8; bias_q:
    (Cout,) int32 or None and scale: (Cout,) f32, both from
    :func:`~repro_torch.kernels.ref.dequant_params`.  ``pad`` (an int or
    ``((top, bottom), (left, right))``) is applied inside the kernel and
    reads ``zero_point``, the activation's quantized 0.0, as the JAX path
    pre-pads with it.  ``w_packed`` is :func:`pack_q8_weights` of ``w``
    (packed here when None).  Returns (N, H_out, W_out, Cout) f32:
    ``act(float(acc + bias_q) * scale)`` with the exact int32 sum ``acc``.

    On a CPU tensor it runs :func:`trim_conv2d_q8_plain`; on a CUDA tensor
    it launches the int8 kernel or raises.  Inference only: the JAX route
    has no VJP either, so a ``scale`` that requires grad raises under
    autograd.
    """
    _check_q8(x, w, bias_q, scale, w_packed, zero_point, activation,
              dataflow)
    if torch.is_grad_enabled() and scale.requires_grad:
        raise NotImplementedError("the int8 route is inference only (the "
                                  "JAX route defines no VJP)")
    plan = ConvPlan.build(tuple(x.shape), tuple(w.shape), stride=stride,
                          pad=pad, groups=groups, tile_h=tile_h,
                          tile_cout=tile_cout, dataflow=dataflow,
                          dtype_bytes=1)
    if x.device.type == "cpu":
        with torch.no_grad():
            return trim_conv2d_q8_plain(x, w, bias_q, scale,
                                        zero_point=zero_point, stride=stride,
                                        pad=plan.pads, groups=groups,
                                        activation=activation)
    if w_packed is None:
        w_packed = pack_q8_weights(w)
    lib = build.library("trim_conv2d_q8")
    launch = lib.trim_conv2d_q8_carry if dataflow == "carry" \
        else lib.trim_conv2d_q8_halo
    y = torch.empty(plan.out_shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            x.data_ptr(), w_packed.data_ptr(),
            None if bias_q is None else bias_q.data_ptr(), scale.data_ptr(),
            y.data_ptr(), plan.n, plan.h, plan.w, plan.cin, plan.cout,
            plan.kh, plan.stride, plan.pads[0][0], plan.pads[1][0],
            plan.groups, plan.h_out, plan.w_out, plan.th_out, plan.tile_w,
            plan.tile_cout, plan.strips_per_segment, plan.ring_rows,
            plan.cin_stride, int(zero_point), ACTIVATION_CODES[activation],
            Q8_ROUTES.index(plan.route), plan.warps_n, plan.warps_k,
            plan.m_frags, stream)
    if err != 0:
        raise RuntimeError(
            f"trim_conv2d_q8 {dataflow} kernel launch failed: CUDA error "
            f"{err} ({lib.trim_conv2d_q8_error_string(err).decode()}) for "
            f"{plan}")
    LAUNCHES[f"q8_{dataflow}"] += 1
    return y


def hbm_traffic_model(n, h, width, cin, cout, k, stride=1, pad=0,
                      tile_h=None, tile_cout=None, dtype_bytes=4,
                      mode: str | None = "3dtrim") -> dict:
    """Device-memory bytes of the forward kernel's schedule for one
    square-kernel conv: a thin wrapper over
    :meth:`~repro_torch.core.conv_plan.ConvPlan.hbm_bytes` of the plan at
    these tiles (left None, the plan's own).  ``mode="trim"`` prices one
    segment a strip (each strip re-reads its rows shared with the one
    before: what the ``"halo"`` dataflow moves), ``"3dtrim"`` one carry
    segment a band, ``None`` the plan's own segments."""
    plan = ConvPlan.build((n, h, width, cin), (k, k, cin, cout),
                          stride=stride, pad=pad, tile_h=tile_h,
                          tile_cout=tile_cout, dtype_bytes=dtype_bytes)
    return plan.hbm_bytes(mode)
