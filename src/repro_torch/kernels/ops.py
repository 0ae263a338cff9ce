"""Operator API over the port's kernels (``repro/kernels/ops.py``): the
conv, conv1d and attention operators.

``conv2d`` takes ``impl``:

  * ``"trim"`` — the 3D-TrIM kernel: the hand-written Hopper kernel on a
    CUDA tensor, its plain PyTorch version on a CPU tensor.
  * ``"ref"``  — the oracle of ``kernels/ref.py``.

There is no tier chain: a kernel that fails raises.  'same' padding is
XLA's (asymmetric at stride > 1) and is applied inside the kernel, so no
padded copy of the input is made.

K > 8 (``MAX_NATIVE_K``).  The paper's kernel tiling, as the JAX
``_conv2d_pallas`` does it (``repro/kernels/ops.py:538-559``): the input is
padded 'same' once (a padded copy, like ``jnp.pad``), the K x K kernel is
split by ``core.tiling.subkernel_decomposition`` into sub-kernels of at
most 3 x 3 taps (rectangular at the edges: 11 = 3 + 3 + 3 + 2), each runs
as one kernel call (differentiable under grad) with no bias and no
activation on its 'valid' slice of the padded input, the parts are summed
in the decomposition's order (the adder tree) and the bias + activation
epilogue runs once on the sum.  The slices, adds and epilogue are plain
PyTorch, as they are XLA in JAX; explicit ``tile_h``, ``tile_cout`` and
``dataflow`` apply to every sub-kernel.

Int8.  ``conv2d`` given :class:`QuantizedConv2dWeights` (from
:func:`quantize_conv2d_weights` or ``models.layers.calibrate_conv2d``)
runs the int8 route, as the JAX ``_conv2d_packed`` does for packed
weights with a ``scale`` (``repro/kernels/ops.py:629-636``): the f32
input is quantized against the layer's calibration (a plain elementwise
pass), and ``"trim"`` launches the int8 kernel (``trim_conv2d_q8``) with
the zero point as its virtual 'same' padding, ``"ref"`` runs the
``conv2d_quantized`` oracle.  There is no ``q8 -> pallas -> ref`` chain.
The route is inference only: under grad, an input that requires grad
raises.

bf16.  bf16 x, weights and bias (one dtype) run the bf16 route of the
kernels, as the JAX ``conv2d(impl="pallas")`` does on bf16 operands: each
conv's output is bf16, rounded once from its f32 sum; the K > 8 adder
tree's parts are bf16 and are summed in bf16, out of place and in the
decomposition's order, and its epilogue runs in bf16, as JAX's ``out +
part`` and ``ref.epilogue`` do.  Autotune records are keyed by the dtype,
so a bf16 call never takes an f32 record.  Under grad the bf16 conv
differentiates as JAX's ``_conv_grads`` does on bf16: dx is the bf16
forward entry on the dilated cotangent, dw the weight-gradient kernel's
bf16 entry (f32 sums of exact products, rounded once to w's dtype), db
the cotangent's sum in the bias's dtype; the backward's autotune lookups
run at the tensors' dtype too.

Autotuning.  Knobs a call leaves ``None`` (``tile_h``, ``tile_cout``,
``dataflow``) come from the port's autotune cache (``core/autotune.py``,
``repro/kernels/ops.py:520-530``): ``conv2d`` and the backward's two
cotangent kernels read the records of their own problems, the int8 route
its ``conv2d_q8:`` records, :class:`PackedConv2dWeights` carry the
records' knobs as hints from load time; the K > 8 adder tree reads none.
With no record the plan decides, so a call on an empty cache runs as it
did before the tuner.

Gradients.  With grad enabled and an operand that requires grad, the
``"trim"`` conv runs through :class:`_TrimConv2dFn`, the counterpart of
the ``jax.custom_vjp`` ``_conv2d_vjp_core`` (``repro/kernels/ops.py:
262-334``): the forward kernel without its activation, the activation
outside it, and a backward whose ``dx`` runs the forward kernel on the
dilated cotangent and whose ``dw`` runs the weight-gradient kernel.
Otherwise the conv is one launch with the bias + activation epilogue
fused, as served.

``depthwise_conv1d`` takes ``impl``: ``"trim"`` (the hand-written Hopper
kernel of ``kernels/trim_conv1d.py`` on a CUDA tensor, its plain version on
a CPU tensor; the JAX ``"pallas"``) or ``"ref"`` (the oracle); K < 2 goes
to the oracle either way, as in JAX.  ``depthwise_conv1d_step`` is the
oracle's decode step.

``attention`` takes ``impl``: ``"flash"`` (the hand-written Hopper kernel
of ``kernels/flash_attention.py`` on a CUDA tensor, its plain version on a
CPU tensor), ``"chunked"`` (the same online softmax in plain PyTorch over
chunks of ``chunk`` keys) or ``"ref"`` (the oracle).  ``decode_attention``
is plain PyTorch, as in JAX: one query over a KV cache has no kernel.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import torch

from repro_torch.core import autotune
from repro_torch.core.conv_plan import DATAFLOWS, input_grad_geometry
from repro_torch.core.tiling import subkernel_decomposition
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.ref import ACTIVATIONS, conv_pads, pad_nhwc
from repro_torch.kernels.trim_conv1d import trim_conv1d
from repro_torch.kernels.trim_conv2d import (pack_q8_weights, trim_conv2d,
                                             trim_conv2d_input_grad,
                                             trim_conv2d_q8,
                                             trim_conv2d_weight_grad)

MAX_NATIVE_K = 8


class _ConvConfig(typing.NamedTuple):
    """Static knobs of one differentiable conv call."""

    stride: int
    pads: tuple
    groups: int
    activation: str | None
    dataflow: str
    tile_h: int | None
    tile_cout: int | None
    use_autotune_cache: bool = True


def _activation_bwd(activation: str | None, z: torch.Tensor | None,
                    gy: torch.Tensor) -> torch.Tensor:
    """Cotangent through the epilogue activation, by autograd of
    ``ref.ACTIVATIONS`` at the saved pre-activation ``z``
    (``repro/kernels/ops.py:262``)."""
    if activation is None:
        return gy
    with torch.enable_grad():
        z = z.detach().requires_grad_()
        return torch.autograd.grad(ACTIVATIONS[activation](z), z, gy)[0]


def _backward_knobs(cfg: _ConvConfig, x: torch.Tensor, w: torch.Tensor):
    """Knobs of the two cotangent kernels (``repro/kernels/ops.py:
    271-290``): the input-gradient conv's from the ``conv2d:`` record of
    its own problem (the dilated cotangent, the transposed weights, the
    edge pads of ``input_grad_geometry``), the weight gradient's from
    ``conv2d_wgrad:``, both at x's dtype (JAX's ``str(x.dtype)``);
    without a record, the forward's dataflow and the plans' defaults."""
    ig = dict(tile_h=None, tile_cout=None, dataflow=cfg.dataflow)
    wg = dict(tile_go=None)
    if cfg.use_autotune_cache:
        x_shape, w_shape = tuple(x.shape), tuple(w.shape)
        dtype = autotune.dtype_name(x.dtype)
        geo = input_grad_geometry(x_shape, w_shape, stride=cfg.stride,
                                  pad=cfg.pads, groups=cfg.groups)
        rec = autotune.knobs_for(geo["g_dilated_shape"], geo["wt_shape"],
                                 stride=1, pad=(geo["pad_h"], geo["pad_w"]),
                                 groups=cfg.groups, dtype=dtype,
                                 device=x.device)
        if rec is not None:
            ig = {k: rec[k] for k in ig}
        wrec = autotune.weight_grad_knobs_for(
            x_shape, w_shape, stride=cfg.stride, pad=cfg.pads,
            groups=cfg.groups, dtype=dtype, device=x.device)
        if wrec is not None:
            wg = dict(tile_go=wrec["tile_go"])
    return ig, wg


class _TrimConv2dFn(torch.autograd.Function):
    """The differentiable TrIM conv: ``_conv2d_vjp_fwd`` /
    ``_conv2d_vjp_bwd`` / ``_conv_grads`` of ``repro/kernels/ops.py``.
    x, w and bias share one dtype; each cotangent comes back in its
    operand's dtype, as ``_conv_grads`` casts them
    (``repro/kernels/ops.py:303-306``): dx from the input-gradient conv in
    that dtype, dw the weight-gradient kernel's f32 sums rounded once."""

    @staticmethod
    def forward(ctx, x, w, bias, cfg: _ConvConfig):
        z = trim_conv2d(x, w, bias, stride=cfg.stride, pad=cfg.pads,
                        groups=cfg.groups, activation=None,
                        dataflow=cfg.dataflow, tile_h=cfg.tile_h,
                        tile_cout=cfg.tile_cout)
        # z is a residual only when the activation needs it
        ctx.save_for_backward(x, w, z if cfg.activation else None)
        ctx.cfg, ctx.has_bias = cfg, bias is not None
        return ACTIVATIONS[cfg.activation](z)

    @staticmethod
    def backward(ctx, gy):
        x, w, z = ctx.saved_tensors
        cfg = ctx.cfg
        dz = _activation_bwd(cfg.activation, z, gy).contiguous()
        dx = dw = db = None
        ig, wg = _backward_knobs(cfg, x, w)
        if ctx.needs_input_grad[0]:
            dx = trim_conv2d_input_grad(dz, w, x_shape=tuple(x.shape),
                                        stride=cfg.stride, pad=cfg.pads,
                                        groups=cfg.groups, **ig)
        if ctx.needs_input_grad[1]:
            dw = trim_conv2d_weight_grad(x, dz,
                                         kernel_size=tuple(w.shape[:2]),
                                         stride=cfg.stride, pad=cfg.pads,
                                         groups=cfg.groups, **wg
                                         ).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dz.sum((0, 1, 2))
        return dx, dw, db, None


@dataclasses.dataclass(frozen=True, eq=False)
class PackedConv2dWeights:
    """One f32 (or bf16) conv layer packed at load time: the counterpart
    of the JAX ``PackedConv2dWeights`` (``repro/kernels/ops.py:71-120``)
    without its quantization leaves.  The port's kernels take LOGICAL
    weights, so there is no padded layout: ``w`` is ``(K, K, Cin/groups,
    Cout)`` f32 or bf16 and ``bias`` ``(Cout,)`` of its dtype, or None.
    ``tile_cout``, ``tile_h`` and ``dataflow`` are the frozen knob hints
    (from the autotune cache at pack time, or given), applied where the
    call leaves a knob ``None``; a ``None`` hint leaves it to the cache
    and the plan."""

    w: torch.Tensor
    bias: torch.Tensor | None
    groups: int
    cout: int
    tile_cout: int | None = None
    tile_h: int | None = None
    dataflow: str | None = None

    def __post_init__(self):
        if self.w.dim() != 4 or self.w.shape[3] != self.cout \
                or self.cout % self.groups:
            raise ValueError(f"w {tuple(self.w.shape)} does not hold "
                             f"cout={self.cout} in groups={self.groups}")
        if self.dataflow is not None and self.dataflow not in DATAFLOWS:
            raise ValueError(f"unknown dataflow {self.dataflow!r}; "
                             f"choose from {DATAFLOWS}")

    def tensors(self) -> dict:
        """The tensor fields by name (``bias`` only when set)."""
        return {k: getattr(self, k) for k in ("w", "bias")
                if getattr(self, k) is not None}

    def to(self, device) -> "PackedConv2dWeights":
        return dataclasses.replace(
            self, **{k: t.to(device) for k, t in self.tensors().items()})


def pack_conv2d_weights(w: torch.Tensor, bias: torch.Tensor | None = None,
                        *, groups: int = 1, tile_cout: int | None = None,
                        tile_h: int | None = None,
                        dataflow: str | None = None, x_shape=None,
                        stride: int = 1, padding: str = "same",
                        device=None) -> PackedConv2dWeights:
    """Pack one f32 (or bf16) conv layer at load time
    (``repro/kernels/ops.py:123-180``).  w: (K, K, Cin/groups, Cout);
    bias: (Cout,) or None; bf16 stays bf16, any other float becomes f32.
    When ``x_shape`` (the input the layer will see) is given and a knob
    is unset, the autotune cache is consulted under the key ``conv2d``
    would use for that input on ``device`` (default: ``w``'s device), and
    the record's knobs become the entry's hints.  K > :data:`MAX_NATIVE_K`
    raises ``ValueError``, as in JAX: the kernel-tiled path re-slices the
    weights per sub-kernel."""
    kh, kw, cin_pg, cout = w.shape
    if kh > MAX_NATIVE_K:
        raise ValueError(
            f"K={kh} > {MAX_NATIVE_K}: the kernel-tiled path re-slices "
            "weights per sub-kernel and cannot consume packed weights")
    if cout % groups:
        raise ValueError(f"groups={groups} must divide cout={cout}")
    if x_shape is not None and None in (tile_cout, tile_h, dataflow):
        n, h, wd, _ = x_shape
        rec = autotune.knobs_for(
            (n, h, wd, cin_pg * groups), tuple(w.shape), stride=stride,
            pad=conv_pads(h, wd, kh, stride, padding), groups=groups,
            dtype=autotune.dtype_name(w.dtype),
            device=w.device if device is None else device)
        if rec is not None:
            tile_cout = rec["tile_cout"] if tile_cout is None else tile_cout
            tile_h = rec["tile_h"] if tile_h is None else tile_h
            dataflow = rec["dataflow"] if dataflow is None else dataflow
    def keep(t):
        return (t if t.dtype == torch.bfloat16 else t.float()).contiguous()
    return PackedConv2dWeights(
        w=keep(w), bias=None if bias is None else keep(bias),
        groups=groups, cout=cout, tile_cout=tile_cout, tile_h=tile_h,
        dataflow=dataflow)


@dataclasses.dataclass(frozen=True)
class QuantizedConv2dWeights:
    """One conv layer quantized for the int8 route: the port's counterpart
    of the JAX ``PackedConv2dWeights`` with its quantization leaves set
    (``repro/kernels/ops.py:73-113``), in the LOGICAL layout.

    ``w``: int8 ``(K, K, Cin/groups, Cout)`` per-out-channel symmetric
    quantized weights; ``bias``: the real f32 ``(Cout,)`` bias or None (the
    int32 bias is derived per call, as in JAX); ``scale``: the f32
    ``(Cout,)`` weight scales; ``zero_point`` (int32) and ``input_scale``
    (f32), 0-dim: the per-tensor affine activation calibration.
    ``w_kernel`` is the int8 kernel's layout of ``w``
    (:func:`~repro_torch.kernels.trim_conv2d.pack_q8_weights`), made once
    here when not given; ``zp`` is the zero point as a Python int, read
    once, so a forward never waits on the device for it.
    """

    w: torch.Tensor
    bias: torch.Tensor | None
    scale: torch.Tensor
    zero_point: torch.Tensor
    input_scale: torch.Tensor
    groups: int
    cout: int
    w_kernel: torch.Tensor | None = None
    zp: int | None = None

    def __post_init__(self):
        if self.w.dtype != torch.int8 or self.w.dim() != 4 \
                or self.w.shape[0] != self.w.shape[1]:
            raise ValueError(f"w must be int8 (K, K, Cin/g, Cout), got "
                             f"{self.w.dtype} {tuple(self.w.shape)}")
        if self.w.shape[3] != self.cout or self.cout % self.groups:
            raise ValueError(f"w {tuple(self.w.shape)} does not hold "
                             f"cout={self.cout} in groups={self.groups}")
        if self.w_kernel is None:
            object.__setattr__(self, "w_kernel", pack_q8_weights(self.w))
        if self.zp is None:
            object.__setattr__(self, "zp", int(self.zero_point))

    def tensors(self) -> dict:
        """The tensor fields by name (``bias`` only when set)."""
        names = ("w", "bias", "scale", "zero_point", "input_scale",
                 "w_kernel")
        return {k: getattr(self, k) for k in names
                if getattr(self, k) is not None}

    def to(self, device) -> "QuantizedConv2dWeights":
        return dataclasses.replace(
            self, **{k: t.to(device) for k, t in self.tensors().items()})


def quantize_conv2d_weights(w: torch.Tensor,
                            bias: torch.Tensor | None = None, *, x_scale,
                            x_zero_point=0,
                            groups: int = 1) -> QuantizedConv2dWeights:
    """Quantize one conv layer for the int8 route
    (``repro/kernels/ops.py:184-215``): per-out-channel symmetric weight
    scales (``ref.weight_scales_int8``) and the per-tensor affine
    activation calibration ``(x_scale, x_zero_point)``, typically from
    ``models.layers.calibrate_conv2d``.  w: f32 (K, K, Cin/groups, Cout);
    bias: (Cout,) or None.  K > :data:`MAX_NATIVE_K` raises ``ValueError``,
    as the JAX ``pack_conv2d_weights`` does (``repro/kernels/ops.py:
    147-150``): the kernel-tiled path cannot take packed weights."""
    kh = w.shape[0]
    if kh > MAX_NATIVE_K:
        raise ValueError(
            f"K={kh} > {MAX_NATIVE_K}: the kernel-tiled path re-slices "
            "weights per sub-kernel and cannot consume packed weights")
    w_scale = ref.weight_scales_int8(w)
    w_q = ref.quantize_int8(w, w_scale[None, None, None, :])
    dev = w.device
    return QuantizedConv2dWeights(
        w=w_q, bias=None if bias is None else bias.float(), scale=w_scale,
        zero_point=torch.as_tensor(x_zero_point, device=dev)
        .to(torch.int32),
        input_scale=torch.as_tensor(x_scale, dtype=torch.float32,
                                    device=dev),
        groups=groups, cout=w.shape[3])


def _q8_forward(x_q: torch.Tensor, pk: QuantizedConv2dWeights, *,
                stride: int, pads, activation: str | None,
                dataflow: str | None, tile_h: int | None = None,
                tile_cout: int | None = None) -> torch.Tensor:
    """The int8 kernel on a quantized input (``repro/kernels/ops.py:
    702-730``): the dequant scale row and the requantized int32 bias from
    ``ref.dequant_params``, then one launch with the zero point as the
    virtual padding."""
    scale, bias_q = ref.dequant_params(pk.w, pk.scale, pk.input_scale,
                                       pk.zero_point, pk.bias)
    return trim_conv2d_q8(x_q, pk.w, bias_q, scale, zero_point=pk.zp,
                          stride=stride, pad=pads, groups=pk.groups,
                          activation=activation,
                          dataflow=dataflow or "carry", tile_h=tile_h,
                          tile_cout=tile_cout, w_packed=pk.w_kernel)


def _conv2d_q8(x: torch.Tensor, pk: QuantizedConv2dWeights, *, stride: int,
               padding: str, impl: str, activation: str | None,
               dataflow: str | None, tile_h: int | None = None,
               tile_cout: int | None = None,
               use_autotune_cache: bool = True) -> torch.Tensor:
    """The int8 route of :func:`conv2d` (``repro/kernels/ops.py:733-795``
    without its tier chain): x is f32, quantized here against the layer's
    calibration, or already int8.  Knobs left ``None`` come from the
    ``conv2d_q8:`` record of the problem (``repro/kernels/ops.py:
    715-722``), never from an f32 one."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("the int8 route is inference only (the "
                                  "JAX route defines no VJP)")
    if x.dtype.is_floating_point:
        x_q = ref.quantize_int8(x, pk.input_scale, pk.zero_point)
    else:
        x_q = x
    if impl == "ref":
        return ref.conv2d_quantized(
            x_q, pk.w, x_scale=pk.input_scale, x_zero_point=pk.zp,
            w_scale=pk.scale, bias=pk.bias, stride=stride, padding=padding,
            feature_group_count=pk.groups, activation=activation)
    if impl != "trim":
        raise ValueError(f"unknown impl {impl!r}; choose 'trim' or 'ref'")
    k = pk.w.shape[0]
    pads = conv_pads(x.shape[1], x.shape[2], k, stride, padding)
    if use_autotune_cache and None in (tile_h, tile_cout, dataflow):
        rec = autotune.knobs_for(tuple(x.shape), tuple(pk.w.shape),
                                 stride=stride, pad=pads, groups=pk.groups,
                                 dtype="int8", device=x.device,
                                 op="conv2d_q8")
        if rec is not None:
            tile_h = rec["tile_h"] if tile_h is None else tile_h
            tile_cout = rec["tile_cout"] if tile_cout is None else tile_cout
            dataflow = rec["dataflow"] if dataflow is None else dataflow
    return _q8_forward(x_q, pk, stride=stride, pads=pads,
                       activation=activation, dataflow=dataflow,
                       tile_h=tile_h, tile_cout=tile_cout)


def conv_launches(k: int) -> int:
    """Kernel launches of one ``"trim"`` :func:`conv2d` forward of a K x K
    kernel: one, or one a sub-kernel of the kernel tiling for K >
    :data:`MAX_NATIVE_K` (16 at K = 11)."""
    if k > MAX_NATIVE_K:
        return len(subkernel_decomposition(k, native_k=3))
    return 1


def kernel_input_shape(x_shape, k: int, stride: int, padding: str):
    """(shape, residual_pad) of the conv problem after the 'same' pre-pad
    (the padded input with ``pad=0``), as ``repro.kernels.ops`` defines
    it; ``core.netplan.layer_kernel_problem`` reads it."""
    n, h, w, cin = x_shape
    (pt, pb), (pl, pr) = conv_pads(h, w, k, stride, padding)
    return (n, h + pt + pb, w + pl + pr, cin), 0


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: str = "same", impl: str = "trim",
           feature_group_count: int = 1, bias: torch.Tensor | None = None,
           activation: str | None = None, tile_h: int | None = None,
           tile_cout: int | None = None,
           dataflow: str | None = None,
           use_autotune_cache: bool = True) -> torch.Tensor:
    """(Grouped) 2D convolution with optional fused bias + activation.

    x: (N, H, W, Cin); w: (K, K, Cin/groups, Cout); bias: (Cout,) or None;
    all f32, or all bf16 (the bf16 route, module docstring: bf16 out);
    ``feature_group_count=Cin`` gives depthwise convolution.  K > 8 runs
    the kernel tiling's adder tree (module docstring).  ``dataflow``
    (``"carry"`` or ``"halo"``) and the tile knobs go to the kernel.  A
    knob left ``None`` is filled from the autotune cache
    (``core/autotune.py``) where a record exists for this problem on x's
    device (disable with ``use_autotune_cache=False`` or
    ``REPRO_TORCH_CONV_AUTOTUNE=0``), else the plan decides (``"carry"``
    for the dataflow).  The K > 8 adder tree applies explicit knobs to
    every sub-kernel and never consults the cache (a record describes
    the full-K problem).  Under grad, the ``"trim"`` conv is
    differentiable in x, w and bias; its cotangent kernels take the
    records of their own problems, else the forward's dataflow and
    default tiles.

    ``w`` may be :class:`PackedConv2dWeights` (its groups and bias its
    own, its knob hints applied after explicit knobs and before the
    cache) or :class:`QuantizedConv2dWeights`: the int8 route (module
    docstring), its groups and bias its own (``bias`` must be None and
    ``feature_group_count`` 1 or the weights' groups), f32 out.
    """
    if dataflow is not None and dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}; "
                         f"choose from {DATAFLOWS}")
    if isinstance(w, PackedConv2dWeights):
        if bias is not None:
            raise ValueError("the bias is inside PackedConv2dWeights; "
                             "pass it to pack_conv2d_weights instead")
        if feature_group_count not in (1, w.groups):
            raise ValueError(f"feature_group_count={feature_group_count} "
                             f"but the weights were packed for "
                             f"groups={w.groups}")
        pk, feature_group_count = w, w.groups
        w, bias = pk.w, pk.bias
        tile_h = pk.tile_h if tile_h is None else tile_h
        tile_cout = pk.tile_cout if tile_cout is None else tile_cout
        dataflow = pk.dataflow if dataflow is None else dataflow
    if isinstance(w, QuantizedConv2dWeights):
        if bias is not None:
            raise ValueError("the bias is inside QuantizedConv2dWeights; "
                             "pass it to quantize_conv2d_weights instead")
        if feature_group_count not in (1, w.groups):
            raise ValueError(f"feature_group_count={feature_group_count} "
                             f"but the weights were quantized for "
                             f"groups={w.groups}")
        return _conv2d_q8(x, w, stride=stride, padding=padding, impl=impl,
                          activation=activation, dataflow=dataflow,
                          tile_h=tile_h, tile_cout=tile_cout,
                          use_autotune_cache=use_autotune_cache)
    cin, (cin_pg, cout) = x.shape[3], w.shape[2:]
    if cin_pg * feature_group_count != cin:
        raise ValueError(
            f"weights expect cin/groups={cin_pg} with "
            f"groups={feature_group_count}, input has cin={cin}")
    if cout % feature_group_count:
        raise ValueError(f"groups={feature_group_count} must divide "
                         f"cout={cout}")
    if impl == "ref":
        return ref.conv2d(x, w, stride=stride, padding=padding,
                          feature_group_count=feature_group_count,
                          bias=bias, activation=activation)
    if impl != "trim":
        raise ValueError(f"unknown impl {impl!r}; choose 'trim' or 'ref'")
    k = w.shape[0]
    if k > MAX_NATIVE_K:
        return _conv2d_tiled(x, w, bias, stride=stride, padding=padding,
                             groups=feature_group_count,
                             activation=activation, dataflow=dataflow,
                             tile_h=tile_h, tile_cout=tile_cout)
    pads = conv_pads(x.shape[1], x.shape[2], k, stride, padding)
    if use_autotune_cache and None in (tile_h, tile_cout, dataflow):
        rec = autotune.knobs_for(tuple(x.shape), tuple(w.shape),
                                 stride=stride, pad=pads,
                                 groups=feature_group_count,
                                 dtype=autotune.dtype_name(x.dtype),
                                 device=x.device)
        if rec is not None:
            tile_h = rec["tile_h"] if tile_h is None else tile_h
            tile_cout = rec["tile_cout"] if tile_cout is None else tile_cout
            dataflow = rec["dataflow"] if dataflow is None else dataflow
    return _conv_core(x, w, bias, _ConvConfig(
        stride, pads, feature_group_count, activation, dataflow or "carry",
        tile_h, tile_cout, use_autotune_cache))


def _conv_core(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
               cfg: _ConvConfig) -> torch.Tensor:
    """One TrIM kernel call: through :class:`_TrimConv2dFn` under grad with
    an operand that requires it, else one launch with the bias +
    activation epilogue fused."""
    operands = (x, w) if bias is None else (x, w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _TrimConv2dFn.apply(x, w, bias, cfg)
    return trim_conv2d(x, w, bias, stride=cfg.stride, pad=cfg.pads,
                       groups=cfg.groups, activation=cfg.activation,
                       dataflow=cfg.dataflow, tile_h=cfg.tile_h,
                       tile_cout=cfg.tile_cout)


def _conv2d_tiled(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None, *, stride: int, padding: str,
                  groups: int, activation: str | None, dataflow: str | None,
                  tile_h: int | None, tile_cout: int | None) -> torch.Tensor:
    """The K > :data:`MAX_NATIVE_K` path (module docstring): the adder
    tree over :func:`subkernel_decomposition`'s sub-kernels, each one
    kernel call on the contiguous 'valid' slice of the padded input with
    its contiguous weight slice, then the epilogue once."""
    k = w.shape[0]
    x = pad_nhwc(x, conv_pads(x.shape[1], x.shape[2], k, stride, padding))
    h_out = (x.shape[1] - k) // stride + 1
    w_out = (x.shape[2] - k) // stride + 1
    if h_out < 1 or w_out < 1:
        raise ValueError(f"empty output: input {tuple(x.shape)} (padded) "
                         f"is smaller than the {k}x{k} kernel")
    cfg = _ConvConfig(stride, ((0, 0), (0, 0)), groups, None,
                      dataflow or "carry", tile_h, tile_cout,
                      use_autotune_cache=False)
    out = None
    for r0, c0, kh, kw in subkernel_decomposition(k, native_k=3):
        xs = x[:, r0:r0 + (h_out - 1) * stride + kh,
               c0:c0 + (w_out - 1) * stride + kw, :].contiguous()
        part = _conv_core(xs, w[r0:r0 + kh, c0:c0 + kw].contiguous(), None,
                          cfg)
        out = part if out is None else out + part   # the adder tree
    return ref.epilogue(out, bias, activation)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: str = "same", impl: str = "trim",
                     bias: torch.Tensor | None = None,
                     activation: str | None = None,
                     dataflow: str | None = None) -> torch.Tensor:
    """Depthwise 2D convolution: :func:`conv2d` with
    ``feature_group_count == Cin``.  x: (N, H, W, Cin); w: (K, K, 1,
    Cin * multiplier)."""
    return conv2d(x, w, stride=stride, padding=padding, impl=impl,
                  feature_group_count=x.shape[-1], bias=bias,
                  activation=activation, dataflow=dataflow)


def conv_pool_chain(x: torch.Tensor, weights, biases, steps, *,
                    activation: str | None = "relu", impl: str = "trim",
                    dataflow: str | None = None) -> torch.Tensor:
    """Per-layer execution of a conv→[max-pool] chain: for each ``(stride,
    padding, groups, pool_stride, pool_window)`` of ``steps``, one
    :func:`conv2d` (bias + activation fused) and then a separate max pool
    (none for ``(1, 1)``).  The one per-layer chain of the port: a
    topology's per-layer forward and the fused groups' oracle and
    recompute backward both run it."""
    for w, b, (stride, padding, groups, ps, pw) in zip(weights, biases,
                                                        steps):
        x = conv2d(x, w, stride=stride, padding=padding, impl=impl,
                   feature_group_count=groups, bias=b, activation=activation,
                   dataflow=dataflow)
        if ps > 1 or pw > 1:      # (1, w>1): stride-1 overlapping pool
            x = ref.maxpool2d(x, ps, pw)
    return x


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                     impl: str = "trim") -> torch.Tensor:
    """Causal depthwise conv1d (``repro/kernels/ops.py:822``).  x: (B, L,
    D); w: (K, D), f32 or bf16.  Under grad ``"trim"`` differentiates
    through the backward kernels (``trim_conv1d``'s autograd Function, on
    the operands' dtype), ``"ref"`` through plain autograd of the
    oracle."""
    if impl not in ("trim", "ref"):
        raise ValueError(f"unknown impl {impl!r}; choose 'trim' or 'ref'")
    if impl == "ref" or w.shape[0] < 2:
        return ref.depthwise_conv1d(x, w)
    return trim_conv1d(x, w)


depthwise_conv1d_step = ref.depthwise_conv1d_step


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, soft_cap: float | None = None,
                      window: int | None = None,
                      chunk: int = 1024) -> torch.Tensor:
    """The FlashAttention schedule in plain PyTorch, KV streamed in chunks
    of ``chunk`` keys (``repro/kernels/ops.py:867``): the flash kernel's
    plain version at that tile.  q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv, D)."""
    return flash_attention_plain(q, k, v, causal=causal, soft_cap=soft_cap,
                                 window=window, block_k=min(chunk, k.shape[1]))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, soft_cap: float | None = None,
              window: int | None = None, impl: str = "flash",
              chunk: int = 1024) -> torch.Tensor:
    """Multi-head GQA attention (``repro/kernels/ops.py:924``).
    q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv, D)."""
    if impl == "ref":
        return ref.attention(q, k, v, causal=causal,
                             logits_soft_cap=soft_cap, window=window)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, soft_cap=soft_cap,
                               window=window)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, soft_cap=soft_cap,
                                 window=window, chunk=chunk)
    raise ValueError(f"unknown attention impl {impl!r}; choose 'flash', "
                     "'chunked' or 'ref'")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     soft_cap: float | None = None,
                     window: int | None = None) -> torch.Tensor:
    """One-token attention over a KV cache (``repro/kernels/ops.py:944``).

    q: (B, 1, Hq, D); caches: (B, Lmax, Hkv, D); cache_len: (B,) — the
    number of valid cache entries, the current token included.
    """
    b, _, hq, d = q.shape
    _, lmax, hkv, _ = k_cache.shape
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     k_cache.float()) / math.sqrt(d)
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    k_pos = torch.arange(lmax, device=q.device)
    clen = cache_len.reshape(-1, 1)
    valid = k_pos[None, :] < clen
    if window is not None:
        valid &= k_pos[None, :] >= clen - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)
