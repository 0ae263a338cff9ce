"""Layers of ``repro/models/layers.py``: the convolution half and the
transformer (LM) half.

Convolutions.  Functional core on trees of tensors — ``conv2d_apply``,
``depthwise_separable_apply``, ``simple_cnn_apply``,
``cnn_apply_from_layers`` (linear chains), ``cnn_apply_from_graph`` (DAG
topologies: ResNet-18, U-Net) — as in the JAX package, and
:class:`TrimCNN`, the ``nn.Module`` that holds one topology's parameters
and serves or trains it.  Every function is differentiable: under grad,
each conv runs the TrIM forward, input-gradient and weight-gradient kernels
(``kernels/ops.py``), and max-pool's backward is ``F.max_pool2d``'s.
Activations are NHWC and conv weights ``(K, K, Cin/groups, Cout)``.  A
conv entry is ``{"w", "b"}`` (f32, or bf16: a bf16 tree runs the bf16
routes of the conv and fused kernels, and its pools, global mean and head
in bf16, as the JAX functions run a bf16 tree; inference only); after
:func:`conv2d_pack_params` /
:func:`cnn_pack_params`, ``{"packed": PackedConv2dWeights}`` (the same
f32 weights with the autotune cache's knobs as hints); or, after
:func:`calibrate_conv2d`, ``{"packed": QuantizedConv2dWeights}``, which
runs the int8 route (inference only; ``TrimCNN`` holds it as buffers).

Transformer layers.  Norms (RMSNorm / LayerNorm in f32, eps 1e-6), RoPE
(split halves), GQA attention with an optional KV cache, the dense MLPs,
the mixture of experts and the token embedding / LM head, each a
``*_params`` declaration and a ``*_apply`` function on tensors in the
JAX layout (``wq`` ``(d, h, hd)``, ``wo`` ``(h, hd, d)``, activations
``(B, L, d)``).  No sharding: the port's LM runs on one device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.fuse_plan import FusedGroupPlan, graph_segments
from repro_torch.core.model import GraphNode
from repro_torch.core.netplan import (GRAPHS, graph_nodes, infer_pools,
                                      layer_kernel_problem, network_layers)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.trim_conv2d_fused import fused_group_apply
from repro_torch.models.base import Param, init_params
from repro_torch.models.config import ModelConfig


def conv2d_params(k: int, cin: int, cout: int, *, groups: int = 1,
                  bias: bool = True) -> dict:
    """Declarations for one (grouped) conv layer."""
    # init scales by 1/sqrt(shape[-2]) == 1/sqrt(cin/groups); the extra
    # 1/k recovers He-style 1/sqrt(K^2 * cin/groups) for conv taps
    p = {"w": Param((k, k, cin // groups, cout), scale=1.0 / k)}
    if bias:
        p["b"] = Param((cout,), init="zeros")
    return p


def _conv_operands(p: dict) -> tuple:
    """(weights, bias) of one conv entry: ``{"w", "b"}``, or the packed
    or quantized weights of ``{"packed"}`` (their bias inside)."""
    if "packed" in p:
        return p["packed"], None
    return p["w"], p.get("b")


def conv2d_apply(p: dict, x: torch.Tensor, *, stride: int = 1,
                 padding: str = "same", groups: int = 1,
                 activation: str | None = "relu", impl: str = "trim",
                 dataflow: str | None = None) -> torch.Tensor:
    """One conv layer with the bias + activation epilogue fused into the
    kernel (one store of the output).  Accepts raw params (``{"w", "b"}``),
    a packed entry (``{"packed"}``, :func:`conv2d_pack_params`) or a
    calibrated one (``{"packed"}``, :func:`calibrate_conv2d`), which runs
    the int8 route."""
    w, b = _conv_operands(p)
    return ops.conv2d(x, w, stride=stride, padding=padding, impl=impl,
                      feature_group_count=groups, bias=b,
                      activation=activation, dataflow=dataflow)


def conv2d_pack_params(p: dict, *, groups: int = 1,
                       tile_cout: int | None = None,
                       tile_h: int | None = None,
                       dataflow: str | None = None, x_shape=None,
                       stride: int = 1, padding: str = "same") -> dict:
    """Pack one conv layer's params at load time
    (``repro/models/layers.py:185``): ``{"packed": PackedConv2dWeights}``,
    consumed by :func:`conv2d_apply`.  With ``x_shape`` given, the
    autotune cache fills any unset knob (``ops.pack_conv2d_weights``), so
    the forward runs on the tuned plan."""
    return {"packed": ops.pack_conv2d_weights(
        p["w"], p.get("b"), groups=groups, tile_cout=tile_cout,
        tile_h=tile_h, dataflow=dataflow, x_shape=x_shape, stride=stride,
        padding=padding)}


def calibrate_conv2d(p: dict, x_batch: torch.Tensor, *,
                     groups: int = 1) -> dict:
    """Post-training int8 calibration of one conv layer
    (``repro/models/layers.py:205-231``, DESIGN.md §11).

    The sample batch's range, widened to contain 0.0 so that the zero
    point (the quantized image of 0.0, which also pads 'same' borders) is
    representable, gives the per-tensor affine calibration ``scale = (max
    - min) / 255`` and ``zp = clip(round(-128 - min / scale), -128,
    127)``; the weights are quantized per out channel
    (``ops.quantize_conv2d_weights``).  Returns ``{"packed":
    QuantizedConv2dWeights}``, which replaces ``{"w", "b"}`` and runs the
    int8 route through :func:`conv2d_apply`.  The scalar arithmetic runs
    on the CPU in f32, where division is exact-rounded as in JAX (on the
    card PyTorch divides by a Python scalar through its reciprocal).  The
    layer and the batch are f32: the int8 route quantizes f32 only.
    """
    for name, t in (("weights", p["w"]), ("sample batch", x_batch)):
        if t.dtype != torch.float32:
            raise TypeError(f"calibrate_conv2d takes f32 {name}, got "
                            f"{t.dtype}")
    xf = x_batch.float()
    lo = torch.clamp_max(xf.min(), 0.0).cpu()
    hi = torch.clamp_min(xf.max(), 0.0).cpu()
    scale = torch.clamp_min(hi - lo, 1e-12) / torch.tensor(255.0)
    zp = torch.clamp(torch.round(-128.0 - lo / scale), -128, 127) \
        .to(torch.int32)
    return {"packed": ops.quantize_conv2d_weights(
        p["w"], p.get("b"), x_scale=scale, x_zero_point=zp, groups=groups)}


def depthwise_separable_params(k: int, cin: int, cout: int, *,
                               bias: bool = True) -> dict:
    """MobileNet-style depthwise KxK + pointwise 1x1 block."""
    return {"dw": conv2d_params(k, cin, cin, groups=cin, bias=bias),
            "pw": conv2d_params(1, cin, cout, bias=bias)}


def depthwise_separable_pack_params(p: dict, *, x_shape=None,
                                    stride: int = 1) -> dict:
    """Load-time packing of a depthwise-separable block, both convs
    (``repro/models/layers.py:242``); the pointwise conv sees the
    depthwise conv's 'same' output."""
    cin = p["dw"]["w"].shape[3]
    dw_shape = pw_shape = x_shape
    if x_shape is not None and stride != 1:
        n, h, w, _ = x_shape
        pw_shape = (n, -(-h // stride), -(-w // stride), cin)
    return {"dw": conv2d_pack_params(p["dw"], groups=cin, x_shape=dw_shape,
                                     stride=stride),
            "pw": conv2d_pack_params(p["pw"], x_shape=pw_shape)}


def depthwise_separable_apply(p: dict, x: torch.Tensor, *, stride: int = 1,
                              activation: str | None = "relu",
                              impl: str = "trim") -> torch.Tensor:
    h = conv2d_apply(p["dw"], x, stride=stride, groups=x.shape[-1],
                     activation=activation, impl=impl)
    return conv2d_apply(p["pw"], h, activation=activation, impl=impl)


def simple_cnn_params(*, cin: int = 3, channels=(8, 16), n_classes: int = 10,
                      k: int = 3, depthwise_stage: bool = True) -> dict:
    """The small CIFAR-shaped classifier of ``examples/train_cnn.py``.

    Per stage: a stride-1 conv followed by a stride-2 "down" conv (pooling
    as a strided conv, so every op runs the differentiable TrIM kernels);
    ``depthwise_stage`` inserts a depthwise KxK before the last down conv
    so training runs the grouped backward too.  The head is global mean
    pooling + a dense projection.
    """
    p, prev = {}, cin
    for i, c in enumerate(channels):
        p[f"conv{i}"] = conv2d_params(k, prev, c)
        p[f"down{i}"] = conv2d_params(k, c, c)
        prev = c
    if depthwise_stage:
        p["dw"] = conv2d_params(k, prev, prev, groups=prev)
    p["head"] = {"w": Param((prev, n_classes)),
                 "b": Param((n_classes,), init="zeros")}
    return p


def simple_cnn_apply(p: dict, x: torch.Tensor, *,
                     impl: str = "trim") -> torch.Tensor:
    """Forward pass of :func:`simple_cnn_params`.  x: (N, H, W, Cin);
    returns (N, n_classes) logits.  The depthwise stage is applied iff the
    tree carries one (inferred from the tree, like the stage count)."""
    n_stages = sum(1 for k in p if k.startswith("conv"))
    for i in range(n_stages):
        x = conv2d_apply(p[f"conv{i}"], x, activation="relu", impl=impl)
        if "dw" in p and i == n_stages - 1:
            x = conv2d_apply(p["dw"], x, groups=x.shape[-1],
                             activation="relu", impl=impl)
        x = conv2d_apply(p[f"down{i}"], x, stride=2, activation="relu",
                         impl=impl)
    x = x.mean(dim=(1, 2))                        # global mean pool
    return x @ p["head"]["w"] + p["head"]["b"]


def cnn_params_from_layers(layers_list, *, n_classes: int | None = None,
                           bias: bool = True) -> dict:
    """Declarations for a whole conv topology: one ``conv{i}`` entry per
    layer; ``n_classes`` adds a global-mean-pool linear ``head``."""
    p = {}
    for i, l in enumerate(layers_list):
        p[f"conv{i}"] = conv2d_params(l.kernel, l.in_channels,
                                      l.out_channels, groups=l.groups,
                                      bias=bias)
    if n_classes is not None:
        d = layers_list[-1].out_channels
        p["head"] = {"w": Param((d, n_classes)),
                     "b": Param((n_classes,), init="zeros")}
    return p


def cnn_pack_params(p: dict, layers_list, *, n: int = 1) -> dict:
    """Load-time packing of a whole topology's conv weights
    (``repro/models/layers.py:334``): each layer of K <=
    ``ops.MAX_NATIVE_K`` becomes ``{"packed": PackedConv2dWeights}``
    keyed with the input it sees at batch ``n`` (its ``ifmap``: the
    pools between layers are in the topology's sizes), so after an
    ``autotune.tune_network`` sweep the packed forward runs on the tuned
    plans.  K > 8 layers keep their raw weights (the adder tree re-slices
    them); the head is kept as is."""
    packed = dict(p)
    for i, l in enumerate(layers_list):
        if l.kernel > ops.MAX_NATIVE_K:
            continue
        _, _, _, padding = layer_kernel_problem(l, n=n)
        packed[f"conv{i}"] = conv2d_pack_params(
            p[f"conv{i}"], groups=l.groups,
            x_shape=(n, l.ifmap, l.ifmap, l.in_channels), stride=l.stride,
            padding=padding)
    return packed


def cnn_head_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Global mean pool + linear, one row at a time: the reduction and
    matmul libraries pick their schedule by batch size, so a batched head
    could round a row differently from the same row served alone."""
    rows = [x[i:i + 1].mean(dim=(1, 2)) @ p["w"] + p["b"]
            for i in range(x.shape[0])]
    return torch.cat(rows)


def _apply_layer_range(p: dict, layers_list, pools, x: torch.Tensor, lo: int,
                       hi: int, *, activation, impl, dataflow) -> torch.Tensor:
    """Layers ``lo..hi-1`` on the per-layer path
    (``ops.conv_pool_chain``): one kernel launch per conv (bias +
    activation fused), then the layer's max pool."""
    idx = range(lo, hi)
    steps = [(layers_list[i].stride, layer_kernel_problem(layers_list[i])[3],
              layers_list[i].groups, *pools[i]) for i in idx]
    weights, biases = zip(*(_conv_operands(p[f"conv{i}"]) for i in idx))
    return ops.conv_pool_chain(x, weights, biases, steps,
                               activation=activation, impl=impl,
                               dataflow=dataflow)


def cnn_apply_from_layers(p: dict, layers_list, x: torch.Tensor, *,
                          activation: str | None = "relu",
                          impl: str = "trim", dataflow: str | None = None,
                          fused: bool = False,
                          fuse_plan: FusedGroupPlan | None = None
                          ) -> torch.Tensor:
    """Forward pass of a topology built by :func:`cnn_params_from_layers`:
    one kernel launch per conv layer (bias + activation fused), with the
    max pools inferred from the spatial dims between layers
    (``core.netplan.infer_pools``).  Returns class logits when the tree
    has a head, else the final feature map.

    ``fused=True`` runs each residency group of the
    :class:`~repro_torch.core.fuse_plan.FusedGroupPlan` built for ``x``'s
    batch as one launch of the fused kernel, interior activations in
    shared memory, each group on its ``conv2d_fused:`` record's tile where
    one exists (``use_autotune_cache=True``), planned for x's dtype (a
    bf16 x plans bf16 tiles); depth-1 groups run the
    per-layer path, and the output is bitwise the same either way.  Pass
    ``fuse_plan`` (implies ``fused=True``) to run a prebuilt plan, e.g.
    a segment's of a :class:`~repro_torch.core.fuse_plan.GraphFusePlan`.
    A group that fails raises: nothing falls back to per-layer
    execution.  The fused path needs raw ``{"w", "b"}`` conv params: a
    packed or calibrated layer in a fused group raises, as in JAX.
    """
    layers_list = list(layers_list)
    pools = list(infer_pools(layers_list))
    kw = dict(activation=activation, impl=impl, dataflow=dataflow)
    if not (fused or fuse_plan is not None):
        x = _apply_layer_range(p, layers_list, pools, x, 0,
                               len(layers_list), **kw)
    else:
        if impl != "trim":
            raise ValueError(f"fused execution runs the TrIM kernels; "
                             f"impl={impl!r} needs fused=False")
        plan = fuse_plan if fuse_plan is not None else \
            FusedGroupPlan.build(
                layers_list, n=x.shape[0], use_autotune_cache=True,
                device=x.device,
                dtype_bytes=2 if x.dtype == torch.bfloat16 else 4)
        for g in plan.groups:
            lo, hi = g.start, g.start + g.depth
            if not g.fused:
                x = _apply_layer_range(p, layers_list, pools, x, lo, hi, **kw)
                continue
            weights, biases = [], []
            for i in range(lo, hi):
                lp = p[f"conv{i}"]
                if "packed" in lp:
                    raise ValueError(
                        f"conv{i}: fused execution needs raw conv params "
                        "({'w', 'b'}); packed trees freeze the per-layer "
                        "kernel knobs (skip cnn_pack_params on the fused "
                        "path)")
                weights.append(lp["w"])
                biases.append(lp.get("b"))
            x = fused_group_apply(x, weights, biases, group=g,
                                  activation=activation)
    if "head" not in p:
        return x
    return cnn_head_apply(p["head"], x)


def cnn_params_from_graph(graph, *, n_classes: int | None = None,
                          bias: bool = True) -> dict:
    """Declarations for a DAG topology (``repro/models/layers.py:472``):
    ``graph`` is anything ``core.netplan.graph_nodes`` resolves (a name,
    "resnet18" | "unet", a ``list[GraphNode]`` or a linear topology).  One
    entry per conv node, keyed by the node's name; joins carry no
    params.  ``n_classes`` adds a global-mean-pool linear ``head`` over
    the terminal node's channels, so no node may be called "head"."""
    nodes = graph_nodes(graph)
    p, ch = {}, {}
    for nd in nodes:
        if nd.name == "head":
            raise ValueError(
                'node name "head" is reserved for the linear classifier '
                "head — rename the graph node")
        if nd.op == "conv":
            l = nd.layer
            p[nd.name] = conv2d_params(l.kernel, l.in_channels,
                                       l.out_channels, groups=l.groups,
                                       bias=bias)
            ch[nd.name] = l.out_channels
        elif nd.op == "concat":
            ch[nd.name] = sum(ch[s] for s in nd.inputs)
        else:
            ch[nd.name] = ch[nd.inputs[0]]
    if n_classes is not None:
        d = ch[nodes[-1].name]
        p["head"] = {"w": Param((d, n_classes)),
                     "b": Param((n_classes,), init="zeros")}
    return p


def cnn_pack_params_from_graph(p: dict, graph, *, n: int = 1) -> dict:
    """Load-time packing of a DAG topology's conv weights
    (``repro/models/layers.py:507``), the graph analogue of
    :func:`cnn_pack_params`: each conv node of K <= ``ops.MAX_NATIVE_K``
    is packed with the input it sees at batch ``n``, so after an
    ``autotune.tune_graph`` sweep the packed forward runs on the tuned
    plans; K > 8 nodes and the head are kept as they are."""
    packed = dict(p)
    for nd in graph_nodes(graph):
        if nd.op != "conv" or nd.layer.kernel > ops.MAX_NATIVE_K:
            continue
        l = nd.layer
        _, _, _, padding = layer_kernel_problem(l, n=n)
        packed[nd.name] = conv2d_pack_params(
            p[nd.name], groups=l.groups,
            x_shape=(n, l.ifmap, l.ifmap, l.in_channels), stride=l.stride,
            padding=padding)
    return packed


def _upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour spatial upsampling of an NHWC tensor (the U-Net
    decoder's)."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def _graph_conv_node(p: dict, nd, x: torch.Tensor, *, activation, impl,
                     dataflow) -> torch.Tensor:
    """One graph conv node on the per-layer path
    (``ops.conv_pool_chain``): the conv (padding from the shared layer ->
    executed-problem mapping) and its epilogue pool."""
    l = nd.layer
    _, _, _, padding = layer_kernel_problem(l, n=x.shape[0])
    w, b = _conv_operands(p[nd.name])
    return ops.conv_pool_chain(
        x, [w], [b], [(l.stride, padding, l.groups, nd.pool,
                       nd.pool_window)],
        activation=activation, impl=impl, dataflow=dataflow)


def cnn_apply_from_graph(p: dict, graph, x: torch.Tensor, *,
                         activation: str | None = "relu",
                         impl: str = "trim", dataflow: str | None = None,
                         fused: bool = False,
                         fuse_plan=None) -> torch.Tensor:
    """Forward pass of a DAG topology built by
    :func:`cnn_params_from_graph` (``repro/models/layers.py:546``).

    Nodes run in topological order: conv nodes on the per-layer path
    (one kernel launch each, bias + activation fused, then the node's
    pool), ``pool`` nodes as the chain's max pool, ``add`` as the sum of
    its inputs in input order (out of place), ``concat`` on the channel
    axis, ``upsample`` nearest-neighbour.  Returns the terminal node's
    activation, or class logits (:func:`cnn_head_apply`) when the tree
    has a head.

    ``fused=True`` cuts the graph into its fusable linear segments
    (``core.fuse_plan.graph_segments``) and runs each segment of two or
    more convs through :func:`cnn_apply_from_layers` with ``fused=True``
    (its residency groups in one launch each), so fused and per-node
    outputs are bitwise equal.  ``fuse_plan`` (a prebuilt
    :class:`~repro_torch.core.fuse_plan.GraphFusePlan`, implying
    ``fused=True``) reuses its segment plans.  The fused path runs the
    TrIM kernels (``impl="trim"``) on raw conv params."""
    nodes = graph_nodes(graph)
    by = {nd.name: nd for nd in nodes}
    seg_of: dict[str, tuple] = {}
    if fused or fuse_plan is not None:
        if impl != "trim":
            raise ValueError(f"fused execution runs the TrIM kernels; "
                             f"impl={impl!r} needs fused=False")
        segs = list(fuse_plan.segments) if fuse_plan is not None else \
            [(names, None) for names, _ in graph_segments(nodes)]
        seg_of = {names[0]: (names, plan) for names, plan in segs}
    kw = dict(activation=activation, impl=impl, dataflow=dataflow)
    outs: dict[str, torch.Tensor] = {}
    executed: set[str] = set()
    last = None
    for nd in nodes:
        if nd.name in executed:
            continue
        if nd.name in seg_of and len(seg_of[nd.name][0]) > 1:
            names, plan = seg_of[nd.name]
            seg = [by[nm] for nm in names]
            convs = [sn for sn in seg if sn.op == "conv"]
            xin = outs[seg[0].inputs[0]] if seg[0].inputs else x
            y = cnn_apply_from_layers(
                {f"conv{i}": p[sn.name] for i, sn in enumerate(convs)},
                [sn.layer for sn in convs], xin, fused=True,
                fuse_plan=plan, **kw)
            tail = seg[-1]
            if tail.pool > 1 or tail.pool_window > 1:
                y = ref.maxpool2d(y, tail.pool, tail.pool_window)
            executed.update(names)
            outs[tail.name] = y
            last = tail.name
            continue
        if nd.op == "conv":
            xin = outs[nd.inputs[0]] if nd.inputs else x
            y = _graph_conv_node(p, nd, xin, **kw)
        elif nd.op == "pool":
            y = ref.maxpool2d(outs[nd.inputs[0]], nd.pool, nd.pool_window)
        elif nd.op == "add":
            y = outs[nd.inputs[0]]
            for s in nd.inputs[1:]:
                y = y + outs[s]
        elif nd.op == "concat":
            y = torch.cat([outs[s] for s in nd.inputs], dim=-1)
        else:                                     # upsample
            y = _upsample_nearest(outs[nd.inputs[0]], nd.scale)
        outs[nd.name] = y
        executed.add(nd.name)
        last = nd.name
    y = outs[last]
    if "head" not in p:
        return y
    return cnn_head_apply(p["head"], y)


class _Leaf(nn.Module):
    """One ``{"w", "b"}`` entry of the tree as parameters, frozen unless
    ``trainable``."""

    def __init__(self, leaf: dict, trainable: bool):
        super().__init__()
        for name, t in leaf.items():
            self.register_parameter(
                name, nn.Parameter(t, requires_grad=trainable))

    def entry(self) -> dict:
        return dict(self.named_parameters())


class _QuantLeaf(nn.Module):
    """One calibrated ``{"packed": QuantizedConv2dWeights}`` entry: its
    tensors as buffers in their own dtypes (int8 weights, int32 zero
    point, f32 scales), moved with the module; ``entry`` rebuilds the
    container from them without repacking."""

    def __init__(self, pk: ops.QuantizedConv2dWeights):
        super().__init__()
        self.groups, self.cout, self.zp = pk.groups, pk.cout, pk.zp
        for name, t in pk.tensors().items():
            self.register_buffer(name, t)

    def entry(self) -> dict:
        bufs = dict(self.named_buffers())
        bufs.setdefault("bias", None)
        return {"packed": ops.QuantizedConv2dWeights(
            groups=self.groups, cout=self.cout, zp=self.zp, **bufs)}


class _PackedLeaf(nn.Module):
    """One packed f32 ``{"packed": PackedConv2dWeights}`` entry: its
    weight and bias as frozen parameters, its knob hints as attributes;
    ``entry`` rebuilds the container."""

    def __init__(self, pk: ops.PackedConv2dWeights):
        super().__init__()
        self.groups, self.cout = pk.groups, pk.cout
        self.hints = dict(tile_cout=pk.tile_cout, tile_h=pk.tile_h,
                          dataflow=pk.dataflow)
        for name, t in pk.tensors().items():
            self.register_parameter(
                name, nn.Parameter(t, requires_grad=False))

    def entry(self) -> dict:
        return {"packed": ops.PackedConv2dWeights(
            w=self.w, bias=getattr(self, "bias", None), groups=self.groups,
            cout=self.cout, **self.hints)}


def _is_graph(topology) -> bool:
    """A DAG topology: a name from ``netplan.GRAPHS`` or a
    ``list[GraphNode]``."""
    if isinstance(topology, str):
        return topology in GRAPHS
    nodes = list(topology)
    return bool(nodes) and isinstance(nodes[0], GraphNode)


class TrimCNN(nn.Module):
    """A conv topology with its parameters, served or trained on the TrIM
    kernels.

    ``topology`` is a linear chain (a name from ``netplan.NETWORKS`` or a
    ``list[ConvLayer]``), run by :func:`cnn_apply_from_layers`, or a DAG
    (a name from ``netplan.GRAPHS``, "resnet18" | "unet", or a
    ``list[GraphNode]``), run by :func:`cnn_apply_from_graph`.
    ``params`` is the tree of :func:`cnn_params_from_layers` (``{"conv{i}":
    {"w", "b"}, "head": {"w", "b"}}``) or :func:`cnn_params_from_graph`
    (keyed by node name) as tensors, e.g. from :meth:`random` or
    ``repro_torch.convert.params_from_jax``; the module lives on their
    device.  ``dataflow`` picks the conv kernel (``None`` is
    ``"carry"``); ``fused=True`` runs fused residency groups (a chain's,
    or each graph segment's).  The parameters are frozen for serving;
    ``trainable=True`` registers them with ``requires_grad``, so a loss on
    :meth:`forward` back-propagates through the TrIM backward kernels.
    Packed entries (``{"packed"}``: :func:`cnn_pack_params`,
    :func:`cnn_pack_params_from_graph`, or :func:`calibrate_conv2d`,
    whose tensors are held as buffers and serve the int8 route) run per
    layer and are inference only: with them ``trainable=True`` and
    ``fused=True`` raise.
    """

    def __init__(self, topology, params: dict, *,
                 activation: str | None = "relu", impl: str = "trim",
                 dataflow: str | None = None, trainable: bool = False,
                 fused: bool = False):
        super().__init__()
        # graph: the DAG's nodes, or None for a chain (``layers_list``)
        self.graph = graph_nodes(topology) if _is_graph(topology) else None
        self.layers_list = None if self.graph is not None else \
            network_layers(topology)
        self.activation, self.impl, self.dataflow = activation, impl, dataflow
        self.fused = fused
        packed = sorted(k for k, v in params.items() if "packed" in v)
        if packed and (trainable or fused):
            raise ValueError(
                f"{packed[0]} is packed or calibrated (int8): packed "
                "entries are inference only and run per layer; "
                "trainable=True and fused=True need raw {'w', 'b'} conv "
                "params")

        def leaf(v):
            if "packed" not in v:
                return _Leaf(v, trainable)
            if isinstance(v["packed"], ops.PackedConv2dWeights):
                return _PackedLeaf(v["packed"])
            return _QuantLeaf(v["packed"])
        self.params = nn.ModuleDict({k: leaf(v) for k, v in params.items()})

    @classmethod
    def random(cls, topology, *, n_classes: int | None = None,
               seed: int = 0, device=None, dtype=torch.float32,
               **kw) -> "TrimCNN":
        """Seeded random weights (``torch.Generator().manual_seed(seed)``)
        on ``device`` (default ``"cuda"``); ``dtype=torch.bfloat16`` casts
        the same f32 draws to bf16 once."""
        dev = resolve_device(device)
        decl = (cnn_params_from_graph(topology, n_classes=n_classes)
                if _is_graph(topology) else
                cnn_params_from_layers(network_layers(topology),
                                       n_classes=n_classes))
        tree = init_params(decl, torch.Generator().manual_seed(seed),
                           device=dev, dtype=dtype)
        return cls(topology, tree, **kw)

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype the module computes in: its first float
        parameter's (f32 for a calibrated int8 tree, whose activations
        enter in f32)."""
        for t in self.parameters():
            if t.dtype.is_floating_point:
                return t.dtype
        return torch.float32

    def tree(self) -> dict:
        """The parameters as the functional tree."""
        return {k: m.entry() for k, m in self.params.items()}

    def apply_tree(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The forward on a given parameter tree (the functional form a
        trainer steps: ``launch.train_cnn.train_step``'s ``apply_fn``)."""
        kw = dict(activation=self.activation, impl=self.impl,
                  dataflow=self.dataflow, fused=self.fused)
        if self.graph is not None:
            return cnn_apply_from_graph(params, self.graph, x, **kw)
        return cnn_apply_from_layers(params, self.layers_list, x, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_tree(self.tree(), x)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_params(cfg: ModelConfig, d: int | None = None) -> dict:
    """Scale (and LayerNorm's bias), f32 in a model of any dtype, as
    JAX pins them (``repro/models/layers.py:27-31``)."""
    d = d or cfg.d_model
    p = {"scale": Param((d,), init="ones", dtype=torch.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = Param((d,), init="zeros", dtype=torch.float32)
    return p


def norm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last dim, in f32, eps 1e-6."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved).  x: (B, L, H,
    D); positions: (B, L) or (1, L)."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d // 2, dtype=torch.float32,
                             device=x.device) / (d // 2)
    freqs = torch.pow(theta, exponent)
    angles = positions.float()[..., None] * freqs          # (B, L, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (self- or cross-), with an optional KV cache
# ---------------------------------------------------------------------------

def attention_params(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": Param((d, h, hd)), "wk": Param((d, kv, hd)),
         "wv": Param((d, kv, hd)), "wo": Param((h, hd, d))}
    if cfg.qkv_bias:
        p["bq"] = Param((h, hd), init="zeros")
        p["bk"] = Param((kv, hd), init="zeros")
        p["bv"] = Param((kv, hd), init="zeros")
    return p


def attention_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor | None = None,
                    kv_cache: tuple | None = None,
                    cache_len: torch.Tensor | None = None,
                    causal: bool = True,
                    window: int | None = None,
                    encoder_out: torch.Tensor | None = None,
                    is_cross: bool = False,
                    use_rope: bool = True) -> torch.Tensor:
    """Self- or cross-attention of ``repro/models/layers.py:84``; returns
    y.

    * prefill: ``kv_cache`` is None; ``ops.attention`` with
      ``impl=cfg.attn_impl`` over ``x`` (no cache is threaded through the
      stack), causal unless ``causal=False`` (the encoder); with
      ``encoder_out`` (cross-attention) k and v are projected from it and
      the call is non-causal.
    * decode: ``kv_cache=(k, v)`` of shape (B, Lmax, Hkv, hd).  Self-
      attention writes the new token's k/v at ``max(cache_len) - 1`` IN
      PLACE (the JAX function returns updated copies), then
      ``ops.decode_attention``; cross-attention (``is_cross``) reads the
      static cache, projects no k/v and writes nothing, through
      ``ops.attention(..., causal=False, impl="ref")`` as JAX does.

    RoPE (over ``positions``, default ``arange(Lq)``) rotates q and k of
    self-attention where ``use_rope``; cross-attention takes none.
    """
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if is_cross and kv_cache is not None:
        k = v = None                  # static encoder K/V: nothing to project
    else:
        src = x if encoder_out is None else encoder_out
        k = torch.einsum("bld,dhk->blhk", src, p["wk"])
        v = torch.einsum("bld,dhk->blhk", src, p["wv"])
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
    if use_rope and not is_cross:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        kc, vc = kv_cache
        if is_cross:
            o = ops.attention(q, kc, vc, causal=False,
                              soft_cap=cfg.logits_soft_cap, impl="ref")
        else:
            idx = (cache_len.max() - 1).reshape(1).long()  # stays on device
            kc.index_copy_(1, idx, k)
            vc.index_copy_(1, idx, v)
            o = ops.decode_attention(q, kc, vc, cache_len,
                                     soft_cap=cfg.logits_soft_cap,
                                     window=window)
    else:
        o = ops.attention(q, k, v, causal=causal and encoder_out is None,
                          soft_cap=cfg.logits_soft_cap, window=window,
                          impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return torch.einsum("blhk,hkd->bld", o, p["wo"])


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------

def mlp_params(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": Param((d, f)), "w_up": Param((d, f)),
                "w_down": Param((f, d))}
    return {"w_up": Param((d, f)), "b_up": Param((f,), init="zeros"),
            "w_down": Param((f, d)), "b_down": Param((d,), init="zeros")}


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """swiglu, geglu or gelu (with biases); gelu is the tanh form of
    ``jax.nn.gelu``."""
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-grouped matmul)
# ---------------------------------------------------------------------------

def moe_params(cfg: ModelConfig) -> dict:
    """The router (scale 0.1), the experts' SwiGLU weights ``w_gate`` /
    ``w_up`` (e, d, f) and ``w_down`` (e, f, d), each drawn a leading
    slice at a time (``Param.sliced``), each with its experts axis marked
    (``Param.experts``), and, with ``shared_expert_dff``,
    a dense ``shared`` expert (``repro/models/layers.py:668``)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_dff
    p = {"router": Param((d, e), scale=0.1, experts=True),
         "w_gate": Param((e, d, f), sliced=True, experts=True),
         "w_up": Param((e, d, f), sliced=True, experts=True),
         "w_down": Param((e, f, d), sliced=True, experts=True)}
    if cfg.shared_expert_dff:
        fs = cfg.shared_expert_dff
        p["shared"] = {"w_gate": Param((d, fs)), "w_up": Param((d, fs)),
                       "w_down": Param((fs, d))}
    return p


def moe_top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis -> (values, indices): the k
    largest, largest first, the lower index first among equal values.  A
    stable descending sort gives that order; ``torch.topk`` promises none
    among ties, and bf16 router logits tie often across 128 experts."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(gate_idx: torch.Tensor, n_experts: int, cap: int):
    """JAX's ``_dispatch_one`` (``repro/models/layers.py:712``) over all
    groups at once, in integers.  ``gate_idx`` (g, tg, k) holds each
    token's experts.  The g x tg x k choices (choice ``c = t * k + j``)
    are ordered by expert with a stable sort, as ``jnp.argsort`` orders
    them; each takes its expert's next buffer row (``expert * cap +
    rank``) while the expert's ``cap`` rows last, and is dropped after.
    Returns

    * ``rows`` (g, tg, k): the buffer row of each token's choices, the
      choices in ascending expert order (the order in which JAX's
      ``.at[tok].add`` sums a token's contributions); ``e * cap`` where
      dropped;
    * ``by_expert`` (g, tg, k): the choice index ``j`` of each entry of
      ``rows``;
    * ``src`` (g, e * cap): the token that fills each buffer row, ``tg``
      where the row stays empty;
    * ``back`` (g, e * cap): the flat index (``t * k + i``) of the entry
      of ``rows`` that names each buffer row, ``tg * k`` where empty;
    * ``counts`` (g, e): the choices of each expert before drops."""
    g, tg, k = gate_idx.shape
    e, n, dev = n_experts, tg * k, gate_idx.device
    flat = gate_idx.reshape(g, n)
    order = torch.argsort(flat, dim=-1, stable=True)
    seg = flat.gather(1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(n, device=dev) - starts.gather(1, seg)
    slot = torch.where(rank < cap, seg * cap + rank, e * cap)
    slot = torch.empty_like(slot).scatter_(1, order, slot)   # choice order
    by_expert = torch.argsort(gate_idx, dim=-1)   # a token's experts differ
    rows = slot.reshape(g, tg, k).gather(2, by_expert)
    # buffer row (expert, r) takes sorted choice starts + r, if there is one
    r = torch.arange(cap, device=dev)
    filled = (r < counts[:, :, None]).reshape(g, e * cap)
    c = order.gather(1, (starts[:, :, None] + r).reshape(g, e * cap)
                     .clamp(max=n - 1))
    src = torch.where(filled, c // k, tg)
    at = torch.empty_like(by_expert).scatter_(
        2, by_expert, torch.arange(k, device=dev).expand(g, tg, k))
    at = at + k * torch.arange(tg, device=dev)[:, None]
    back = torch.where(filled, at.reshape(g, n).gather(1, c), n)
    return rows, by_expert, src, back, counts


def _rows_of(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (g, m) of ``src`` (g, R, d); index R reads zeros."""
    g, _, d = src.shape
    pad = torch.cat([src, src.new_zeros((g, 1, d))], dim=1)
    return pad.gather(1, idx[..., None].expand(-1, -1, d))


class _GatherRows(torch.autograd.Function):
    """``out[g, i] = src[g, idx[g, i]]`` over rows (a zero row where
    ``idx`` is ``src.shape[1]``).  Its gradient is a gather as well: row r
    of ``src`` sums the cotangent's rows ``inv[g, r, :]`` (``out.shape[1]``:
    none) in that order, one add at a time.  Autograd of a plain gather
    would scatter-add, which sums a row read k times (a token's k
    choices) with float atomics on the card, in no fixed order."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _rows_of(src, idx)

    @staticmethod
    def backward(ctx, dout):
        inv, = ctx.saved_tensors
        dsrc = _rows_of(dout, inv[..., 0])
        for j in range(1, inv.shape[-1]):
            dsrc = dsrc + _rows_of(dout, inv[..., j])
        return dsrc, None, None


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """GShard-style token-choice top-k with grouped capacity dispatch
    (``repro/models/layers.py:685``) -> (y, aux).

    A group is a sequence (one group over the batch at decode, ``s ==
    1``), of ``cap = max(ceil(tg k / e capacity_factor), 1)`` buffer rows
    an expert.  The router's logits are taken in the activations' dtype,
    then in f32 (float64 stays float64), softmax; :func:`moe_top_k` picks
    each token's experts, their gates renormalised (clipped at 1e-9);
    :func:`moe_dispatch` assigns rows; the experts run as three batched
    products over the (g, e, cap, d) buffer (``torch.einsum``, as JAX's
    ``einsum``: no Pallas kernel there); each token sums its kept
    contributions (gate x expert output, in the activations' dtype) from
    zeros in ascending expert order, one rounding an add, as XLA's serial
    scatter-add does.  The dispatch gather and the combine's read of the
    expert outputs are :class:`_GatherRows`, so the backward holds no
    float atomics; every other gather here reads an element at most
    once, so its backward adds one value into each zero.  ``aux`` is the
    Switch load-balance loss: ``e`` x the groups' mean of the sum over
    experts of (mean router probability x share of the choices, drops
    included); its gradient flows through the probabilities only."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xg = x.reshape(1, b, d) if s == 1 else x
    g, tg, _ = xg.shape
    logits = torch.einsum("gtd,de->gte", xg, p["router"])
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = moe_top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(int(math.ceil(tg * k / e * cfg.capacity_factor)), 1)
    with torch.no_grad():
        rows, by_expert, src, back, counts = moe_dispatch(gate_idx, e, cap)
    buf = _GatherRows.apply(xg, src, rows).reshape(g, e, cap, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    yexp = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    part = _GatherRows.apply(yexp.reshape(g, e * cap, d),
                             rows.reshape(g, tg * k), back[..., None])
    gts = gate_vals.to(x.dtype).gather(2, by_expert)
    part = part.reshape(g, tg, k, d) * gts[..., None]
    y = torch.zeros((g, tg, d), dtype=x.dtype, device=x.device)
    for i in range(k):
        y = y + part[:, :, i]
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xg, cfg)
    me = probs.mean(dim=1)                                   # (g, e)
    ce = counts.to(probs.dtype) / (tg * k)
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embedding_params(cfg: ModelConfig) -> dict:
    p = {"embed": Param((cfg.vocab, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["head"] = Param((cfg.d_model, cfg.vocab))
    return p


def embed_apply(p: dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens, p["embed"])


def head_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LM head, tied (``embed.T``) or untied; a plain ``torch.matmul``,
    which JAX leaves to XLA too."""
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    return x @ w
