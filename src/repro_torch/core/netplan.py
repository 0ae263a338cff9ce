"""Topology helpers of the network planner (copied from
``repro/core/netplan.py``): resolve and scale a topology (a linear chain
or a DAG of :class:`~repro_torch.core.model.GraphNode`), infer the max
pools between its layers, and map a layer to the conv problem the
execution path runs.  The network accounting (``NetworkPlan``,
``NetworkGraph``) stays with the JAX package: it bills the TPU plan's
HBM model, which the port's Hopper ``ConvPlan`` does not have.
"""

from __future__ import annotations

import math
from dataclasses import replace as _dc_replace

from repro_torch.core.model import (ConvLayer, GraphNode, alexnet_layers,
                                    mobilenet_layers, resnet18_graph,
                                    unet_graph, vgg16_layers)
from repro_torch.kernels.ops import kernel_input_shape

NETWORKS = {"vgg16": vgg16_layers, "alexnet": alexnet_layers,
            "mobilenet": mobilenet_layers}

# DAG topologies: name -> builder returning list[GraphNode] (topological
# order).  Linear chains from NETWORKS convert through
# linear_graph_nodes().
GRAPHS = {"resnet18": resnet18_graph, "unet": unet_graph}


def network_layers(network) -> list[ConvLayer]:
    """Resolve a topology: a name from :data:`NETWORKS` ("vgg16",
    "alexnet", "mobilenet") or an explicit ``list[ConvLayer]`` passed
    through unchanged."""
    if isinstance(network, str):
        if network not in NETWORKS:
            raise ValueError(
                f"unknown network {network!r}; have {sorted(NETWORKS)}")
        return NETWORKS[network]()
    return list(network)


def scale_layers(layers, scale: int) -> list[ConvLayer]:
    """Shrink a topology's channel counts by ``scale`` (spatial dims and
    kernels unchanged) — the reduced configuration the CPU examples
    execute while the accounting uses the full-scale plans.  The first
    layer's input channels (the image) are kept; grouped layers keep
    ``groups == channels`` (depthwise stays depthwise)."""
    if scale <= 1:
        return list(layers)
    out: list[ConvLayer] = []
    prev_out: int | None = None
    for l in layers:
        cin = l.in_channels if prev_out is None else prev_out
        cout = max(1, l.out_channels // scale)
        if l.groups == l.in_channels and l.groups > 1:
            groups = cin                 # depthwise stays depthwise
        else:
            groups = math.gcd(l.groups, cin)   # must still divide cin
        if groups > 1:
            cout = -(-cout // groups) * groups  # round up to a multiple
        out.append(ConvLayer(name=l.name, ifmap=l.ifmap, in_channels=cin,
                             out_channels=cout, kernel=l.kernel,
                             stride=l.stride, padding=l.padding,
                             groups=groups))
        prev_out = cout
    return out


class PoolInferenceError(ValueError):
    """Spatial dims at a chain boundary cannot be explained by a
    plausible max pool — only a strided/dilated conv join (or, for
    ``reason="upsample"``, an explicit upsampling node) could produce
    them.  Subclasses ``ValueError`` so existing chainability handling
    keeps working; carries the boundary as structured fields so callers
    (and the unet wiring this was found on) can report *which* edge is
    miswired instead of silently planning a different network."""

    #: largest pool stride / window-overhang infer_pools will accept as a
    #: genuine pool rather than a disguised strided join.  Every real
    #: topology boundary in the zoo is within (VGG 2x2/s2, AlexNet
    #: 3x3/s2, sub-2x 3x3/s1, ResNet/U-Net 2x2/s2).
    MAX_STRIDE = 4
    MAX_OVERHANG = 2

    def __init__(self, msg: str, *, producer: str, consumer: str,
                 out_size: int, in_size: int, reason: str,
                 stride: int | None = None, window: int | None = None):
        super().__init__(msg)
        self.producer = producer
        self.consumer = consumer
        self.out_size = out_size
        self.in_size = in_size
        self.reason = reason
        self.stride = stride
        self.window = window


def pool_between(layer: ConvLayer, nxt: ConvLayer) -> tuple[int, int]:
    """Pooling ``(stride, window)`` between two consecutive conv layers,
    inferred from the topology's spatial dims: ``stride = out // next_in``
    and ``window = out - stride * (next_in - 1)`` — this recovers VGG's
    2x2/s2 and AlexNet's overlapping 3x3/s2 max pooling exactly.
    ``(1, 1)`` means no pooling at this boundary; a sub-2x boundary
    (e.g. 5 -> 3) resolves to a genuine stride-1 overlapping pool.

    Raises :class:`PoolInferenceError` when the dims admit no plausible
    pool: a growing boundary (``out < in`` — only an upsampling join
    explains it) or one whose inferred stride/window exceed the
    :attr:`PoolInferenceError.MAX_STRIDE` /
    ``stride + MAX_OVERHANG`` plausibility caps (only a strided or
    dilated join explains it).  Any ``o >= i`` pair *can* be written as
    ``(s, w) = (o // i, o - s*(i-1))``, so without the caps a miswired
    edge would silently plan a wildly subsampling "pool" that the
    topology never contained."""
    o, i = layer.out_size, nxt.ifmap
    if o == i:
        return 1, 1
    if o < i:
        raise PoolInferenceError(
            f"layer {layer.name} ofmap {o} smaller than {nxt.name} "
            f"ifmap {i}: not a chainable topology (only an upsampling "
            f"join can explain these dims — add an explicit 'upsample' "
            f"GraphNode)",
            producer=layer.name, consumer=nxt.name, out_size=o, in_size=i,
            reason="upsample")
    s = o // i
    w = o - s * (i - 1)
    if s > PoolInferenceError.MAX_STRIDE \
            or w > s + PoolInferenceError.MAX_OVERHANG:
        raise PoolInferenceError(
            f"boundary {layer.name}({o}) -> {nxt.name}({i}) implies a "
            f"{w}x{w}/s{s} pool — beyond the plausibility caps "
            f"(stride <= {PoolInferenceError.MAX_STRIDE}, window <= "
            f"stride + {PoolInferenceError.MAX_OVERHANG}); only a "
            f"strided or dilated conv join can explain these dims",
            producer=layer.name, consumer=nxt.name, out_size=o, in_size=i,
            reason="strided-join", stride=s, window=w)
    assert pooled_out_size(o, s, w) == i, (o, i, s, w)
    return s, w


def infer_pools(layers) -> list[tuple[int, int]]:
    """Per-layer pooling ``(stride, window)`` list (last layer: (1, 1))."""
    out = [pool_between(a, b) for a, b in zip(layers, layers[1:])]
    return out + [(1, 1)]


def pooled_out_size(h_out: int, stride: int, window: int) -> int:
    """Spatial size after the (stride, window) max pool — the single
    place the pooled-size rule lives (LayerStep.out_size and the
    residency decision in NetworkPlan.build both read it).  ``(1, 1)``
    is the no-pool identity; ``(1, window > 1)`` is a genuine stride-1
    overlapping pool (a sub-2x boundary like 5 -> 3 via 3x3/s1)."""
    if stride == 1 and window == 1:
        return h_out
    return (h_out - window) // stride + 1


def layer_kernel_problem(layer: ConvLayer, *, n: int = 1):
    """The conv problem ``ops.conv2d`` actually executes for one
    topology layer: ``(x_shape, pad, w_shape, padding)`` with
    ``x_shape`` the kernel-seen input (the ``padding`` mode's pre-pad
    folded in), ``pad`` the residual symmetric padding (0) and
    ``padding`` the ``ops.conv2d`` argument (``"same"`` for
    ``layer.padding > 0``, else ``"valid"``).

    This is the single place the layer -> executed-problem mapping
    lives: ``models/layers.py cnn_apply_from_layers`` runs the
    ``padding`` mode it returns.

    Raises ``ValueError`` when the layer's symmetric paper padding is
    not reproduced by that mode (executed output size would differ from
    ``layer.out_size``) — the execution engine supports
    'same'-equivalent or zero padding, and anything else must fail
    loudly instead of silently running a different network.
    """
    padding = "same" if layer.padding else "valid"
    x_shape, pad = kernel_input_shape(
        (n, layer.ifmap, layer.ifmap, layer.in_channels), layer.kernel,
        layer.stride, padding)
    out = (x_shape[1] + 2 * pad - layer.kernel) // layer.stride + 1
    if out != layer.out_size:
        raise ValueError(
            f"layer {layer.name}: padding={layer.padding} is not "
            f"{padding!r}-equivalent (executed output {out} != planned "
            f"{layer.out_size}); the execution engine runs 'same' or "
            f"zero padding only")
    w_shape = (layer.kernel, layer.kernel,
               layer.in_channels // layer.groups, layer.out_channels)
    return x_shape, pad, w_shape, padding


# ---------------------------------------------------------------------------
# DAG topology helpers
# ---------------------------------------------------------------------------

def linear_graph_nodes(network) -> list[GraphNode]:
    """A linear topology (name or ``list[ConvLayer]``) as graph nodes:
    one conv node per layer, chained in order, with the inter-layer max
    pools folded onto each conv as its epilogue (the chain's own view:
    ``models.layers.cnn_apply_from_graph`` on these nodes computes
    ``cnn_apply_from_layers``)."""
    layers = network_layers(network)
    pools = infer_pools(layers)
    nodes: list[GraphNode] = []
    prev: str | None = None
    for l, (ps, pw) in zip(layers, pools):
        nodes.append(GraphNode(l.name, "conv", (prev,) if prev else (),
                               l, pool=ps, pool_window=pw))
        prev = l.name
    return nodes


def graph_nodes(graph) -> list[GraphNode]:
    """Resolve a DAG topology: a name from :data:`GRAPHS` ("resnet18",
    "unet"), a name from :data:`NETWORKS` or an explicit
    ``list[ConvLayer]`` (converted by :func:`linear_graph_nodes`), or an
    explicit ``list[GraphNode]`` passed through unchanged."""
    if isinstance(graph, str):
        if graph in GRAPHS:
            return GRAPHS[graph]()
        if graph in NETWORKS:
            return linear_graph_nodes(graph)
        raise ValueError(f"unknown network {graph!r}; have "
                         f"{sorted(GRAPHS) + sorted(NETWORKS)}")
    nodes = list(graph)
    if nodes and isinstance(nodes[0], ConvLayer):
        return linear_graph_nodes(nodes)
    return nodes


def scale_graph(graph, scale: int) -> list[GraphNode]:
    """Channel-shrink a DAG topology by ``scale`` (spatial dims and
    kernels unchanged) — the graph analogue of :func:`scale_layers`.
    Channels are recomputed in topological order (concat sums its
    inputs, joins pass through), so add/concat joins stay consistent
    after scaling."""
    nodes = graph_nodes(graph)
    if scale <= 1:
        return nodes
    ch: dict[str, int] = {}
    out: list[GraphNode] = []
    for nd in nodes:
        if nd.op == "conv":
            l = nd.layer
            cin = ch[nd.inputs[0]] if nd.inputs else l.in_channels
            cout = max(1, l.out_channels // scale)
            if l.groups == l.in_channels and l.groups > 1:
                groups = cin                 # depthwise stays depthwise
            else:
                groups = math.gcd(l.groups, cin)
            if groups > 1:
                cout = -(-cout // groups) * groups
            out.append(_dc_replace(nd, layer=_dc_replace(
                l, in_channels=cin, out_channels=cout, groups=groups)))
            ch[nd.name] = cout
        else:
            out.append(nd)
            if nd.op == "concat":
                ch[nd.name] = sum(ch[s] for s in nd.inputs)
            else:
                ch[nd.name] = ch[nd.inputs[0]]
    return out
