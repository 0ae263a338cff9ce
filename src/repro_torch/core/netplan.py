"""Whole-network planning (the counterpart of ``repro/core/netplan.py``;
DESIGN.md §7).

Topology helpers: resolve and scale a topology (a linear chain or a DAG
of :class:`~repro_torch.core.model.GraphNode`), infer the max pools
between its layers, and map a layer to the conv problem the execution
path runs.

The network accounting chains the per-layer plans into the paper's
network view (up to 3.37x more operations per memory access for 3D-TrIM
than for TrIM on VGG-16 and AlexNet, arXiv:2502.18983 §V):

* :class:`LayerStep` — one conv layer: the H100 kernel's
  :class:`~repro_torch.core.conv_plan.ConvPlan` plus the inter-layer
  decisions the one-layer plan cannot see (whether its ifmap arrives
  on chip, whether its pooled ofmap stays on chip, the pool folded into
  its epilogue).
* :class:`NetworkPlan` — the chained topology: whole-network
  device-memory bytes, MACs and Ops/MAcc in the plans' own schedule and
  in ``mode="trim"`` / ``"3dtrim"``, and :meth:`NetworkPlan.arch_compare`,
  the paper's own §V comparison on its access model (``core/model.py``).
* :class:`NetworkGraph` — the same for DAGs (ResNet-18, U-Net): per-edge
  residency over liveness intervals, join steps for pool / add / concat
  / upsample.

Residency.  The TPU keeps an activation resident in VMEM when it fits an
8 MiB budget.  The card keeps one on chip only inside a group of the
fused kernel, tile by tile in shared memory, so by default
(``residency="auto"``, ``residency_budget=None``) exactly the interior
boundaries of :class:`~repro_torch.core.fuse_plan.FusedGroupPlan`'s fused
groups are resident (f32 and bf16; the int8 kernel has no fused route).
An explicit ``residency_budget`` applies JAX's rule instead (a pooled
activation, or the tensors live across a boundary, within the budget),
``"never"`` and ``"always"`` override as in JAX.

Counting conventions (DESIGN.md §7): the Ops/MAcc denominator counts
ifmap reads + weight reads in elements (bytes / dtype_bytes); output
writes are excluded.  One OP = one multiply or add.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from dataclasses import replace as _dc_replace

from repro_torch.core.conv_plan import ConvPlan
from repro_torch.core.model import (TRIM, TRIM_3D, ConvLayer, GraphNode,
                                    alexnet_layers, layer_accesses,
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


# ---------------------------------------------------------------------------
# One chained layer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerStep:
    """One conv layer of a :class:`NetworkPlan` (or a conv node of a
    :class:`NetworkGraph`).

    ``plan`` is the layer's H100 :class:`ConvPlan`; the step adds:

    * ``resident_in`` — the ifmap arrives on chip from the previous
      layer: its input bytes (any ``mode="trim"`` re-reads included) are
      not billed.
    * ``resident_out`` — the (pooled) ofmap stays on chip as the next
      layer's ifmap: its output bytes are not billed.
    * ``pool`` / ``pool_window`` — the max pool folded into the epilogue;
      with ``fold_pooling`` the output bytes billed are the pooled
      activation, else the full ofmap the plan writes.
    """

    index: int
    name: str
    layer: ConvLayer
    plan: ConvPlan
    pool: int = 1
    pool_window: int = 1
    resident_in: bool = False
    resident_out: bool = False
    fold_pooling: bool = True

    @property
    def out_size(self) -> int:
        """Spatial size of the (pooled) activation this step hands on."""
        return pooled_out_size(self.plan.h_out, self.pool,
                               self.pool_window)

    @property
    def out_elements(self) -> int:
        return self.plan.n * self.out_size ** 2 * self.plan.cout

    @property
    def out_bytes(self) -> int:
        """Bytes of the activation this step writes (0 if resident)."""
        if self.resident_out:
            return 0
        if self.fold_pooling:
            return self.out_elements * self.plan.dtype_bytes
        return self.plan.hbm_bytes()["output"]

    @property
    def macs(self) -> int:
        return self.plan.flops // 2

    @property
    def ops(self) -> int:
        return 2 * self.macs

    def hbm_bytes(self, mode: str | None = None) -> dict:
        """This step's device-memory bytes under the network's residency
        and pooling decisions; ``mode`` as :meth:`ConvPlan.hbm_bytes`
        (``None``: the plan's own schedule)."""
        t = self.plan.hbm_bytes(mode)
        inp = 0 if self.resident_in else t["input"]
        out = self.out_bytes
        return dict(input=inp, weights=t["weights"], output=out,
                    total=inp + t["weights"] + out)

    def accesses(self, mode: str | None = None) -> int:
        """Paper-metric memory accesses: ifmap + weight reads, in
        elements (output writes excluded)."""
        t = self.hbm_bytes(mode)
        return (t["input"] + t["weights"]) // self.plan.dtype_bytes

    def ops_per_macc(self, mode: str | None = None) -> float:
        """Operations per memory access of this layer (paper metric)."""
        return self.ops / max(self.accesses(mode), 1)


def _check_residency(residency: str) -> None:
    if residency not in ("auto", "never", "always"):
        raise ValueError(f"residency={residency!r} must be "
                         "'auto', 'never' or 'always'")


def _fused_interior(layers, n: int, dtype_bytes: int) -> set:
    """Indices ``i`` of a chain whose boundary ``i -> i+1`` lies inside a
    fused group of :class:`~repro_torch.core.fuse_plan.FusedGroupPlan`
    (the activations the card keeps on chip); none at int8."""
    if dtype_bytes not in (4, 2):
        return set()
    # fuse_plan imports this module's topology helpers
    from repro_torch.core.fuse_plan import FusedGroupPlan
    plan = FusedGroupPlan.build(list(layers), n=n, dtype_bytes=dtype_bytes)
    return {i for g in plan.groups if g.fused
            for i in range(g.start, g.start + g.depth - 1)}


# ---------------------------------------------------------------------------
# The chained network
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NetworkPlan:
    """Per-layer ConvPlans chained across a CNN topology.

    Every aggregate is a function of the per-layer plans and the
    residency / pooling decisions::

        plan = NetworkPlan.build("vgg16")
        plan.arch_compare()["improvement"]    # the paper's 3.0-3.6x
    """

    name: str
    steps: tuple
    residency: str = "auto"

    @classmethod
    def build(cls, network="vgg16", *, n: int = 1,
              dtype_bytes: int = 4, dataflow: str = "carry",
              residency: str = "auto",
              residency_budget: int | None = None,
              fold_pooling: bool = True) -> "NetworkPlan":
        """Plan a whole topology at batch ``n``.

        ``network`` is a name ("vgg16" | "alexnet" | "mobilenet") or a
        ``list[ConvLayer]``.  ``residency``: ``"auto"`` keeps the
        interior boundaries of the fused groups resident, or, given a
        ``residency_budget`` in bytes, every boundary whose pooled
        activation fits it (JAX's rule); ``"never"`` spills every
        boundary (with ``fold_pooling=False`` the bytes are then the sum
        of the per-layer ``ConvPlan.hbm_bytes()``); ``"always"`` keeps
        every interior boundary."""
        _check_residency(residency)
        layers = network_layers(network)
        if not layers:
            raise ValueError("empty topology")
        for a, b in zip(layers, layers[1:]):
            if a.out_channels != b.in_channels:
                raise ValueError(
                    f"layer {a.name} ofmap channels {a.out_channels} != "
                    f"{b.name} ifmap channels {b.in_channels}")
        pools = infer_pools(layers)
        plans = [layer.plan(n=n, dtype_bytes=dtype_bytes,
                            dataflow=dataflow) for layer in layers]
        fused = (_fused_interior(layers, n, dtype_bytes)
                 if residency == "auto" and residency_budget is None
                 else set())

        steps = []
        last = len(layers) - 1
        for i, (layer, plan, (ps, pw)) in enumerate(
                zip(layers, plans, pools)):
            pooled_bytes = (n * pooled_out_size(plan.h_out, ps, pw) ** 2
                            * plan.cout * dtype_bytes)
            if i == last:
                keep = False            # the result leaves the card
            elif residency == "never":
                keep = False
            elif residency == "always":
                keep = True
            elif residency_budget is None:
                keep = i in fused
            else:
                keep = pooled_bytes <= residency_budget
            steps.append(LayerStep(
                index=i, name=layer.name, layer=layer, plan=plan,
                pool=ps, pool_window=pw,
                resident_in=bool(steps) and steps[-1].resident_out,
                resident_out=keep, fold_pooling=fold_pooling))
        nm = network if isinstance(network, str) else "custom"
        return cls(name=nm, steps=tuple(steps), residency=residency)

    # -- aggregates --------------------------------------------------------

    @property
    def n_layers(self) -> int:
        return len(self.steps)

    @property
    def macs(self) -> int:
        return sum(s.macs for s in self.steps)

    @property
    def ops(self) -> int:
        return 2 * self.macs

    def hbm_bytes(self, mode: str | None = None) -> dict:
        """Whole-network bytes (input / weights / output / total, and the
        ``halo`` wire term) under the residency and pooling decisions."""
        return _sum_bytes(self.steps, mode)

    def accesses(self, mode: str | None = None) -> int:
        """Whole-network paper-metric accesses (ifmap + weight reads)."""
        return sum(s.accesses(mode) for s in self.steps)

    def ops_per_macc(self, mode: str | None = None) -> float:
        """The network-level Ops/MAcc: operations over external reads."""
        return self.ops / max(self.accesses(mode), 1)

    def compare(self) -> dict:
        """Per-layer and whole-network Ops/MAcc of the card's schedule in
        both accounting modes, with the 3dtrim/trim ratio."""
        rows = [_compare_row(s) for s in self.steps]
        n3, nt = self.ops_per_macc("3dtrim"), self.ops_per_macc("trim")
        return dict(
            network=self.name, residency=self.residency,
            layers=rows, macs=self.macs, ops=self.ops,
            ops_per_macc_3dtrim=n3, ops_per_macc_trim=nt,
            improvement=n3 / max(nt, 1e-12))

    def arch_compare(self, hw_a=None, hw_b=None) -> dict:
        """The paper's §V network comparison: whole-network Ops/MAcc of
        the 3D-TrIM ASIC configuration against TrIM's on the Fig. 6
        access model (``core.model.layer_accesses``).  :meth:`compare` is
        the card's strip-level image of the same trade."""
        return arch_compare_steps(self.name, self.steps, hw_a, hw_b)

    def as_rows(self, mode: str | None = None) -> list[dict]:
        """Flat per-layer rows."""
        return [_step_row(s, mode) for s in self.steps]


def _sum_bytes(steps, mode: str | None) -> dict:
    """The steps' :meth:`LayerStep.hbm_bytes` (or ``JoinStep``'s), summed
    key by key."""
    tot = dict(input=0, weights=0, output=0, total=0)
    for s in steps:
        t = s.hbm_bytes(mode)
        for k in tot:
            tot[k] += t[k]
    return tot


def _compare_row(s: LayerStep) -> dict:
    a3, at = s.ops_per_macc("3dtrim"), s.ops_per_macc("trim")
    return dict(
        layer=s.name, label=s.layer.label(), macs=s.macs,
        strips=s.plan.n_strips, segments=s.plan.segments,
        dataflow=s.plan.dataflow,
        resident_in=s.resident_in, resident_out=s.resident_out,
        pool=s.pool,
        ops_per_macc_3dtrim=a3, ops_per_macc_trim=at,
        improvement=a3 / max(at, 1e-12))


def _step_row(s, mode: str | None) -> dict:
    t = s.hbm_bytes(mode)
    conv = isinstance(s, LayerStep)
    return dict(
        layer=s.name,
        label=s.layer.label() if conv else s.label(),
        mode=(mode or s.plan.traffic_mode() or "plan") if conv else "-",
        dataflow=s.plan.dataflow if conv else "-",
        macs=s.macs,
        hbm_input=t["input"], hbm_weights=t["weights"],
        hbm_output=t["output"],
        hbm_total=t["total"],
        accesses=s.accesses(mode),
        ops_per_macc=s.ops_per_macc(mode),
        resident_in=s.resident_in,
        resident_out=s.resident_out,
        pool=s.pool if conv else 1)


def arch_compare_steps(name: str, steps, hw_a=None, hw_b=None) -> dict:
    """The paper's §V architectural network comparison over conv steps
    (``.name`` + ``.layer``): :meth:`NetworkPlan.arch_compare` and
    :meth:`NetworkGraph.arch_compare` (conv nodes only: joins do no MACs
    and the Fig. 6 model has no term for them)."""
    hw_a = TRIM_3D if hw_a is None else hw_a
    hw_b = TRIM if hw_b is None else hw_b
    steps = tuple(steps)
    rows, tot = [], {hw_a.name: 0, hw_b.name: 0}
    for s in steps:
        a = layer_accesses(s.layer, hw_a)
        b = layer_accesses(s.layer, hw_b)
        tot[hw_a.name] += a.total
        tot[hw_b.name] += b.total
        rows.append(dict(
            layer=s.name, label=s.layer.label(), ops=s.layer.ops,
            accesses={hw_a.name: a.total, hw_b.name: b.total},
            ops_per_macc={hw_a.name: a.ops_per_access,
                          hw_b.name: b.ops_per_access},
            ops_per_macc_per_slice={
                hw_a.name: a.ops_per_access_per_slice,
                hw_b.name: b.ops_per_access_per_slice},
            improvement=a.ops_per_access_per_slice
            / b.ops_per_access_per_slice))
    ops = sum(s.layer.ops for s in steps)
    net_a = ops / max(tot[hw_a.name], 1)
    net_b = ops / max(tot[hw_b.name], 1)
    return dict(
        network=name, layers=rows, ops=ops, accesses=tot,
        ops_per_macc={hw_a.name: net_a, hw_b.name: net_b},
        ops_per_macc_per_slice={hw_a.name: net_a / hw_a.slices,
                                hw_b.name: net_b / hw_b.slices},
        improvement=(net_a / hw_a.slices) / (net_b / hw_b.slices))


# ---------------------------------------------------------------------------
# DAG network plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EdgeState:
    """One producer -> consumer edge of a :class:`NetworkGraph` with its
    residency verdict.  ``bytes`` is the (pooled) activation the edge
    carries; ``boundaries`` the half-open interval of topological
    boundaries ``[producer_pos, consumer_pos)`` it occupies while
    resident (a skip edge spans many)."""

    producer: str
    consumer: str
    bytes: int
    resident: bool
    boundaries: tuple[int, int]

    @property
    def state(self) -> str:
        return "resident" if self.resident else "refetch"

    @property
    def span(self) -> int:
        return self.boundaries[1] - self.boundaries[0]

    @property
    def refetch_bytes(self) -> int:
        return 0 if self.resident else self.bytes


@dataclass(frozen=True)
class JoinStep:
    """One non-conv node (pool / add / concat / upsample) of a
    :class:`NetworkGraph`: no MACs, only activation traffic (the in-edges
    re-read from device memory plus the output it spills); ``plan`` is
    None, so the roofline bills it as memory-only work."""

    index: int
    name: str
    op: str
    n: int
    out_size: int
    channels: int
    dtype_bytes: int
    in_bytes: tuple
    resident_ins: tuple
    resident_out: bool

    plan = None          # no ConvPlan: memory-only node

    @property
    def resident_in(self) -> bool:
        """True iff every in-edge arrives on chip."""
        return all(self.resident_ins)

    @property
    def out_elements(self) -> int:
        return self.n * self.out_size ** 2 * self.channels

    @property
    def out_bytes(self) -> int:
        if self.resident_out:
            return 0
        return self.out_elements * self.dtype_bytes

    @property
    def macs(self) -> int:
        return 0

    @property
    def ops(self) -> int:
        return 0

    def hbm_bytes(self, mode: str | None = None) -> dict:
        inp = sum(b for b, r in zip(self.in_bytes, self.resident_ins)
                  if not r)
        out = self.out_bytes
        return dict(input=inp, weights=0, output=out, total=inp + out)

    def accesses(self, mode: str | None = None) -> int:
        """Activation re-reads in elements: a re-fetched skip ifmap is an
        ifmap read, with no MACs beside it."""
        return self.hbm_bytes(mode)["input"] // self.dtype_bytes

    def ops_per_macc(self, mode: str | None = None) -> float:
        return 0.0

    def label(self) -> str:
        return f"[{self.op} {self.out_size}x{self.out_size}" \
               f"x{self.channels}]"


def _fused_edges(nodes, n: int, dtype_bytes: int) -> set:
    """The (producer, consumer) edges inside a fused group of a graph's
    fusable segments (``fuse_plan.graph_segments``, each planned by
    ``FusedGroupPlan``): a group's consecutive nodes, absorbed pools
    included; none at int8."""
    if dtype_bytes not in (4, 2):
        return set()
    from repro_torch.core.fuse_plan import FusedGroupPlan, graph_segments
    edges = set()
    for names, layers in graph_segments(nodes):
        at = {nm: i for i, nm in enumerate(names)}
        plan = FusedGroupPlan.build(list(layers), n=n,
                                    dtype_bytes=dtype_bytes)
        for g in plan.groups:
            if not g.fused:
                continue
            a = at[layers[g.start].name]
            b = at[layers[g.start + g.depth - 1].name]
            edges.update(zip(names[a:b], names[a + 1:b + 1]))
    return edges


@dataclass(frozen=True)
class NetworkGraph:
    """A DAG topology planned for residency: :class:`NetworkPlan` from
    chains to graphs (ResNet residual blocks, U-Net).

    Residency is decided per edge.  A tensor with a resident edge to the
    consumer at position ``j`` occupies every boundary in ``[producer,
    j)``.  ``"auto"`` keeps the edges inside the fused groups of the
    graph's fusable segments, or, given a ``residency_budget``, admits
    edges greedily in consumer order while the resident tensors at every
    boundary sum within it (JAX's rule); ``"never"`` / ``"always"``
    override.  A tensor is spilled iff any of its consumer edges is not
    resident or it is a network output.  On a linear chain this reduces
    to :class:`NetworkPlan`."""

    name: str
    nodes: tuple
    steps: tuple
    edges: tuple
    residency: str
    residency_budget: int | None

    @classmethod
    def build(cls, graph="resnet18", *, n: int = 1,
              dtype_bytes: int = 4, dataflow: str = "carry",
              residency: str = "auto",
              residency_budget: int | None = None,
              fold_pooling: bool = True) -> "NetworkGraph":
        """Plan a DAG topology: a name from :data:`GRAPHS`, a linear name
        from :data:`NETWORKS`, a ``list[GraphNode]`` in topological order
        or a ``list[ConvLayer]`` (a chain graph).  Raises
        ``ValueError`` on a malformed topology (duplicate names, inputs
        that are not earlier nodes, a conv with two inputs or the wrong
        input shape, a pool window past its input, joins of one input or
        mismatched shapes, not exactly one source conv)."""
        _check_residency(residency)
        nodes = graph_nodes(graph)
        if not nodes:
            raise ValueError("empty topology")

        # -- validate topology, compute per-node (size, channels) ------
        pos: dict[str, int] = {}
        out_size: dict[str, int] = {}
        channels: dict[str, int] = {}
        sources = 0
        for i, nd in enumerate(nodes):
            if nd.name in pos:
                raise ValueError(f"duplicate node name {nd.name!r}")
            for src in nd.inputs:
                if src not in pos:
                    raise ValueError(
                        f"node {nd.name}: input {src!r} is not an "
                        f"earlier node — nodes must be topological")
            if nd.op == "conv":
                l = nd.layer
                if len(nd.inputs) > 1:
                    raise ValueError(
                        f"conv node {nd.name}: exactly one input")
                if nd.inputs:
                    src = nd.inputs[0]
                    if (out_size[src] != l.ifmap
                            or channels[src] != l.in_channels):
                        raise ValueError(
                            f"node {nd.name}: expects {l.ifmap}^2"
                            f"x{l.in_channels}, producer {src} hands "
                            f"{out_size[src]}^2x{channels[src]}")
                else:
                    sources += 1
                sz = pooled_out_size(l.out_size, nd.pool, nd.pool_window)
                chn = l.out_channels
            elif nd.op == "pool":
                (src,) = nd.inputs
                if nd.pool_window > out_size[src]:
                    raise ValueError(
                        f"pool {nd.name}: window {nd.pool_window} > "
                        f"input size {out_size[src]}")
                sz = pooled_out_size(out_size[src], nd.pool,
                                     nd.pool_window)
                chn = channels[src]
            elif nd.op == "upsample":
                (src,) = nd.inputs
                sz = out_size[src] * nd.scale
                chn = channels[src]
            else:                        # add / concat
                if len(nd.inputs) < 2:
                    raise ValueError(
                        f"{nd.op} node {nd.name}: needs >= 2 inputs")
                sizes = {out_size[s] for s in nd.inputs}
                if len(sizes) != 1:
                    raise ValueError(
                        f"node {nd.name}: mismatched spatial dims "
                        f"{sorted(sizes)}")
                sz = sizes.pop()
                chs = [channels[s] for s in nd.inputs]
                if nd.op == "add" and len(set(chs)) != 1:
                    raise ValueError(
                        f"add node {nd.name}: mismatched channels {chs}")
                chn = chs[0] if nd.op == "add" else sum(chs)
            pos[nd.name] = i
            out_size[nd.name] = sz
            channels[nd.name] = chn
        if sources != 1:
            raise ValueError(
                f"graph needs exactly one source conv node "
                f"(empty inputs), got {sources}")

        # -- per-conv plans, as the chain plans its layers --------------
        plans = {nd.name: nd.layer.plan(n=n, dtype_bytes=dtype_bytes,
                                        dataflow=dataflow)
                 for nd in nodes if nd.op == "conv"}
        tensor_bytes = {nm: n * out_size[nm] ** 2 * channels[nm]
                        * dtype_bytes for nm in pos}

        # -- residency over the boundaries ------------------------------
        edge_list: list[tuple[str, str]] = []
        seen = set()
        for nd in nodes:
            for src in nd.inputs:
                if (src, nd.name) not in seen:
                    seen.add((src, nd.name))
                    edge_list.append((src, nd.name))
        fused = (_fused_edges(nodes, n, dtype_bytes)
                 if residency == "auto" and residency_budget is None
                 else set())
        occ = [0] * max(len(nodes) - 1, 0)
        upto: dict[str, int] = {}
        res: dict[tuple[str, str], bool] = {}
        for prod, cons in sorted(edge_list,
                                 key=lambda e: (pos[e[1]], pos[e[0]])):
            b = tensor_bytes[prod]
            start = upto.get(prod, pos[prod])
            span = range(start, pos[cons])
            if residency == "never":
                keep = False
            elif residency == "always":
                keep = True
            elif residency_budget is None:
                keep = (prod, cons) in fused
            else:
                keep = all(occ[k] + b <= residency_budget for k in span)
            if keep:
                if residency != "always":
                    for k in span:
                        occ[k] += b
                upto[prod] = max(start, pos[cons])
            res[(prod, cons)] = keep

        # -- steps ------------------------------------------------------
        consumers: dict[str, list[str]] = {nm: [] for nm in pos}
        for prod, cons in edge_list:
            consumers[prod].append(cons)
        steps: list = []
        for i, nd in enumerate(nodes):
            outs = consumers[nd.name]
            spilled = (not outs) or any(not res[(nd.name, c)]
                                        for c in outs)
            if nd.op == "conv":
                r_in = bool(nd.inputs) and res[(nd.inputs[0], nd.name)]
                steps.append(LayerStep(
                    index=i, name=nd.name, layer=nd.layer,
                    plan=plans[nd.name], pool=nd.pool,
                    pool_window=nd.pool_window, resident_in=r_in,
                    resident_out=not spilled, fold_pooling=fold_pooling))
            else:
                steps.append(JoinStep(
                    index=i, name=nd.name, op=nd.op, n=n,
                    out_size=out_size[nd.name],
                    channels=channels[nd.name], dtype_bytes=dtype_bytes,
                    in_bytes=tuple(tensor_bytes[s] for s in nd.inputs),
                    resident_ins=tuple(res[(s, nd.name)]
                                       for s in nd.inputs),
                    resident_out=not spilled))
        edges = tuple(EdgeState(
            producer=prod, consumer=cons, bytes=tensor_bytes[prod],
            resident=res[(prod, cons)],
            boundaries=(pos[prod], pos[cons]))
            for prod, cons in edge_list)
        nm = graph if isinstance(graph, str) else "custom"
        return cls(name=nm, nodes=tuple(nodes), steps=tuple(steps),
                   edges=edges, residency=residency,
                   residency_budget=residency_budget)

    # -- aggregates --------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def conv_steps(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, LayerStep))

    @property
    def macs(self) -> int:
        return sum(s.macs for s in self.steps)

    @property
    def ops(self) -> int:
        return 2 * self.macs

    @property
    def spilled_edge_bytes(self) -> int:
        """Bytes of the edges that re-fetch (reporting; the billed
        traffic rides inside the consumer steps)."""
        return sum(e.refetch_bytes for e in self.edges)

    def boundary_occupancy(self) -> list[int]:
        """Resident bytes held across each topological boundary (within
        ``residency_budget`` at every boundary under ``"auto"`` with a
        budget)."""
        occ = [0] * max(len(self.nodes) - 1, 0)
        pos = {nd.name: i for i, nd in enumerate(self.nodes)}
        upto: dict[str, int] = {}
        for e in sorted(self.edges,
                        key=lambda e: (pos[e.consumer], pos[e.producer])):
            if not e.resident:
                continue
            start = upto.get(e.producer, e.boundaries[0])
            for k in range(start, e.boundaries[1]):
                occ[k] += e.bytes
            upto[e.producer] = max(start, e.boundaries[1])
        return occ

    def hbm_bytes(self, mode: str | None = None) -> dict:
        """Whole-network bytes under the graph's residency decisions."""
        return _sum_bytes(self.steps, mode)

    def accesses(self, mode: str | None = None) -> int:
        """Whole-network paper-metric accesses, join re-reads included."""
        return sum(s.accesses(mode) for s in self.steps)

    def ops_per_macc(self, mode: str | None = None) -> float:
        return self.ops / max(self.accesses(mode), 1)

    def compare(self) -> dict:
        """trim-vs-3dtrim Ops/MAcc of the card's schedule over the DAG:
        per-conv rows, the network totals (join traffic in the
        denominator) and the edge-residency summary."""
        rows = [_compare_row(s) for s in self.conv_steps]
        n3, nt = self.ops_per_macc("3dtrim"), self.ops_per_macc("trim")
        n_res = sum(1 for e in self.edges if e.resident)
        return dict(
            network=self.name, residency=self.residency,
            layers=rows, macs=self.macs, ops=self.ops,
            n_edges=len(self.edges), n_resident_edges=n_res,
            spilled_edge_bytes=self.spilled_edge_bytes,
            ops_per_macc_3dtrim=n3, ops_per_macc_trim=nt,
            improvement=n3 / max(nt, 1e-12))

    def arch_compare(self, hw_a=None, hw_b=None) -> dict:
        """The paper's §V comparison over the graph's conv nodes."""
        return arch_compare_steps(self.name, self.conv_steps, hw_a, hw_b)

    def as_rows(self, mode: str | None = None) -> list[dict]:
        """Flat per-node rows; join nodes report their op label and
        activation traffic."""
        return [_step_row(s, mode) for s in self.steps]

    def edge_rows(self) -> list[dict]:
        """Per-edge residency rows."""
        return [dict(producer=e.producer, consumer=e.consumer,
                     bytes=e.bytes, state=e.state, span=e.span,
                     boundaries=list(e.boundaries)) for e in self.edges]
