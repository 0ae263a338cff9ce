"""The paper's analytical access model and its CNN topologies (the
counterpart of ``repro/core/model.py``).

Reproduces the paper's analytical results:

* Fig. 1 — ifmap memory-access overhead of TrIM vs ifmap size (K=3):
  TrIM's shift registers hold ``W - K - 1`` entries per reused row, so the
  last ``K-1`` activations of every ifmap row fall off and must be re-read
  from external memory on every band advance.  3D-TrIM's shadow registers
  hold exactly those values -> zero overhead.

* Fig. 6 — OPs / memory-access / slice for every conv layer of VGG-16 and
  AlexNet, comparing the 3D-TrIM ASIC configuration (P_I=8 cores x P_O=8
  slices = 64 slices) against the TrIM configuration (7 x 24 = 168 slices).

Counting conventions (DESIGN.md §1):
  * "memory accesses" = external (off-chip) ifmap reads + weight reads.
    Psums are accumulated in on-chip buffers in both architectures and are
    not part of the paper's OPs/Access metric.
  * An ifmap channel that is broadcast to several consumers at the same
    time (TrIM: the same channel feeding the 7 filter-parallel cores;
    3D-TrIM: one channel feeding the P_O slices of a core through the
    shared IRB) is counted as ONE external read.
  * One OP = one multiply or one add, so a MAC = 2 OPs (this makes the
    576-PE / 1 GHz design peak at 1.15 TOPS as reported).

The model is the paper's architecture, not the card: the H100's own
bytes for a layer are its :meth:`ConvLayer.plan`'s
(``core/conv_plan.ConvPlan.hbm_bytes``).  Also the topologies: VGG-16,
AlexNet, MobileNet stages, and the DAG nodes of ResNet-18 and U-Net.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.conv_plan import (ConvPlan, same_pads,
                                        slice_reads_per_channel)


# ---------------------------------------------------------------------------
# Layer / hardware descriptions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvLayer:
    """One 2D convolution layer (square spatial dims)."""

    name: str
    ifmap: int          # I  (ifmap height = width)
    in_channels: int    # C
    out_channels: int   # F
    kernel: int         # K
    stride: int = 1     # S
    padding: int = 0    # P (symmetric zero padding; zeros are never *read*)
    groups: int = 1     # feature groups (== C for depthwise)

    @property
    def out_size(self) -> int:
        return (self.ifmap + 2 * self.padding - self.kernel) // self.stride + 1

    @property
    def macs(self) -> int:
        return (self.out_size ** 2) * (self.in_channels // self.groups) \
            * self.out_channels * (self.kernel ** 2)

    @property
    def ops(self) -> int:
        return 2 * self.macs

    def label(self) -> str:
        g = f",g{self.groups}" if self.groups > 1 else ""
        return (f"({self.ifmap},{self.in_channels},"
                f"{self.out_channels},{self.kernel}{g})")

    def plan(self, *, n: int = 1, dtype_bytes: int = 4,
             tile_h: int | None = None, tile_cout: int | None = None,
             dataflow: str = "carry") -> ConvPlan:
        """The H100 kernel's ``ConvPlan`` for this layer at batch ``n``:
        the padding the port runs ('same' pads where ``padding`` > 0, as
        ``netplan.layer_kernel_problem`` maps a layer, else 'valid'), at
        ``dtype_bytes`` (4 f32, 2 bf16, 1 int8).  The whole K x K kernel
        is planned, also past ``ops.MAX_NATIVE_K``, where the port runs
        the kernel tiling's sub-kernels.  Raises ``ValueError`` where the
        layer's padding is not 'same'-equivalent."""
        pad = ((same_pads(self.ifmap, self.kernel, self.stride),) * 2
               if self.padding else 0)
        plan = ConvPlan.build(
            (n, self.ifmap, self.ifmap, self.in_channels),
            (self.kernel, self.kernel, self.in_channels // self.groups,
             self.out_channels),
            stride=self.stride, pad=pad, groups=self.groups,
            tile_h=tile_h, tile_cout=tile_cout, dataflow=dataflow,
            dtype_bytes=dtype_bytes)
        if plan.h_out != self.out_size:
            raise ValueError(
                f"layer {self.name}: padding={self.padding} is not "
                f"'same'-equivalent (executed output {plan.h_out} != "
                f"{self.out_size}); the port runs 'same' or zero padding")
        return plan


@dataclass(frozen=True)
class HWConfig:
    """A TrIM-family accelerator configuration.

    ``filter_parallel``  — number of filters processed concurrently.
    ``channel_parallel`` — number of ifmap channels processed concurrently.
    ``shadow_registers`` — True for 3D-TrIM (end-of-row activations kept in
                           shadow registers, ifmap overhead nullified).
    ``native_k``         — largest kernel the slices support natively;
                           larger kernels are decomposed into ceil(K/3)^2
                           3x3 sub-kernels (paper §III kernel tiling).
    """

    name: str
    filter_parallel: int
    channel_parallel: int
    shadow_registers: bool
    slices: int
    native_k: int = 3
    frequency_ghz: float = 1.0

    @property
    def pes(self) -> int:
        return self.slices * 9

    @property
    def peak_tops(self) -> float:
        return self.pes * 2 * self.frequency_ghz / 1e3


# The two configurations compared in the paper (§III).
TRIM_3D = HWConfig(name="3d-trim", filter_parallel=8, channel_parallel=8,
                   shadow_registers=True, slices=64)
TRIM = HWConfig(name="trim", filter_parallel=7, channel_parallel=24,
                shadow_registers=False, slices=168)


# ---------------------------------------------------------------------------
# ifmap access model (Fig. 1)
# ---------------------------------------------------------------------------

def ifmap_reads_per_channel(height: int, width: int, kernel: int,
                            stride: int = 1, *, shadow: bool) -> int:
    """External reads of one ifmap channel for one pass of the array:
    ``core.conv_plan.slice_reads_per_channel`` under its Fig. 1 / 6
    name."""
    return slice_reads_per_channel(height, width, kernel, stride,
                                   shadow=shadow)


def ifmap_overhead_pct(size: int, kernel: int = 3, stride: int = 1) -> float:
    """TrIM ifmap access overhead (%) vs the ideal single-read — Fig. 1."""
    ideal = size * size
    trim = ifmap_reads_per_channel(size, size, kernel, stride, shadow=False)
    return 100.0 * (trim - ideal) / ideal


def fig1_curve(sizes=(14, 28, 56, 112, 224), kernel: int = 3) -> dict:
    """Overhead curve of Fig. 1: TrIM % overhead per ifmap size, K=3."""
    return {s: ifmap_overhead_pct(s, kernel) for s in sizes}


# ---------------------------------------------------------------------------
# Kernel tiling (paper §III: K>3 decomposed into 3x3 sub-kernels)
# ---------------------------------------------------------------------------

def num_subkernels(kernel: int, native_k: int = 3) -> int:
    """Sub-kernels of the paper's kernel tiling (§III): one for K <= 3,
    else ``ceil(K / 3)^2`` (``core.tiling.subkernel_decomposition``)."""
    if kernel <= native_k:
        return 1
    t = math.ceil(kernel / native_k)
    return t * t


# ---------------------------------------------------------------------------
# Per-layer access + OPs/Access/Slice model (Fig. 6)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerAccesses:
    layer: ConvLayer
    hw: HWConfig
    ifmap_reads: int
    weight_reads: int

    @property
    def total(self) -> int:
        return self.ifmap_reads + self.weight_reads

    @property
    def ops_per_access(self) -> float:
        return self.layer.ops / self.total

    @property
    def ops_per_access_per_slice(self) -> float:
        return self.ops_per_access / self.hw.slices


def layer_accesses(layer: ConvLayer, hw: HWConfig) -> LayerAccesses:
    """External memory accesses for one conv layer on one configuration."""
    k, s = layer.kernel, layer.stride
    tiles = num_subkernels(k, hw.native_k)
    sub_k = k if tiles == 1 else hw.native_k

    # Filter passes: every pass over a new batch of filters re-streams the
    # ifmap channels it consumes (psums for only ``filter_parallel`` ofmaps
    # fit on chip).  With feature groups, a filter only consumes its own
    # group's C/groups channels.
    filter_passes = math.ceil(layer.out_channels // layer.groups
                              / hw.filter_parallel)

    # Per-channel reads for one pass of one (sub-)kernel.
    rpc = ifmap_reads_per_channel(layer.ifmap, layer.ifmap, sub_k, s,
                                  shadow=hw.shadow_registers)
    # Each sub-kernel occupies its own core/slice with its own IRB, so a
    # channel is streamed once per sub-kernel.
    ifmap_reads = layer.in_channels * rpc * tiles * filter_passes

    # Weights are loaded once per (filter, channel, tap).  Tiled kernels are
    # zero-padded up to tiles * native_k^2 taps.
    taps = k * k if tiles == 1 else tiles * hw.native_k ** 2
    weight_reads = layer.out_channels * (layer.in_channels // layer.groups) \
        * taps

    return LayerAccesses(layer=layer, hw=hw, ifmap_reads=ifmap_reads,
                         weight_reads=weight_reads)


def compare_layer(layer: ConvLayer, hw_a: HWConfig = TRIM_3D,
                  hw_b: HWConfig = TRIM) -> dict:
    """Fig. 6 bar pair for one layer: OPs/Access/Slice of both configs."""
    a = layer_accesses(layer, hw_a)
    b = layer_accesses(layer, hw_b)
    return {
        "layer": layer.label(),
        hw_a.name: a.ops_per_access_per_slice,
        hw_b.name: b.ops_per_access_per_slice,
        "improvement": a.ops_per_access_per_slice / b.ops_per_access_per_slice,
    }


# ---------------------------------------------------------------------------
# CNN topologies used in the paper
# ---------------------------------------------------------------------------

def vgg16_layers() -> list[ConvLayer]:
    """The 13 conv layers of the VGG-16 feature extractor (same padding)."""
    spec = [
        (224, 3, 64), (224, 64, 64),
        (112, 64, 128), (112, 128, 128),
        (56, 128, 256), (56, 256, 256), (56, 256, 256),
        (28, 256, 512), (28, 512, 512), (28, 512, 512),
        (14, 512, 512), (14, 512, 512), (14, 512, 512),
    ]
    return [ConvLayer(name=f"conv{i+1}", ifmap=i_sz, in_channels=c,
                      out_channels=f, kernel=3, stride=1, padding=1)
            for i, (i_sz, c, f) in enumerate(spec)]


def alexnet_layers() -> list[ConvLayer]:
    """The 5 conv layers of AlexNet."""
    return [
        ConvLayer("conv1", 227, 3, 96, kernel=11, stride=4, padding=0),
        ConvLayer("conv2", 27, 96, 256, kernel=5, stride=1, padding=2),
        ConvLayer("conv3", 13, 256, 384, kernel=3, stride=1, padding=1),
        ConvLayer("conv4", 13, 384, 384, kernel=3, stride=1, padding=1),
        ConvLayer("conv5", 13, 384, 256, kernel=3, stride=1, padding=1),
    ]


def mobilenet_layers() -> list[ConvLayer]:
    """Representative MobileNetV1 depthwise-separable stages: each stage is
    a depthwise 3x3 (groups == C) followed by a pointwise 1x1 — the
    low-reuse workload the paper's OPs/Access comparison targets."""
    layers: list[ConvLayer] = []
    for i, (i_sz, c, f, s) in enumerate([
            (112, 32, 64, 1), (112, 64, 128, 2),
            (56, 128, 256, 2), (28, 256, 512, 2)]):
        layers.append(ConvLayer(f"dw{i+1}", i_sz, c, c, kernel=3, stride=s,
                                padding=1, groups=c))
        layers.append(ConvLayer(f"pw{i+1}", i_sz // s, c, f, kernel=1))
    return layers


# ---------------------------------------------------------------------------
# DAG topologies (``core.netplan.graph_nodes`` resolves them; the executor
# is ``models.layers.cnn_apply_from_graph``)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GraphNode:
    """One node of a DAG topology.

    ``op`` is one of:

    * ``"conv"``     — a :class:`ConvLayer` (``layer`` required); ``pool``
      / ``pool_window`` fold a max-pool epilogue onto the conv, exactly
      like a chain's inferred pool (linear chains converted by
      ``netplan.linear_graph_nodes`` use this).
    * ``"pool"``     — a standalone ``pool_window``^2 / stride-``pool``
      max pool.  DAG topologies keep pools explicit so a skip edge can
      tap the *pre*-pool activation.
    * ``"add"``      — elementwise residual join (all inputs same shape).
    * ``"concat"``   — channel concatenation (same spatial dims).
    * ``"upsample"`` — nearest-neighbour spatial upsampling by ``scale``.

    ``inputs`` name producer nodes; a conv node with no inputs reads the
    network input (exactly one such source node per graph).  Joins
    perform no MACs.
    """

    name: str
    op: str
    inputs: tuple[str, ...] = ()
    layer: ConvLayer | None = None
    pool: int = 1
    pool_window: int = 1
    scale: int = 1

    def __post_init__(self):
        if self.op not in ("conv", "pool", "add", "concat", "upsample"):
            raise ValueError(f"node {self.name}: unknown op {self.op!r}")
        if (self.layer is not None) != (self.op == "conv"):
            raise ValueError(f"node {self.name}: op={self.op!r} "
                             f"{'requires' if self.op == 'conv' else 'forbids'}"
                             " a ConvLayer")
        if self.op != "conv" and not self.inputs:
            raise ValueError(f"node {self.name}: op={self.op!r} needs inputs")


def resnet18_graph(image: int = 224, base: int = 64) -> list[GraphNode]:
    """ResNet-18 feature extractor as a DAG: a 7x7/s2 stem, a 2x2/s2 max
    pool, then four stages of two basic blocks (3x3 + 3x3 + residual
    add); the first block of stages 2-4 strides by 2 with a 1x1/s2
    projection conv on the skip edge.  ``base``/``image`` shrink the
    topology for the CPU tests (defaults are the paper-scale ImageNet
    configuration)."""
    stem = ConvLayer("conv1", image, 3, base, kernel=7, stride=2, padding=3)
    nodes = [GraphNode("conv1", "conv", (), stem),
             GraphNode("pool1", "pool", ("conv1",), pool=2, pool_window=2)]
    prev, size, cin = "pool1", stem.out_size // 2, base
    for stage in range(1, 5):
        cout = base << (stage - 1)
        for b in range(2):
            stride = 2 if (stage > 1 and b == 0) else 1
            tag = f"l{stage}b{b}"
            c1 = ConvLayer(f"{tag}_conv1", size, cin, cout, kernel=3,
                           stride=stride, padding=1)
            c2 = ConvLayer(f"{tag}_conv2", c1.out_size, cout, cout,
                           kernel=3, stride=1, padding=1)
            nodes.append(GraphNode(c1.name, "conv", (prev,), c1))
            nodes.append(GraphNode(c2.name, "conv", (c1.name,), c2))
            skip = prev
            if stride != 1 or cin != cout:
                ds = ConvLayer(f"{tag}_down", size, cin, cout, kernel=1,
                               stride=stride)
                nodes.append(GraphNode(ds.name, "conv", (prev,), ds))
                skip = ds.name
            nodes.append(GraphNode(f"{tag}_add", "add", (c2.name, skip)))
            prev, size, cin = f"{tag}_add", c1.out_size, cout
    return nodes


def unet_graph(image: int = 64, base: int = 16, in_channels: int = 3,
               out_channels: int = 4, depth: int = 2) -> list[GraphNode]:
    """A small U-Net: ``depth`` encoder levels (two 3x3 convs + 2x2/s2
    pool each), a two-conv bottleneck, then mirrored decoder levels
    (nearest x2 upsample, channel-halving 3x3, concat with the encoder
    skip, two 3x3 convs) and a 1x1 head.  Skip edges tap the *pre*-pool
    encoder activations, so their liveness spans the whole U."""
    if image % (1 << depth):
        raise ValueError(f"image {image} not divisible by 2^{depth}")
    nodes: list[GraphNode] = []
    prev: str | None = None

    def conv(name, ifmap, ci, co, k=3, p=1):
        l = ConvLayer(name, ifmap, ci, co, kernel=k, stride=1, padding=p)
        nodes.append(GraphNode(name, "conv",
                               (prev,) if prev else (), l))
        return name

    size, cin, skips = image, in_channels, []
    for lv in range(depth):
        c = base << lv
        prev = conv(f"enc{lv}a", size, cin, c)
        prev = conv(f"enc{lv}b", size, c, c)
        skips.append((prev, size, c))
        nodes.append(GraphNode(f"pool{lv}", "pool", (prev,),
                               pool=2, pool_window=2))
        prev, size, cin = f"pool{lv}", size // 2, c
    c = base << depth
    prev = conv("mid_a", size, cin, c)
    prev = conv("mid_b", size, c, c)
    cin = c
    for lv in reversed(range(depth)):
        c = base << lv
        nodes.append(GraphNode(f"up{lv}", "upsample", (prev,), scale=2))
        prev, size = f"up{lv}", size * 2
        prev = conv(f"dec{lv}r", size, cin, c)
        skip, _, _ = skips[lv]
        nodes.append(GraphNode(f"cat{lv}", "concat", (prev, skip)))
        prev = f"cat{lv}"
        prev = conv(f"dec{lv}a", size, 2 * c, c)
        prev = conv(f"dec{lv}b", size, c, c)
        cin = c
    conv("out", size, cin, out_channels, k=1, p=0)
    return nodes


def fig6(network: str = "vgg16") -> list[dict]:
    layers = {"vgg16": vgg16_layers, "alexnet": alexnet_layers,
              "mobilenet": mobilenet_layers}[network]()
    return [compare_layer(l) for l in layers]


# ---------------------------------------------------------------------------
# GeMM (im2col) baseline — the redundancy the Conv-based dataflows avoid
# ---------------------------------------------------------------------------

def im2col_ifmap_reads(layer: ConvLayer) -> int:
    """im2col materializes every window: K^2 redundancy at the memory level."""
    return (layer.out_size ** 2) * (layer.kernel ** 2) * layer.in_channels


def gemm_accesses(layer: ConvLayer, filter_parallel: int = 8) -> int:
    filter_passes = math.ceil(layer.out_channels / filter_parallel)
    return (im2col_ifmap_reads(layer) * filter_passes
            + layer.out_channels * layer.in_channels * layer.kernel ** 2)
