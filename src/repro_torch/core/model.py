"""CNN topologies of the paper (copied from ``repro/core/model.py``).

Only the topology: the layer description, the VGG-16 / AlexNet /
MobileNet conv stacks, the DAG nodes of ResNet-18 and U-Net and the
kernel tiling's sub-kernel count.  The accelerator configurations and
the Fig. 6 access accounting stay with the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


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


def num_subkernels(kernel: int, native_k: int = 3) -> int:
    """Sub-kernels of the paper's kernel tiling (§III): one for K <= 3,
    else ``ceil(K / 3)^2`` (``core.tiling.subkernel_decomposition``)."""
    if kernel <= native_k:
        return 1
    t = math.ceil(kernel / native_k)
    return t * t


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
