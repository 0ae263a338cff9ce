"""CNN topologies of the paper (copied from ``repro/core/model.py``).

Only the topology: the layer description, the VGG-16 / AlexNet /
MobileNet conv stacks and the kernel tiling's sub-kernel count.  The
accelerator configurations and the Fig. 6 access accounting stay with
the JAX package.
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
