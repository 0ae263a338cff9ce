"""Convolution layers and whole-topology forward (the conv half of
``repro/models/layers.py``).

Functional core on trees of tensors — ``conv2d_apply``,
``cnn_apply_from_layers`` — as in the JAX package, and :class:`TrimCNN`,
the ``nn.Module`` that holds one topology's parameters and serves it.
Activations are NHWC and conv weights ``(K, K, Cin/groups, Cout)``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.netplan import infer_pools, layer_kernel_problem
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import maxpool2d
from repro_torch.models.base import Param, init_params


def conv2d_params(k: int, cin: int, cout: int, *, groups: int = 1,
                  bias: bool = True) -> dict:
    """Declarations for one (grouped) conv layer."""
    # init scales by 1/sqrt(shape[-2]) == 1/sqrt(cin/groups); the extra
    # 1/k recovers He-style 1/sqrt(K^2 * cin/groups) for conv taps
    p = {"w": Param((k, k, cin // groups, cout), scale=1.0 / k)}
    if bias:
        p["b"] = Param((cout,), init="zeros")
    return p


def conv2d_apply(p: dict, x: torch.Tensor, *, stride: int = 1,
                 padding: str = "same", groups: int = 1,
                 activation: str | None = "relu", impl: str = "trim",
                 dataflow: str | None = None) -> torch.Tensor:
    """One conv layer with the bias + activation epilogue fused into the
    kernel (one store of the output)."""
    return ops.conv2d(x, p["w"], stride=stride, padding=padding, impl=impl,
                      feature_group_count=groups, bias=p.get("b"),
                      activation=activation, dataflow=dataflow)


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


def head_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Global mean pool + linear, one row at a time: the reduction and
    matmul libraries pick their schedule by batch size, so a batched head
    could round a row differently from the same row served alone."""
    rows = [x[i:i + 1].mean(dim=(1, 2)) @ p["w"] + p["b"]
            for i in range(x.shape[0])]
    return torch.cat(rows)


def cnn_apply_from_layers(p: dict, layers_list, x: torch.Tensor, *,
                          activation: str | None = "relu",
                          impl: str = "trim", dataflow: str | None = None,
                          fused: bool = False) -> torch.Tensor:
    """Forward pass of a topology built by :func:`cnn_params_from_layers`:
    one kernel launch per conv layer (bias + activation fused), with the
    max pools inferred from the spatial dims between layers
    (``core.netplan.infer_pools``).  Returns class logits when the tree
    has a head, else the final feature map."""
    if fused:
        raise NotImplementedError(
            "fused residency groups are not ported yet (ROADMAP Queue 1, "
            "item 3: fused groups)")
    for i, (l, (ps, pw)) in enumerate(zip(layers_list,
                                          infer_pools(layers_list))):
        _, _, _, padding = layer_kernel_problem(l, n=x.shape[0])
        x = conv2d_apply(p[f"conv{i}"], x, stride=l.stride, padding=padding,
                         groups=l.groups, activation=activation, impl=impl,
                         dataflow=dataflow)
        if ps > 1 or pw > 1:      # (1, w>1): stride-1 overlapping pool
            x = maxpool2d(x, ps, pw)
    if "head" not in p:
        return x
    return head_apply(p["head"], x)


class _Leaf(nn.Module):
    """One ``{"w", "b"}`` entry of the tree as frozen parameters."""

    def __init__(self, leaf: dict):
        super().__init__()
        for name, t in leaf.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class TrimCNN(nn.Module):
    """A conv topology with its parameters, served by the TrIM kernels.

    ``params`` is the tree of :func:`cnn_params_from_layers` as tensors
    (``{"conv{i}": {"w", "b"}, "head": {"w", "b"}}``, e.g. from
    :meth:`random` or ``repro_torch.convert.params_from_jax``); the
    module lives on their device.  ``dataflow`` picks the conv kernel
    (``None`` is ``"carry"``).  Inference only: the parameters are frozen.
    """

    def __init__(self, layers_list, params: dict, *,
                 activation: str | None = "relu", impl: str = "trim",
                 dataflow: str | None = None):
        super().__init__()
        self.layers_list = list(layers_list)
        self.activation, self.impl, self.dataflow = activation, impl, dataflow
        self.params = nn.ModuleDict({k: _Leaf(v) for k, v in params.items()})

    @classmethod
    def random(cls, layers_list, *, n_classes: int | None = None,
               seed: int = 0, device=None, **kw) -> "TrimCNN":
        """Seeded random weights (``torch.Generator().manual_seed(seed)``)
        on ``device`` (default ``"cuda"``)."""
        dev = resolve_device(device)
        tree = init_params(cnn_params_from_layers(layers_list,
                                                  n_classes=n_classes),
                           torch.Generator().manual_seed(seed), device=dev)
        return cls(layers_list, tree, **kw)

    def tree(self) -> dict:
        """The parameters as the functional tree."""
        return {k: dict(m.named_parameters()) for k, m in self.params.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cnn_apply_from_layers(self.tree(), self.layers_list, x,
                                     activation=self.activation,
                                     impl=self.impl, dataflow=self.dataflow)
