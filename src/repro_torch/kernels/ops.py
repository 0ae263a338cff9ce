"""Operator API over the port's conv kernels (``repro/kernels/ops.py``).

``conv2d`` takes ``impl``:

  * ``"trim"`` — the 3D-TrIM kernel: the hand-written Hopper kernel on a
    CUDA tensor, its plain PyTorch version on a CPU tensor.
  * ``"ref"``  — the oracle of ``kernels/ref.py``.

There is no tier chain: a kernel that fails raises.  'same' padding is
XLA's (asymmetric at stride > 1) and is applied inside the kernel, so no
padded copy of the input is made.
"""

from __future__ import annotations

import torch

from repro_torch.core.conv_plan import DATAFLOWS
from repro_torch.kernels import ref
from repro_torch.kernels.ref import conv_pads
from repro_torch.kernels.trim_conv2d import trim_conv2d

MAX_NATIVE_K = 8


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
           dataflow: str | None = None) -> torch.Tensor:
    """(Grouped) 2D convolution with optional fused bias + activation.

    x: (N, H, W, Cin); w: (K, K, Cin/groups, Cout); bias: (Cout,) or None;
    ``feature_group_count=Cin`` gives depthwise convolution.  ``dataflow``
    (``"carry"`` by default, or ``"halo"``) and the tile knobs go to the
    kernel; knobs left as ``None`` take the plan's defaults.
    """
    if dataflow is not None and dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}; "
                         f"choose from {DATAFLOWS}")
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
        raise NotImplementedError(
            f"K={k} > {MAX_NATIVE_K} needs the adder-tree kernel tiling "
            "(ROADMAP Queue 1, item 1: K > 8 adder tree and AlexNet)")
    pads = conv_pads(x.shape[1], x.shape[2], k, stride, padding)
    return trim_conv2d(x, w, bias, stride=stride, pad=pads,
                       groups=feature_group_count, activation=activation,
                       dataflow=dataflow or "carry", tile_h=tile_h,
                       tile_cout=tile_cout)


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
