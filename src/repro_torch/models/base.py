"""Parameter declarations and their seeded initialisation
(the counterpart of ``repro/models/base.py``).

Parameters are declared as :class:`Param` leaves in nested dicts and
materialised by :func:`init_params` from an explicit ``torch.Generator``,
with the distribution of the JAX ``init_params``: normal with
``std = scale / sqrt(shape[-2])`` (``shape[-1]`` for vectors), zeros or
ones.  A ``torch.Generator`` and ``jax.random`` give different numbers
from one seed, so tests that compare the two packages share converted
parameters (``repro_torch.convert``) instead.

A leaf is drawn whole in f32 on the generator's device, then cast, except
a leaf declared ``sliced`` (the MoE experts' weights): it is drawn one
slice of its leading axis at a time, each cast straight into the target
tensor, so no f32 temporary is larger than one slice (qwen3-moe-30b-a3b's
stacked ``w_gate`` is 9.66e9 elements: 38.7 GB as one f32 draw).

JAX's ``Param`` names its axes; the port's keeps one of those names, as
``experts``: a leaf with an experts axis (the MoE router and the experts'
weights), which ``configs.registry.count_active_params`` scales by
top_k / n_experts, as JAX's does for a leaf with ``"experts"`` in its
axes.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 1.0
    dtype: torch.dtype | None = None      # overrides the model dtype
    sliced: bool = False                  # drawn a leading slice at a time
    experts: bool = False                 # has an experts axis (JAX's
                                          # "experts" in Param.axes)


def stack_params(tree, n: int):
    """Add a leading stacked-layers dim of size ``n`` to every Param
    (``repro/models/base.py:41``).  The initialiser's fan-in stays
    ``shape[-2]`` of the stacked shape, as in JAX: a stacked ``wq`` of
    shape ``(L, d, h, hd)`` draws with ``std = 1 / sqrt(h)``."""
    if isinstance(tree, Param):
        return dataclasses.replace(tree, shape=(n, *tree.shape))
    return {k: stack_params(v, n) for k, v in tree.items()}


def tree_size(tree) -> int:
    """Number of elements declared by a tree of :class:`Param`, without
    materialising it."""
    if isinstance(tree, Param):
        return math.prod(tree.shape)
    return sum(tree_size(v) for v in tree.values())


def init_params(tree, generator: torch.Generator, *,
                device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32):
    """Materialise a tree of :class:`Param` into tensors on ``device``,
    each in its own ``dtype`` if it declares one, else in ``dtype``
    (``repro/models/base.py:56``).  Draws happen on the generator's device (the CPU for a default
    ``torch.Generator()``), so one seed gives the same weights on every
    device; a ``torch.Generator(device="cuda")`` draws a multi-GB model
    on the card."""
    if isinstance(tree, Param):
        dt = tree.dtype or dtype
        if tree.init == "zeros":
            return torch.zeros(tree.shape, dtype=dt, device=device)
        if tree.init == "ones":
            return torch.ones(tree.shape, dtype=dt, device=device)
        if tree.init != "normal":
            raise ValueError(f"unknown init {tree.init!r}")
        fan_in = tree.shape[-2] if len(tree.shape) >= 2 else tree.shape[-1]
        std = tree.scale / math.sqrt(max(fan_in, 1))
        if tree.sliced:
            out = torch.empty(tree.shape, dtype=dt, device=device)
            for part in out:
                part.copy_(torch.randn(
                    tree.shape[1:], generator=generator,
                    dtype=torch.float32, device=generator.device).mul_(std))
            return out
        v = torch.randn(tree.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        return v.mul_(std).to(device=device, dtype=dt)
    return {k: init_params(v, generator, device=device, dtype=dtype)
            for k, v in tree.items()}
