"""Parameter declarations and their seeded initialisation
(the counterpart of ``repro/models/base.py``).

Parameters are declared as :class:`Param` leaves in nested dicts and
materialised by :func:`init_params` from an explicit ``torch.Generator``,
with the distribution of the JAX ``init_params``: normal with
``std = scale / sqrt(shape[-2])`` (``shape[-1]`` for vectors), zeros or
ones.  A ``torch.Generator`` and ``jax.random`` give different numbers
from one seed, so tests that compare the two packages share converted
parameters (``repro_torch.convert``) instead.
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


def init_params(tree, generator: torch.Generator, *,
                device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32):
    """Materialise a tree of :class:`Param` into tensors on ``device``.
    Draws happen on the generator's device (the CPU for a default
    ``torch.Generator()``), so one seed gives the same weights on every
    device."""
    if isinstance(tree, Param):
        if tree.init == "zeros":
            return torch.zeros(tree.shape, dtype=dtype, device=device)
        if tree.init == "ones":
            return torch.ones(tree.shape, dtype=dtype, device=device)
        if tree.init != "normal":
            raise ValueError(f"unknown init {tree.init!r}")
        fan_in = tree.shape[-2] if len(tree.shape) >= 2 else tree.shape[-1]
        std = tree.scale / math.sqrt(max(fan_in, 1))
        v = torch.randn(tree.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        return (v * std).to(device=device, dtype=dtype)
    return {k: init_params(v, generator, device=device, dtype=dtype)
            for k, v in tree.items()}
