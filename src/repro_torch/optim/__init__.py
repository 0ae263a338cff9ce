"""Optimisers of the port (the counterpart of ``repro/optim``)."""

from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["AdamWConfig", "adamw"]
