"""Move a JAX parameter tree into the port.

``params_from_jax`` takes the tree of ``repro.models.layers.
cnn_params_from_layers`` after ``init_params``, already converted to numpy
arrays (``jax.tree.map(np.asarray, params)``), and returns the same tree
as float32 tensors: the ``params`` of ``models.layers.TrimCNN`` and of the
functional ``cnn_apply_from_layers``.  Both packages then compute the same
function, which is what the parity tests compare.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, *, device="cpu") -> dict:
    """``{"conv{i}": {"w", "b"}, "head": {"w", "b"}}`` of numpy arrays (or
    tensors) -> the same tree of contiguous float32 tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32).contiguous()
    # a copy: JAX hands out read-only buffers
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
