"""Move a JAX parameter tree into the port.

``params_from_jax`` takes a parameter tree of the JAX package after
``init_params`` — ``cnn_params_from_layers``'s (``conv{i}``, ``head``),
``simple_cnn_params``' (``conv{i}``, ``down{i}``, ``dw``, ``head``) or an
LM's ``api.params`` (``tok {embed, head}``, ``blocks`` stacked over a
leading layer axis — ``wq (L, d, h, hd)``, ``wo (L, h, hd, d)``, ... —
``ln_f``, ``vision_proj``; for the mamba family ``blocks.mixer.{w_in,
conv_w, conv_b, w_x, w_dt, dt_bias, a_log, d_skip, w_out}`` and
``blocks.ln``) — already converted to numpy arrays
(``jax.tree.map(np.asarray, params)``), and returns the same tree as
float32 tensors, keys, nesting and layouts unchanged: the ``params`` of
``models.layers.TrimCNN``, of the functional ``*_apply`` forwards and of
``models.api``, whose LM keeps the JAX layout for exactly this reason.
``moments_from_jax`` does the same for AdamW's ``{"mu", "nu"}`` state.
Both packages then compute the same function and take the same optimiser
step, which is what the parity tests compare.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, *, device="cpu") -> dict:
    """A nested dict of numpy arrays (or tensors), e.g. ``{"conv{i}":
    {"w", "b"}, "head": {"w", "b"}}`` -> the same tree of contiguous
    float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32).contiguous()
    # a copy: JAX hands out read-only buffers
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def moments_from_jax(moments, *, device="cpu") -> dict:
    """``repro.optim.adamw.init_moments``' ``{"mu": tree, "nu": tree}``
    (numpy leaves) -> the port's AdamW moments: float32 tensors on
    ``device``."""
    return {k: params_from_jax(moments[k], device=device)
            for k in ("mu", "nu")}
