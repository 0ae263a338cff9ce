"""Move a JAX parameter tree into the port.

``params_from_jax`` takes a parameter tree of the JAX package after
``init_params`` — ``cnn_params_from_layers``'s (``conv{i}``, ``head``),
``simple_cnn_params``' (``conv{i}``, ``down{i}``, ``dw``, ``head``) or an
LM's ``api.params`` (``tok {embed, head}``, ``blocks`` stacked over a
leading layer axis — ``wq (L, d, h, hd)``, ``wo (L, h, hd, d)``, ... —
``ln_f``, ``vision_proj``; for the mamba family ``blocks.mixer.{w_in,
conv_w, conv_b, w_x, w_dt, dt_bias, a_log, d_skip, w_out}`` and
``blocks.ln``; for the MoE family ``blocks.moe.{router (L, d, e), w_gate
(L, e, d, f), w_up (L, e, d, f), w_down (L, e, f, d)}`` and, with a
shared expert, ``blocks.moe.shared.{w_gate, w_up, w_down}``) — already
converted to numpy arrays
(``jax.tree.map(np.asarray, params)``), and returns the same tree as
tensors, keys, nesting and layouts unchanged (bf16 leaves as bf16, other
floating leaves as float32, integer leaves in their own dtype): the
``params`` of
``models.layers.TrimCNN``, of the functional ``*_apply`` forwards and of
``models.api``, whose LM keeps the JAX layout for exactly this reason.
``moments_from_jax`` does the same for AdamW's ``{"mu", "nu"}`` state, and
``train_state_from_jax`` for a whole LM train state (``train_state_decl``'s
``{"params", "opt": {"mu", "nu"}, "step"}``).  Both packages then compute
the same function and take the same optimiser step, which is what the
parity tests compare.

A packed conv entry of the JAX package, ``{"packed":
PackedConv2dWeights}``, has its padded kernel layout unpacked to the
logical ``(K, K, Cin/g, Cout)`` weights and ``(Cout,)`` rows, as the JAX
``_unpack_weights`` and ``_unpack_cout_row`` do (``repro/kernels/ops.py:
337``, ``:696``).  With its quantization leaves set
(``layers.calibrate_conv2d``) it becomes ``{"packed":
ops.QuantizedConv2dWeights}``, int8 kept int8 and int32 kept int32.  An
f32 one (``layers.cnn_pack_params``) becomes ``{"packed":
ops.PackedConv2dWeights}``: the ``dataflow`` hint is kept (carry and halo
mean the same in both packages); ``tile_h`` and ``tile_cout`` are
dropped, since they size a TPU VMEM strip and a 128-lane C_out tile, not
a Hopper plan, so the port's cache and planner choose them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import (PackedConv2dWeights,
                                     QuantizedConv2dWeights)


def _tensor(leaf, device) -> torch.Tensor:
    """One leaf as a contiguous tensor on ``device``: bf16 leaves as bf16,
    bit for bit, other floating leaves as float32, integer ones in their
    own dtype.  A JAX bf16 array reaches numpy as a ``bfloat16`` array of
    the ``ml_dtypes`` package, which ships with JAX; it is read by its
    bits (as int16), so the port needs no such package."""
    if isinstance(leaf, torch.Tensor):
        dtype = leaf.dtype
        if dtype.is_floating_point and dtype != torch.bfloat16:
            dtype = torch.float32
        return leaf.to(device=device, dtype=dtype).contiguous()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(np.array(bits)).view(torch.bfloat16) \
            .to(device)
    if not np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.float32)
    # a copy: JAX hands out read-only buffers
    return torch.from_numpy(np.array(arr)).to(device)


def _unpack(leaf, groups: int, cout: int, device) -> torch.Tensor:
    """The JAX packed layout's last axis ``groups * cout_padded`` cut back
    to the logical ``cout``: weights ``(K, K, Cin/g, G*CoutP)`` or a
    ``(1, G*CoutP)`` row (-> ``(Cout,)``)."""
    t = _tensor(leaf, device)
    lead = t.shape[:-1] if t.dim() == 4 else ()
    cpp = t.shape[-1] // groups
    t = t.reshape(*lead, groups, cpp)[..., :cout // groups]
    return t.reshape(*lead, cout).contiguous()


def _packed_from_jax(pk, device):
    """A JAX ``PackedConv2dWeights`` (numpy leaves) -> the port's packed
    f32 or quantized entry (module docstring)."""
    g, cout = int(pk.groups), int(pk.cout)
    bias = None if pk.bias is None else _unpack(pk.bias, g, cout, device)
    if pk.scale is None:
        return PackedConv2dWeights(
            w=_unpack(pk.w, g, cout, device), bias=bias, groups=g, cout=cout,
            dataflow=pk.dataflow)
    return QuantizedConv2dWeights(
        w=_unpack(pk.w, g, cout, device), bias=bias,
        scale=_unpack(pk.scale, g, cout, device),
        zero_point=_tensor(pk.zero_point, device),
        input_scale=_tensor(pk.input_scale, device), groups=g, cout=cout)


def params_from_jax(tree, *, device="cpu") -> dict:
    """A nested dict of numpy arrays (or tensors), e.g. ``{"conv{i}":
    {"w", "b"}, "head": {"w", "b"}}`` -> the same tree of contiguous
    tensors on ``device`` (bf16 kept bf16, other floats float32, or the
    leaf's integer dtype); a JAX
    ``PackedConv2dWeights`` -> ``PackedConv2dWeights`` (f32) or
    ``QuantizedConv2dWeights`` (int8)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (PackedConv2dWeights, QuantizedConv2dWeights)):
        return tree.to(device)
    if hasattr(tree, "zero_point") and hasattr(tree, "tile_cout"):
        return _packed_from_jax(tree, device)
    return _tensor(tree, device)


def moments_from_jax(moments, *, device="cpu") -> dict:
    """``repro.optim.adamw.init_moments``' ``{"mu": tree, "nu": tree}``
    (numpy leaves) -> the port's AdamW moments: float32 tensors on
    ``device``."""
    return {k: params_from_jax(moments[k], device=device)
            for k in ("mu", "nu")}


def train_state_from_jax(state, *, device="cpu") -> dict:
    """A JAX LM train state (``repro.distributed.steps.train_state_decl``
    after ``init_params`` or a train step; numpy leaves) -> the port's
    ``{"params", "opt": {"mu", "nu"}, "step"}``: params and moments as
    float32 tensors on ``device`` (``params_from_jax``,
    ``moments_from_jax``), the step a 0-d int32 tensor."""
    return {"params": params_from_jax(state["params"], device=device),
            "opt": moments_from_jax(state["opt"], device=device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
