"""RecurrentGemma-style hybrid (recurrentgemma-2b): RG-LRU recurrent blocks
and local attention (the counterpart of ``repro/models/rglru.py``).

Block pattern ``cfg.block_pattern``, e.g. ("rec", "rec", "att").  The
recurrent mixer: a linear branch and a GeLU gate branch, the temporal
conv (``ops.depthwise_conv1d``: the ``trim_conv1d`` kernel on a CUDA
tensor, one launch a rec layer of the prefill; the JAX mixer calls the
same op with ``impl="ref"``, and kernel and oracle agree bit for bit),
the RG-LRU diagonal recurrence as one associative scan over the whole
length in plain PyTorch (the state is (B, L, W), with no state dimension,
so no chunking), and the gated output projection.

Local attention layers run ``layers.attention_apply`` with
``window=cfg.window`` in the prefill (``ops.attention``: the flash kernel
under ``attn_impl="flash"``).  In decode they keep a ring-buffer KV cache
of ``cfg.window`` slots: the new token's k/v go to slot ``(pos - 1) mod
window``, and ``ops.decode_attention`` reads the valid prefix
``min(cache_len, window)`` with no window mask (attention is invariant
under a permutation of its keys, so the ring's order does not matter).

Parameters keep the JAX tree: ``tok``, ``ln_f`` and per-layer dicts
``blocks.layer_{i}`` (not stacked; ``att`` or ``rec``, with ``ln_mix``,
``ln_mlp`` and ``mlp``).  The decode state ``{"layer_{i}": {"k", "v"}
| {"conv", "h"}}`` is updated in place (the JAX function returns
updated copies).

Training: under grad the conv runs ``_TrimConv1dFn`` and the local
attention ``_FlashAttentionFn`` (the backward kernels); the RG-LRU scan
differentiates through plain autograd (the JAX package has no scan
kernel either).  With ``cfg.remat`` and no decode state each block runs
under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``repro/models/rglru.py:176-178``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.base import Param
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import _associative_scan, _softplus

_C = 8.0  # RG-LRU constant


def rec_mixer_params(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "w_x": Param((d, w)),
        "w_gate": Param((d, w)),
        "conv_w": Param((cfg.d_conv, w), scale=0.5),
        "conv_b": Param((w,), init="zeros"),
        "w_a": Param((w, w), scale=0.1),
        "b_a": Param((w,), init="zeros"),
        "w_i": Param((w, w), scale=0.1),
        "b_i": Param((w,), init="zeros"),
        "lam": Param((w,), init="ones"),
        "w_out": Param((w, d)),
    }


def _rg_lru(xb: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
            lam: torch.Tensor, h0: torch.Tensor | None = None):
    """h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), by one
    inclusive associative scan over the whole length; an initial state
    ``h0`` (B, W) enters after the scan, as ``h + a_cum * h0``.  Returns
    (h (B, L, W), h[:, -1])."""
    log_a = -_C * _softplus(lam) * r                         # (B, L, W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb)
    a_cum, h = _associative_scan(a, gated)
    if h0 is not None:
        h = h + a_cum * h0[:, None]
    return h, h[:, -1]


def rec_mixer_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    state=None) -> torch.Tensor:
    """The recurrent mixer.  ``state=(conv_state, h)`` — one layer's decode
    state — selects decode mode (L == 1) and is updated in place."""
    xb = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    if state is None:
        xb = ops.depthwise_conv1d(xb, p["conv_w"]) + p["conv_b"]
        h0 = None
    else:
        conv_state, h0 = state
        new_conv, xb1 = ops.depthwise_conv1d_step(conv_state, xb[:, 0],
                                                  p["conv_w"])
        xb = (xb1 + p["conv_b"])[:, None]
    xf = xb.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"])
    h, h_last = _rg_lru(xf, r, i, p["lam"].float(), h0=h0)
    if state is not None:
        conv_state.copy_(new_conv)
        h0.copy_(h_last)
    return (h.to(x.dtype) * gate) @ p["w_out"]


def block_params(cfg: ModelConfig, kind: str) -> dict:
    p = {"ln_mix": L.norm_params(cfg), "ln_mlp": L.norm_params(cfg),
         "mlp": L.mlp_params(cfg)}
    if kind == "att":
        p["att"] = L.attention_params(cfg)
    else:
        p["rec"] = rec_mixer_params(cfg)
    return p


def lm_params(cfg: ModelConfig) -> dict:
    blocks = {f"layer_{i}": block_params(cfg, cfg.pattern_at(i))
              for i in range(cfg.n_layers)}
    return {"tok": L.embedding_params(cfg), "blocks": blocks,
            "ln_f": L.norm_params(cfg)}


def make_state(cfg: ModelConfig, batch: int) -> dict:
    """Per-layer decode state (zeros): a ring KV cache of ``cfg.window``
    slots (att) or the conv window and the LRU state (rec), the LRU state
    f32 in a model of any dtype (``repro/models/rglru.py:118``).  It does
    not grow with the sequence, so it takes no ``max_len``."""
    w = cfg.lru_width or cfg.d_model
    state = {}
    for i in range(cfg.n_layers):
        if cfg.pattern_at(i) == "att":
            shape = (batch, cfg.window, cfg.n_kv_heads, cfg.hd)
            state[f"layer_{i}"] = {"k": Param(shape, init="zeros"),
                                   "v": Param(shape, init="zeros")}
        else:
            state[f"layer_{i}"] = {
                "conv": Param((batch, cfg.d_conv - 1, w), init="zeros"),
                "h": Param((batch, w), init="zeros", dtype=torch.float32)}
    return state


def _ring_attention(p: dict, h: torch.Tensor, cfg: ModelConfig, st: dict,
                    positions: torch.Tensor,
                    cache_len: torch.Tensor) -> torch.Tensor:
    """One decode step of a local attention layer on its ring cache
    ``st`` (updated in place); the slot is computed on the device."""
    q = L.rope(torch.einsum("bld,dhk->blhk", h, p["wq"]), positions,
               cfg.rope_theta)
    k = L.rope(torch.einsum("bld,dhk->blhk", h, p["wk"]), positions,
               cfg.rope_theta)
    v = torch.einsum("bld,dhk->blhk", h, p["wv"])
    slot = ((cache_len.max() - 1) % cfg.window).reshape(1).long()
    st["k"].index_copy_(1, slot, k)
    st["v"].index_copy_(1, slot, v)
    o = ops.decode_attention(q, st["k"], st["v"],
                             torch.clamp(cache_len, max=cfg.window),
                             soft_cap=cfg.logits_soft_cap)
    return torch.einsum("blhk,hkd->bld", o, p["wo"])


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, state: dict | None = None,
                cache_len: torch.Tensor | None = None) -> torch.Tensor:
    """One pre-norm block, local attention or recurrent as its params hold
    ``att`` or ``rec``; a decode ``state`` (the layer's) is updated in
    place."""
    h = L.norm_apply(p["ln_mix"], x, cfg)
    if "att" in p:
        if state is None:
            y = L.attention_apply(p["att"], h, cfg, positions=positions,
                                  window=cfg.window)
        else:
            y = _ring_attention(p["att"], h, cfg, state, positions,
                                cache_len)
    else:
        y = rec_mixer_apply(p["rec"], h, cfg, state=None if state is None
                            else (state["conv"], state["h"]))
    x = x + y
    return x + L.mlp_apply(p["mlp"], L.norm_apply(p["ln_mlp"], x, cfg), cfg)


def lm_apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             state: dict | None = None, cache_len: torch.Tensor | None = None):
    """tokens (B, S) -> (logits (B, S, vocab), state).  ``state`` and
    ``cache_len`` (B,) select one-token decode; each layer's state is
    updated in place.  Under grad with ``cfg.remat`` each block is
    checkpointed."""
    x = L.embed_apply(params["tok"], tokens, cfg)
    if cache_len is not None:
        positions = cache_len.reshape(-1, 1) - 1
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None]
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = params["blocks"][f"layer_{i}"]
        if remat:
            x = checkpoint(block_apply, p, x, cfg, positions=positions,
                           use_reentrant=False)
        else:
            x = block_apply(p, x, cfg, positions=positions,
                            state=None if state is None
                            else state[f"layer_{i}"], cache_len=cache_len)
    x = L.norm_apply(params["ln_f"], x, cfg)
    logits = L.head_apply(params["tok"], x, cfg)
    if cfg.logits_soft_cap:
        logits = cfg.logits_soft_cap * torch.tanh(
            logits / cfg.logits_soft_cap)
    return logits, state
