"""Decoder-only LM (dense / VLM) — the counterpart of
``repro/models/transformer.py``.

Parameters keep the JAX tree and layout: ``tok {embed, head}``, ``blocks``
stacked over a leading layer axis (``wq (L, d, h, hd)``, ``wo (L, h, hd,
d)``, ...), ``ln_f`` and, for VLMs, ``vision_proj``.  A Python loop over
the layer axis takes the place of ``lax.scan``.  Each stacked leaf is
cut into its layers once a forward with ``torch.unbind`` (views; under
grad one gradient buffer per leaf, where ``tree[i]`` would allocate a zero
tensor the size of the whole leaf per layer in its backward).  Under grad
with ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of JAX's
``jax.checkpoint(..., nothing_saveable)`` (``repro/models/transformer.py:
75-77``): only the block inputs are kept, and the backward recomputes each
block's forward.  Encoder-decoder stacks and MoE blocks are not ported yet
(ROADMAP Queue 1 items 2e and 2d).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.base import Param, stack_params
from repro_torch.models.config import ModelConfig


def block_params(cfg: ModelConfig) -> dict:
    return {"ln_att": L.norm_params(cfg), "att": L.attention_params(cfg),
            "ln_mlp": L.norm_params(cfg), "mlp": L.mlp_params(cfg)}


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions,
                kv_cache=None, cache_len=None) -> torch.Tensor:
    """One pre-norm decoder block; a ``kv_cache`` is updated in place."""
    x = x + L.attention_apply(
        p["att"], L.norm_apply(p["ln_att"], x, cfg), cfg,
        positions=positions, kv_cache=kv_cache, cache_len=cache_len,
        window=cfg.window)
    z = L.norm_apply(p["ln_mlp"], x, cfg)
    return x + L.mlp_apply(p["mlp"], z, cfg)


def layer_slice(tree, i: int):
    """Layer ``i`` of a tree stacked over a leading layer axis (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


def layer_list(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf cut once with
    ``torch.unbind`` (views; under grad one backward node a leaf)."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree))
    per_key = {k: layer_list(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def lm_params(cfg: ModelConfig) -> dict:
    p = {"tok": L.embedding_params(cfg),
         "blocks": stack_params(block_params(cfg), cfg.n_layers),
         "ln_f": L.norm_params(cfg)}
    if cfg.frontend == "vision":
        p["vision_proj"] = Param((cfg.d_model, cfg.d_model))
    return p


def make_caches(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Zero KV caches, stacked over layers: ``{"k", "v"}`` of shape
    (L, B, max_len, Hkv, hd)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": Param(shape, init="zeros"), "v": Param(shape, init="zeros")}


def lm_apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             caches=None, cache_len=None, vision_embeds=None):
    """tokens: (B, S) -> (logits (B, S[+Nv], vocab), caches).

    Decode mode: S == 1 with ``caches``/``cache_len`` set; each layer's
    cache is updated in place and ``caches`` is returned.
    """
    x = L.embed_apply(params["tok"], tokens, cfg)
    if vision_embeds is not None:
        v = vision_embeds.to(x.dtype) @ params["vision_proj"]
        x = torch.cat([v, x], dim=1)
    if cache_len is not None:
        positions = cache_len.reshape(-1, 1) - 1
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None]
    # blocks rematerialised when training (grad on, no caches)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, pi in enumerate(layer_list(params["blocks"], cfg.n_layers)):
        kv = None if caches is None else (caches["k"][i], caches["v"][i])
        if remat:
            x = checkpoint(block_apply, pi, x, cfg, positions=positions,
                           use_reentrant=False)
        else:
            x = block_apply(pi, x, cfg, positions=positions, kv_cache=kv,
                            cache_len=cache_len)
    x = L.norm_apply(params["ln_f"], x, cfg)
    logits = L.head_apply(params["tok"], x, cfg)
    if cfg.logits_soft_cap:
        logits = cfg.logits_soft_cap * torch.tanh(
            logits / cfg.logits_soft_cap)
    return logits, caches
