"""Decoder-only LM (dense / MoE / VLM) and encoder-decoder stacks — the
counterpart of ``repro/models/transformer.py``.

Parameters keep the JAX tree and layout: ``tok {embed, head}``, ``blocks``
stacked over a leading layer axis (``wq (L, d, h, hd)``, ``wo (L, h, hd,
d)``, ...), ``ln_f`` and, for VLMs, ``vision_proj``; an encoder-decoder
has ``tok``, ``enc_blocks``, ``enc_ln``, ``dec_blocks`` (each block with
``ln_cross`` and ``cross``, the cross-attention onto the encoder output)
and ``dec_ln``.  A Python loop over the layer axis (:func:`_run_blocks`,
both stacks) takes the place of ``lax.scan``.  Each stacked leaf is
cut into its layers once a forward with ``torch.unbind`` (views; under
grad one gradient buffer per leaf, where ``tree[i]`` would allocate a zero
tensor the size of the whole leaf per layer in its backward).  Under grad
with ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of JAX's
``jax.checkpoint(..., nothing_saveable)`` (``repro/models/transformer.py:
75-77``): only the block inputs are kept, and the backward recomputes each
block's forward.  A MoE block (``family == "moe"``) has ``moe`` where the
others have ``mlp``; its load-balance aux is summed over the stack in
layer order (the scan's carry in JAX) and returned beside the output.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.base import Param, stack_params
from repro_torch.models.config import ModelConfig


def block_params(cfg: ModelConfig, cross: bool = False) -> dict:
    p = {"ln_att": L.norm_params(cfg), "att": L.attention_params(cfg),
         "ln_mlp": L.norm_params(cfg)}
    if cross:
        p["ln_cross"] = L.norm_params(cfg)
        p["cross"] = L.attention_params(cfg)
    if cfg.family == "moe":
        p["moe"] = L.moe_params(cfg)
    else:
        p["mlp"] = L.mlp_params(cfg)
    return p


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions,
                kv_cache=None, cache_len=None, causal: bool = True,
                encoder_out=None, cross_cache=None):
    """One pre-norm block -> (x, aux): self-attention (non-causal for the
    encoder), the cross-attention onto ``encoder_out`` or its static
    ``cross_cache`` where either is given, then the MLP, or the experts
    (``moe_apply``: aux its load-balance loss; 0.0 for an MLP block).  A
    ``kv_cache`` is updated in place; a ``cross_cache`` is only read."""
    x = x + L.attention_apply(
        p["att"], L.norm_apply(p["ln_att"], x, cfg), cfg,
        positions=positions, kv_cache=kv_cache, cache_len=cache_len,
        causal=causal, window=cfg.window)
    if encoder_out is not None or cross_cache is not None:
        x = x + L.attention_apply(
            p["cross"], L.norm_apply(p["ln_cross"], x, cfg), cfg,
            encoder_out=encoder_out, kv_cache=cross_cache, is_cross=True,
            causal=False, use_rope=False)
    z = L.norm_apply(p["ln_mlp"], x, cfg)
    if cfg.family == "moe":
        h, aux = L.moe_apply(p["moe"], z, cfg)
        return x + h, aux
    return x + L.mlp_apply(p["mlp"], z, cfg), 0.0


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


def _run_blocks(blocks: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions, n_layers: int, caches=None, cache_len=None,
                causal: bool = True, encoder_out=None,
                cross_caches=None):
    """The layer stack (``repro/models/transformer.py:63``) -> (x, aux):
    ``n_layers`` blocks of a stacked tree, each leaf cut once
    (:func:`layer_list`), their aux summed from 0.0 in layer order.
    ``caches`` / ``cross_caches``: ``{"k", "v"}`` stacked (L, B, Lmax,
    Hkv, hd) or None; layer i's self cache is updated in place.  Under
    grad with ``cfg.remat`` and no caches each block is checkpointed."""
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    aux_total = 0.0
    for i, pi in enumerate(layer_list(blocks, n_layers)):
        if remat:
            x, aux = checkpoint(block_apply, pi, x, cfg, positions=positions,
                                causal=causal, encoder_out=encoder_out,
                                use_reentrant=False)
        else:
            kv = None if caches is None else (caches["k"][i],
                                              caches["v"][i])
            xkv = None if cross_caches is None else (cross_caches["k"][i],
                                                     cross_caches["v"][i])
            x, aux = block_apply(pi, x, cfg, positions=positions,
                                 kv_cache=kv, cache_len=cache_len,
                                 causal=causal, encoder_out=encoder_out,
                                 cross_cache=xkv)
        aux_total = aux_total + aux
    return x, aux_total


# ---------------------------------------------------------------------------
# Decoder-only LM
# ---------------------------------------------------------------------------

def lm_params(cfg: ModelConfig) -> dict:
    p = {"tok": L.embedding_params(cfg),
         "blocks": stack_params(block_params(cfg), cfg.n_layers),
         "ln_f": L.norm_params(cfg)}
    if cfg.frontend == "vision":
        p["vision_proj"] = Param((cfg.d_model, cfg.d_model))
    return p


def make_caches(cfg: ModelConfig, batch: int, max_len: int,
                n_layers: int | None = None) -> dict:
    """Zero KV caches, stacked over ``n_layers`` (default
    ``cfg.n_layers``) layers: ``{"k", "v"}`` of shape (L, B, max_len, Hkv,
    hd)."""
    shape = (n_layers or cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.hd)
    return {"k": Param(shape, init="zeros"), "v": Param(shape, init="zeros")}


def _positions(x: torch.Tensor, cache_len) -> torch.Tensor:
    if cache_len is not None:
        return cache_len.reshape(-1, 1) - 1
    return torch.arange(x.shape[1], device=x.device)[None]


def lm_apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             caches=None, cache_len=None, vision_embeds=None):
    """tokens: (B, S) -> (logits (B, S[+Nv], vocab), caches, aux).

    Decode mode: S == 1 with ``caches``/``cache_len`` set; each layer's
    cache is updated in place and ``caches`` is returned.  ``aux``: the
    stack's summed MoE load-balance loss (0.0 for a dense stack).
    """
    x = L.embed_apply(params["tok"], tokens, cfg)
    if vision_embeds is not None:
        v = vision_embeds.to(x.dtype) @ params["vision_proj"]
        x = torch.cat([v, x], dim=1)
    x, aux = _run_blocks(params["blocks"], x, cfg,
                         positions=_positions(x, cache_len),
                         n_layers=cfg.n_layers, caches=caches,
                         cache_len=cache_len)
    x = L.norm_apply(params["ln_f"], x, cfg)
    logits = L.head_apply(params["tok"], x, cfg)
    if cfg.logits_soft_cap:
        logits = cfg.logits_soft_cap * torch.tanh(
            logits / cfg.logits_soft_cap)
    return logits, caches, aux


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t backbone; the frontend is a stub)
# ---------------------------------------------------------------------------

def encdec_params(cfg: ModelConfig) -> dict:
    return {"tok": L.embedding_params(cfg),
            "enc_blocks": stack_params(block_params(cfg), cfg.enc_layers),
            "enc_ln": L.norm_params(cfg),
            "dec_blocks": stack_params(block_params(cfg, cross=True),
                                       cfg.dec_layers),
            "dec_ln": L.norm_params(cfg)}


def encdec_apply(params: dict, src_embeds, tokens: torch.Tensor,
                 cfg: ModelConfig, *, caches=None, cache_len=None,
                 cross_caches=None):
    """src_embeds: (B, Ls, d_model) frame embeddings (the frontend stub),
    in the params' dtype; tokens: (B, S) -> (logits (B, S, vocab), caches,
    cross_caches) (``repro/models/transformer.py:179``).

    Prefill / training: the encoder's ``enc_layers`` non-causal blocks
    (RoPE over the source positions), then the causal decoder, each
    block's cross-attention onto the normed encoder output.  Decode
    (``cross_caches`` set, ``src_embeds`` unused): the encoder does not
    run; the decoder's self caches are updated in place and its
    cross-attention reads the static ``cross_caches``.
    """
    enc = None
    if cross_caches is None:
        want = params["tok"]["embed"].dtype
        if src_embeds.dtype != want:
            raise ValueError(
                f"src is {src_embeds.dtype}: the encoder takes its frame "
                f"embeddings in the params' dtype, {want} (JAX's "
                "input_specs builds them in the activation dtype); cast "
                "them before the call")
        enc, _ = _run_blocks(params["enc_blocks"], src_embeds, cfg,
                             positions=_positions(src_embeds, None),
                             n_layers=cfg.enc_layers, causal=False)
        enc = L.norm_apply(params["enc_ln"], enc, cfg)
    x = L.embed_apply(params["tok"], tokens, cfg)
    x, _ = _run_blocks(params["dec_blocks"], x, cfg,
                       positions=_positions(x, cache_len),
                       n_layers=cfg.dec_layers, caches=caches,
                       cache_len=cache_len, encoder_out=enc,
                       cross_caches=cross_caches)
    x = L.norm_apply(params["dec_ln"], x, cfg)
    return L.head_apply(params["tok"], x, cfg), caches, cross_caches
