"""Unified model API (the counterpart of ``repro/models/api.py``).

``params(cfg)``                        -> Param declaration tree
``forward(params, batch, cfg)``        -> (logits, aux)     [prefill]
``decode(params, batch, state, cfg)``  -> (logits, state)
``decode_state(cfg, batch, max_len)``  -> Param tree of the decode state

Batch dict keys: ``tokens`` (B, S) int, plus ``vision`` (B, Nv, d) for a
VLM and ``src`` (B, Ls, d) for an encoder-decoder (frame embeddings in
the params' dtype); decode adds ``cache_len`` (B,), which the ssm family
ignores.  The port runs every family of the JAX package: dense, moe,
ssm, hybrid and encdec.
"""

from __future__ import annotations

import torch

from repro_torch.models import mamba, rglru, transformer
from repro_torch.models.config import ModelConfig


def params(cfg: ModelConfig) -> dict:
    if cfg.family == "ssm":
        return mamba.lm_params(cfg)
    if cfg.family == "hybrid":
        return rglru.lm_params(cfg)
    if cfg.family == "encdec":
        return transformer.encdec_params(cfg)
    return transformer.lm_params(cfg)


def forward(p: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence forward (training / prefill).  Returns (logits, aux):
    aux is the MoE family's load-balance loss summed over its layers (a
    0-d tensor), 0.0 for the other families."""
    if cfg.family == "ssm":
        logits, _ = mamba.lm_apply(p, batch["tokens"], cfg)
    elif cfg.family == "hybrid":
        logits, _ = rglru.lm_apply(p, batch["tokens"], cfg)
    elif cfg.family == "encdec":
        logits, _, _ = transformer.encdec_apply(p, batch["src"],
                                                batch["tokens"], cfg)
    else:
        logits, _, aux = transformer.lm_apply(
            p, batch["tokens"], cfg, vision_embeds=batch.get("vision"))
        return logits, aux
    return logits, 0.0


def decode_state(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Param declaration tree of the decode-time state: zero KV caches;
    for the ssm family the zero conv windows and SSM states, for the
    hybrid family per-layer ring KV caches of ``cfg.window`` slots or conv
    windows and LRU states (neither takes ``max_len``: the state does not
    grow); for the encdec family the decoder's ``caches`` and its static
    ``cross`` caches of ``cfg.n_frontend_tokens or 1`` entries, both over
    ``cfg.dec_layers`` layers (zero: JAX's ``decode_state`` fills no
    cross cache either)."""
    if cfg.family == "ssm":
        return mamba.make_state(cfg, batch)
    if cfg.family == "hybrid":
        return rglru.make_state(cfg, batch)
    if cfg.family == "encdec":
        return {"caches": transformer.make_caches(cfg, batch, max_len,
                                                  cfg.dec_layers),
                "cross": transformer.make_caches(
                    cfg, batch, cfg.n_frontend_tokens or 1, cfg.dec_layers)}
    return {"caches": transformer.make_caches(cfg, batch, max_len)}


def decode(p: dict, batch: dict, state: dict, cfg: ModelConfig):
    """One-token decode step.  batch: tokens (B, 1), cache_len (B,).
    Returns (logits (B, 1, V), state); the state is updated in place (an
    encdec state's ``cross`` caches are only read)."""
    if cfg.family == "ssm":
        return mamba.lm_apply(p, batch["tokens"], cfg, state=state)
    if cfg.family == "hybrid":
        return rglru.lm_apply(p, batch["tokens"], cfg, state=state,
                              cache_len=batch["cache_len"])
    if cfg.family == "encdec":
        logits, caches, cross = transformer.encdec_apply(
            p, None, batch["tokens"], cfg, caches=state["caches"],
            cache_len=batch["cache_len"], cross_caches=state["cross"])
        return logits, {"caches": caches, "cross": cross}
    logits, caches, _ = transformer.lm_apply(
        p, batch["tokens"], cfg, caches=state["caches"],
        cache_len=batch["cache_len"])
    return logits, {"caches": caches}


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, aux=0.0,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy (+ the MoE load-balance aux)."""
    if logits.shape[1] != labels.shape[1]:       # VLM: vision prefix
        logits = logits[:, -labels.shape[1]:]
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    return nll.mean() + aux_weight * aux
