"""Serving steps (the counterpart of the serving half of
``repro/distributed/steps.py``).

Plain closures on the caller's device, without jit or shardings: the
port's LM runs on one card.  Both run under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """``prefill(params, batch) -> (logits, next_tok)``: the full-sequence
    forward and the greedy next token from the last position."""
    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = api.forward(params, batch, cfg)
        return logits, torch.argmax(logits[:, -1], dim=-1)
    return prefill


def make_decode_step(cfg: ModelConfig):
    """``decode(params, state, batch) -> (next_tok, state)``: one token
    through the decode state (KV caches, ring KV caches, conv windows, SSM
    or LRU states; updated in place) and its greedy successor."""
    @torch.no_grad()
    def decode(params, state, batch):
        logits, state = api.decode(params, batch, state, cfg)
        return torch.argmax(logits[:, -1], dim=-1).int(), state
    return decode
