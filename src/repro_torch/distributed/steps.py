"""Train and serving steps (the counterpart of ``repro/distributed/
steps.py``).

Plain closures on the caller's device, without jit or shardings: the
port's LM runs on one card (``batch_shardings`` / ``state_shardings`` are
ROADMAP Queue 1 item 9).  The train state is the JAX package's tree,
``{"params", "opt": {"mu", "nu"}, "step"}``; the train step updates it in
place (the counterpart of JAX's state donation).  The serving steps run
under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.base import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator, device=None) -> dict:
    """The counterpart of ``train_state_decl`` (``repro/distributed/
    steps.py:31``) after ``init_params``: params drawn from ``generator``
    on ``device`` (its own device by default), zero AdamW moments and a
    0-d int32 step."""
    device = generator.device if device is None else device
    params = init_params(api.params(cfg), generator, device=device)
    return {"params": params, "opt": adamw.init_moments(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_micro: int = 1, accum_dtype=torch.float32):
    """``train_step(state, batch) -> (state, metrics)``, the counterpart of
    ``make_train_step`` (``repro/distributed/steps.py:77``).

    The loss is ``api.loss_fn`` of ``api.forward``, with the MoE family's
    load-balance aux (summed over its layers) weighted in as JAX's step
    adds it (``repro/distributed/steps.py:81-82``); the gradient is taken
    with ``torch.autograd.grad`` on detached views of the params (no copy).
    With ``n_micro > 1`` the batch splits along its first axis and the
    gradients sum in ``accum_dtype`` from zeros, micro-batch by
    micro-batch, then divide by ``n_micro``, as JAX's scan does.  AdamW
    then updates params, moments and step in place (``adamw.
    apply_updates_``), and the same state is returned.  Metrics: ``loss``,
    ``grad_norm``, ``lr`` (0-d tensors).  batch: ``tokens``, ``labels``
    (B, S) integer tensors on the params' device, and for an
    encoder-decoder ``src`` (B, Ls, d_model) in the params' dtype; every
    key splits into the micro-batches.

    bf16 params (``init_params(..., dtype=torch.bfloat16)``, the norms'
    scales f32 as in JAX) train as JAX's ``make_train_step`` trains them:
    the forward and backward run in the params' dtypes (the conv1d and
    flash kernels' bf16 routes), each gradient comes out in its leaf's
    dtype (``n_micro > 1``: summed in ``accum_dtype``), and AdamW updates
    each leaf in f32 and rounds it once to its dtype, the moments kept in
    ``opt_cfg.moment_dtype``."""

    def loss_and_grads(leaves, params, mb):
        live = [t.detach().requires_grad_() for t in leaves]
        logits, aux = api.forward(adamw.tree_unflatten(params, live), mb,
                                  cfg)
        loss = api.loss_fn(logits, mb["labels"], aux)
        return loss.detach(), torch.autograd.grad(loss, live)

    def train_step(state, batch):
        params = state["params"]
        leaves = adamw.tree_leaves(params)
        if n_micro == 1:
            loss, grads = loss_and_grads(leaves, params, batch)
        else:
            micro = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = [torch.zeros(t.shape, dtype=accum_dtype, device=t.device)
                     for t in leaves]
            loss = torch.zeros((), device=leaves[0].device)
            for i in range(n_micro):
                l, g = loss_and_grads(leaves, params,
                                      {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(accum_dtype))
                loss = loss + l
                del g
            loss = loss / n_micro
            for acc in grads:
                acc.div_(n_micro)
            grads = [g.to(torch.float32) for g in grads]
        metrics = adamw.apply_updates_(
            params, adamw.tree_unflatten(params, grads), state["opt"],
            state["step"], opt_cfg)
        metrics["loss"] = loss
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill(params, batch) -> (logits, next_tok)``: the full-sequence
    forward and the greedy next token from the last position.  batch:
    ``tokens`` (and ``vision`` for a VLM, ``src`` for an
    encoder-decoder)."""
    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = api.forward(params, batch, cfg)
        return logits, torch.argmax(logits[:, -1], dim=-1)
    return prefill


def make_decode_step(cfg: ModelConfig):
    """``decode(params, state, batch) -> (next_tok, state)``: one token
    through the decode state (KV caches, ring KV caches, conv windows, SSM
    or LRU states; updated in place; an encoder-decoder's static cross
    caches, read) and its greedy successor."""
    @torch.no_grad()
    def decode(params, state, batch):
        logits, state = api.decode(params, batch, state, cfg)
        return torch.argmax(logits[:, -1], dim=-1).int(), state
    return decode
