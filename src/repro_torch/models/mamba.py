"""Mamba-1 (the falcon-mamba-7b family): selective SSM with a causal conv1d
(the counterpart of ``repro/models/mamba.py``).

The temporal conv runs the ``trim_conv1d`` dataflow
(``ops.depthwise_conv1d``: the hand-written CUDA kernel on a CUDA tensor,
one launch a layer of the prefill; its plain version on a CPU tensor).
The JAX mixer calls the same op with ``impl="ref"``; kernel and oracle
compute the same function bit for bit.

The selective scan is plain PyTorch, as JAX computes it in jnp outside any
kernel: the sequence is cut into chunks of ``scan_chunk`` steps; within a
chunk the log-depth associative scan of ``jax.lax.associative_scan`` runs
(its odd/even recursion, replayed here with the same combine
``(a1 * a2, a2 * b1 + b2)``); the (B, D_inner, S) state carries across
chunks, so the (B, C, D_inner, S) tensors exist one chunk at a time.

Parameters keep the JAX tree and layout (``blocks.mixer.{w_in, conv_w,
conv_b, w_x, w_dt, dt_bias, a_log, d_skip, w_out}``, ``blocks.ln``,
``ln_f``, ``tok``), stacked over a leading layer axis and cut into their
layers once a forward with ``transformer.layer_list``.  Decode (L = 1)
updates the state ``{"conv": (L, B, K-1, Din), "ssm": (L, B, Din, S)}``
in place.

Training: under grad the conv runs ``_TrimConv1dFn`` (the backward
kernels), the scan differentiates through plain autograd, and each scan
chunk runs under ``torch.utils.checkpoint`` (non-reentrant), the
counterpart of ``jax.checkpoint(one_chunk)`` (``repro/models/mamba.py:
91``): a chunk's (B, C, Din, S) tensors are rebuilt in the backward, one
chunk at a time.  With ``cfg.remat`` each layer is checkpointed too, the
counterpart of ``repro/models/mamba.py:160-162``.  Without grad nothing
is checkpointed and serving computes what it computed before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.base import Param, stack_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_list


def mixer_params(cfg: ModelConfig) -> dict:
    d, din, s, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {
        "w_in": Param((d, 2 * din)),
        "conv_w": Param((cfg.d_conv, din), scale=0.5),
        "conv_b": Param((din,), init="zeros"),
        "w_x": Param((din, r + 2 * s)),
        "w_dt": Param((r, din)),
        "dt_bias": Param((din,), init="zeros"),
        "a_log": Param((din, s), init="ones"),
        "d_skip": Param((din,), init="ones"),
        "w_out": Param((din, d)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``.  ``F.softplus`` returns x itself above its
    threshold of 20, which differs from this by < 3e-9 relative."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs ``(a, b)`` under the
    combine ``(a1, b1), (a2, b2) -> (a1 * a2, a2 * b1 + b2)``, by the
    odd/even recursion of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan those, then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_odd, b_odd = _associative_scan(a[:, 0:-1:2] * a[:, 1::2],
                                     a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    m = (n - 1) // 2                 # odd prefixes followed by an element
    a_next, b_next = a[:, 2::2], b[:, 2::2]
    a_even = a_odd[:, :m] * a_next
    b_even = a_next * b_odd[:, :m] + b_next
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    for out, first, odd, even in ((out_a, a, a_odd, a_even),
                                  (out_b, b, b_odd, b_even)):
        out[:, 0] = first[:, 0]
        out[:, 1::2] = odd
        out[:, 2::2] = even
    return out_a, out_b


def _scan_chunk(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """Associative scan within one chunk.  a, bx: (B, C, Din, S); h0:
    (B, Din, S).  Returns (h (B, C, Din, S), h[:, -1])."""
    a_cum, h_local = _associative_scan(a, bx)
    h = h_local + a_cum * h0[:, None]
    return h, h[:, -1]


def _one_chunk(a: torch.Tensor, h0: torch.Tensor, dt_c: torch.Tensor,
               x_c: torch.Tensor, b_c: torch.Tensor, c_c: torch.Tensor):
    """One scan chunk (``one_chunk`` of ``repro/models/mamba.py:68``):
    (y_c (B, C, Din), h_last (B, Din, S))."""
    a_bar = torch.exp(dt_c[..., None] * a)                     # (B,C,Din,S)
    bx = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
    h, h_last = _scan_chunk(a_bar, bx, h0)
    return torch.einsum("bcds,bcs->bcd", h, c_c), h_last


def ssm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              h0: torch.Tensor | None = None):
    """Selective scan.  x: (B, L, Din) post-conv/SiLU activations.
    Returns (y (B, L, Din), h_last (B, Din, S))."""
    b, length, din = x.shape
    s = cfg.ssm_state
    x_dbl = x @ p["w_x"]
    dt, bmat, cmat = torch.split(x_dbl, [cfg.dt_rank, s, s], dim=-1)
    dt = _softplus(dt @ p["w_dt"] + p["dt_bias"])             # (B, L, Din)
    a = -torch.exp(p["a_log"].float())                         # (Din, S)
    if h0 is None:
        h0 = torch.zeros((b, din, s), dtype=torch.float32, device=x.device)
    chunk = min(cfg.scan_chunk, length)
    n_chunks = -(-length // chunk)
    pad = n_chunks * chunk - length
    if pad:       # zero steps: a_bar = 1, bx = 0 (JAX pads the same way)
        dt, xp, bmat, cmat = (F.pad(t, (0, 0, 0, pad))
                              for t in (dt, x, bmat, cmat))
    else:
        xp = x
    # under grad each chunk is rebuilt in the backward (jax.checkpoint)
    remat = torch.is_grad_enabled() and x.requires_grad
    ys = []
    for ic in range(n_chunks):
        sl = slice(ic * chunk, (ic + 1) * chunk)
        chunk_in = (a, h0) + tuple(t[:, sl].float()
                                   for t in (dt, xp, bmat, cmat))
        if remat:
            y_c, h0 = checkpoint(_one_chunk, *chunk_in, use_reentrant=False)
        else:
            y_c, h0 = _one_chunk(*chunk_in)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :length].to(x.dtype)
    y = y + x * p["d_skip"]
    return y, h0


def mixer_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state=None) -> torch.Tensor:
    """The full mamba mixer.  ``state=(conv_state, ssm_state)`` — views of
    one layer of the decode state — selects decode mode (L == 1) and is
    updated in place."""
    xz = x @ p["w_in"]
    din = xz.shape[-1] // 2
    xin, z = xz[..., :din], xz[..., din:]      # views: xin is read in place
    if state is None:
        xc = F.silu(ops.depthwise_conv1d(xin, p["conv_w"]) + p["conv_b"])
        y, _ = ssm_apply(p, xc, cfg)
    else:
        conv_state, h0 = state
        new_conv, xc = ops.depthwise_conv1d_step(conv_state, xin[:, 0],
                                                 p["conv_w"])
        xc = F.silu(xc + p["conv_b"])[:, None]
        y, h_last = ssm_apply(p, xc, cfg, h0=h0)
        conv_state.copy_(new_conv)
        h0.copy_(h_last)
    y = y * F.silu(z)
    return y @ p["w_out"]


def block_params(cfg: ModelConfig) -> dict:
    return {"ln": L.norm_params(cfg), "mixer": mixer_params(cfg)}


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state=None) -> torch.Tensor:
    """One pre-norm residual block; a decode ``state`` is updated in
    place."""
    return x + mixer_apply(p["mixer"], L.norm_apply(p["ln"], x, cfg), cfg,
                           state=state)


def lm_params(cfg: ModelConfig) -> dict:
    return {"tok": L.embedding_params(cfg),
            "blocks": stack_params(block_params(cfg), cfg.n_layers),
            "ln_f": L.norm_params(cfg)}


def make_state(cfg: ModelConfig, batch: int) -> dict:
    """Decode state of every layer (stacked, zeros): the conv window (the
    K-1 carried inputs, in the model dtype) and the SSM state, f32 in a
    model of any dtype (``repro/models/mamba.py:146``)."""
    return {
        "conv": Param((cfg.n_layers, batch, cfg.d_conv - 1, cfg.d_inner),
                      init="zeros"),
        "ssm": Param((cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state),
                     init="zeros", dtype=torch.float32),
    }


def lm_apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             state: dict | None = None):
    """tokens (B, S) -> (logits (B, S, vocab), state).  ``state`` selects
    one-token decode; each layer's slice of it is updated in place.  Under
    grad with ``cfg.remat`` each block is checkpointed."""
    x = L.embed_apply(params["tok"], tokens, cfg)
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    for i, pi in enumerate(layer_list(params["blocks"], cfg.n_layers)):
        if remat:
            x = checkpoint(block_apply, pi, x, cfg, use_reentrant=False)
        else:
            st = None if state is None else (state["conv"][i],
                                             state["ssm"][i])
            x = block_apply(pi, x, cfg, state=st)
    x = L.norm_apply(params["ln_f"], x, cfg)
    return L.head_apply(params["tok"], x, cfg), state
