"""A float64 oracle of the port's LM forward.

The port's norms, RoPE and ``ref.attention`` compute in f32 inside, as
JAX's do (``repro/models/layers.py:35-62``, ``repro/kernels/ref.py:
213``), so float64 params alone do not give a float64 forward.
:func:`float64` swaps those three for float64 versions for the length of
a ``with`` block; ``api.forward`` with ``attn_impl="ref"`` on
:func:`widen`-ed params and float64 inputs then runs in float64
throughout.  Under the JAX initialiser's peaked attention scores (|s| in
the hundreds at full width) two f32 computations of a deep stack part by
far more than an f32 rounding, so the tests and ``chip_smoke.py`` hold
each f32 path against this oracle rather than against each other.

A MoE block is float64 by itself (its router widens to at least f32),
but its routing is a discontinuous function: a token whose k-th and
(k+1)-th router probabilities nearly tie takes one expert in the run
under test and may take the other in float64.  So the oracle replays
that run's routing: :func:`routes` records each MoE layer's expert
choices (``layers.moe_top_k``'s indices) in call order, and
``float64(routes=...)`` hands them back in the same order, the gates
taken from the float64 probabilities at those experts; the dispatch,
capacity drops, combine and aux then follow from them as in the run
under test.  Replay needs one forward in the recorded order: run the
oracle without remat (a checkpointed block would route twice).
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import ref
from repro_torch.models import layers


def norm_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """``layers.norm_apply`` in float64 (LayerNorm or RMSNorm, eps
    1e-6)."""
    if cfg.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * p["scale"]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """``layers.rope`` in float64."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d // 2, dtype=torch.float64,
                             device=x.device) / (d // 2)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float64,
                                   device=x.device), exponent)
    angles = positions.double()[..., None] * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, logits_soft_cap: float | None = None,
              window: int | None = None) -> torch.Tensor:
    """``ref.attention`` in float64: GQA, queries right-aligned to the
    keys, the soft cap and window as there, one softmax."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    qg = q.reshape(b, lq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(d)
    if logits_soft_cap is not None:
        s = logits_soft_cap * torch.tanh(s / logits_soft_cap)
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, lq, hq, d)


@contextlib.contextmanager
def routes():
    """Record the expert choices of every MoE layer run inside the block:
    yields the list that ``layers.moe_top_k``'s indices (g, tg, k) are
    appended to, in call order."""
    recorded = []
    top_k = layers.moe_top_k

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        recorded.append(idx.detach().clone())
        return vals, idx
    layers.moe_top_k = recording
    try:
        yield recorded
    finally:
        layers.moe_top_k = top_k


def _replay(recorded: list):
    """A ``moe_top_k`` that returns the next recorded choices and the
    probabilities at them."""
    pending = iter(recorded)

    def replay(probs, k):
        idx = next(pending).to(probs.device)
        if idx.shape != (*probs.shape[:-1], k):
            raise ValueError(f"recorded choices {tuple(idx.shape)} do not "
                             f"fit probabilities {tuple(probs.shape)}, k "
                             f"{k}: replay in the recorded order")
        return probs.gather(-1, idx), idx
    return replay


@contextlib.contextmanager
def float64(routes: list | None = None):
    """``layers.norm_apply``, ``layers.rope`` and ``ref.attention``
    swapped for the float64 versions above inside the block; with
    ``routes`` (from :func:`routes`), ``layers.moe_top_k`` replays them."""
    saved = (layers.norm_apply, layers.rope, ref.attention,
             layers.moe_top_k)
    layers.norm_apply, layers.rope, ref.attention = norm_apply, rope, \
        attention
    if routes is not None:
        layers.moe_top_k = _replay(routes)
    try:
        yield
    finally:
        (layers.norm_apply, layers.rope, ref.attention,
         layers.moe_top_k) = saved


def widen(tree):
    """A tree of tensors as float64 (a copy)."""
    if isinstance(tree, dict):
        return {k: widen(v) for k, v in tree.items()}
    return tree.double()
