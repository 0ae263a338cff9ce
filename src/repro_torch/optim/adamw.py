"""AdamW on trees of tensors (the counterpart of ``repro/optim/adamw.py``).

The JAX numerics: clip by global norm with scale ``min(1, clip / (|g| +
1e-9))``, warmup + cosine learning rate, bias corrections from ``step +
1``, and decoupled weight decay only on tensors with ndim >= 2.  Trees are
nested dicts; their leaves go in sorted-key order, as ``jax.tree.leaves``
takes them, so the global norm sums in the JAX package's order.
``apply_updates`` is functional (new trees, inputs untouched);
``apply_updates_`` updates params and moments in place, the port's
counterpart of the JAX train step's state donation (``repro/distributed/
steps.py:128``, ``donate_argnums=(0,)``): it holds a few f32
temporaries of at most ``UPDATE_CHUNK`` elements (two for an f32 leaf,
up to six for a bf16 one) where the functional update holds a second
copy of params, mu and nu (at qwen2.5-3b's 3.40 B parameters ~41 GB
more), and gives bitwise the functional update's numbers (the same
operations in the same order; a bf16 leaf is updated in f32 and rounded
once).  Both run under ``torch.no_grad()``; ``step`` is a Python int or a 0-d
tensor.  The ZeRO-style sharding of the JAX moments has no counterpart
on one card.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` from ``leaves`` in sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _step_tensor(step, device) -> torch.Tensor:
    return torch.as_tensor(step, device=device).to(torch.float32)


def lr_at(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """Learning rate at ``step`` (f32, 0-d): linear warmup, then cosine
    decay to ``min_lr_ratio * lr``."""
    s = _step_tensor(step, device)
    warm = cfg.lr * (s + 1) / max(cfg.warmup_steps, 1)
    t = ((s - cfg.warmup_steps)
         / max(cfg.decay_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < cfg.warmup_steps, warm, cfg.lr * cos)


def init_moments(params, cfg: AdamWConfig) -> dict:
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=cfg.moment_dtype,
                           device=tree.device)
    return {"mu": zeros(params), "nu": zeros(params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in
    sorted-key order."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _scalars(grads, step, cfg: AdamWConfig, device):
    """(grad_norm, clip scale, lr, bc1, bc2): 0-d f32 tensors on
    ``device``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    s = _step_tensor(step, device)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=device), s + 1)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=device), s + 1)
    return gnorm, scale, lr_at(cfg, step, device), bc1, bc2


@torch.no_grad()
def apply_updates(params, grads, moments, step, cfg: AdamWConfig):
    """Returns ``(new_params, new_moments, metrics)`` with ``metrics =
    {"grad_norm", "lr"}`` (0-d tensors)."""
    flat_p = tree_leaves(params)
    gnorm, scale, lr, bc1, bc2 = _scalars(grads, step, cfg,
                                          flat_p[0].device)
    b1, b2 = cfg.b1, cfg.b2

    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(flat_p, tree_leaves(grads),
                            tree_leaves(moments["mu"]),
                            tree_leaves(moments["nu"])):
        g = g.to(torch.float32) * scale
        mu32 = b1 * mu.to(torch.float32) + (1 - b1) * g
        nu32 = b2 * nu.to(torch.float32) + (1 - b2) * g * g
        upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * upd).to(p.dtype))
        new_mu.append(mu32.to(mu.dtype))
        new_nu.append(nu32.to(nu.dtype))
    return (tree_unflatten(params, new_p),
            {"mu": tree_unflatten(params, new_mu),
             "nu": tree_unflatten(params, new_nu)},
            {"grad_norm": gnorm, "lr": lr})


# Elements of a leaf updated at a time by apply_updates_: its temporaries
# are this many f32 values each (128 MiB), whatever the leaf's size
UPDATE_CHUNK = 1 << 25


def _update_slice(p, g, mu, nu, scale, lr, bc1, bc2, cfg: AdamWConfig,
                  decay: bool) -> None:
    """One AdamW update of flat slices in place, in f32: the functional
    update's operations in its order; a slice of another dtype (a bf16
    param or gradient, a bf16 moment) is widened into an f32 temporary,
    updated there and rounded once back into the leaf."""
    f32 = torch.float32
    b1, b2 = cfg.b1, cfg.b2
    g = g.mul_(scale) if g.dtype == f32 else g.to(f32) * scale
    m32 = mu if mu.dtype == f32 else mu.to(f32)
    n32 = nu if nu.dtype == f32 else nu.to(f32)
    p32 = p if p.dtype == f32 else p.to(f32)
    t = torch.mul(g, 1 - b1)
    m32.mul_(b1).add_(t)                          # b1 mu + (1 - b1) g
    torch.mul(g, 1 - b2, out=t).mul_(g)
    n32.mul_(b2).add_(t)                          # b2 nu + (1 - b2) g g
    u = torch.div(n32, bc2).sqrt_().add_(cfg.eps)
    torch.div(m32, bc1, out=t).div_(u)            # (mu / bc1) / (...)
    if decay:   # decoupled weight decay on matrices only
        t.add_(torch.mul(p32, cfg.weight_decay, out=u))
    p32.sub_(t.mul_(lr))
    for leaf, new in ((p, p32), (mu, m32), (nu, n32)):
        if new is not leaf:
            leaf.copy_(new)                       # the one rounding


@torch.no_grad()
def apply_updates_(params, grads, moments, step, cfg: AdamWConfig) -> dict:
    """:func:`apply_updates` in place: every leaf of ``params``,
    ``moments["mu"]`` and ``moments["nu"]`` takes its new value; the
    leaves of ``grads`` (the step's own) serve as scratch.  Returns the
    metrics ``{"grad_norm", "lr"}``.  Each new value comes from the
    functional update's operations in its order (``b1 * mu`` then ``+
    (1 - b1) * g``, ...), in f32, so the two agree bit for bit.  A leaf of
    another dtype (a bf16 param or its bf16 gradient, a moment in a bf16
    ``moment_dtype``) is widened into an f32 temporary, updated there and
    rounded once back into the leaf, as ``apply_updates`` rounds
    ``new_p.to(p.dtype)``.  The update is elementwise, so each leaf goes
    in flat slices of :data:`UPDATE_CHUNK` elements: the temporaries stay
    that small (a stacked mamba leaf holds two billion elements)."""
    flat_p = tree_leaves(params)
    flat = (flat_p, tree_leaves(grads), tree_leaves(moments["mu"]),
            tree_leaves(moments["nu"]))
    if any(t.dtype not in (torch.float32, torch.bfloat16)
           for leaves in flat for t in leaves):
        raise ValueError("apply_updates_ updates float32 and bfloat16 "
                         "leaves in place; use apply_updates for others")
    gnorm, scale, lr, bc1, bc2 = _scalars(grads, step, cfg,
                                          flat_p[0].device)
    for p, g, mu, nu in zip(*flat):
        pf, mf, nf = (t.view(-1) for t in (p, mu, nu))
        gf = g.reshape(-1)
        for i in range(0, pf.numel(), UPDATE_CHUNK):
            j = i + UPDATE_CHUNK
            _update_slice(pf[i:j], gf[i:j], mf[i:j], nf[i:j], scale, lr,
                          bc1, bc2, cfg, p.dim() >= 2)
    return {"grad_norm": gnorm, "lr": lr}
