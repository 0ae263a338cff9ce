"""The gradient of the port's flash attention on the CPU.

* A loss through ``ops.attention(impl="flash")`` differentiates: its
  gradient equals the one through ``impl="chunked"`` and ``impl="ref"``
  (plain autograd).  Before the flash path became an autograd Function it
  ran under ``torch.no_grad()`` on the CPU and returned a fresh tensor on
  the card, so no gradient reached q, k or v.
* ``flash_attention_backward_plain`` (the backward kernels' plain
  version, which the CPU path runs) against ``jax.vjp`` of JAX
  ``ops.attention`` with ``impl="chunked"`` (what the JAX package trains
  through) and ``impl="ref"``, over causal / window / soft cap / GQA
  groups 1, 2 and 7 / D 16 and 64 / Lq <= Lk, on the same numpy inputs
  and cotangent; and the forward's row log-sum-exp against the oracle's.
* the backward does not inherit an error of the forward's lse: with lse
  off by ~1e-3 (how far the forward kernel's 3xTF32 scores and the
  backward's FFMA scores part at full-width logits), the gradients move by
  ~1e-6, saturated rows and the soft cap included, since the rows'
  statistics come from the backward's own scores;
* D > 256 under grad raises ``NotImplementedError`` naming the ROADMAP
  item (no backward for the wide route).

Tolerance: 1e-5 of max|grad| (f32 in both packages; sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = 1e-5
# b, lq, lk, hq, hkv, d, causal, soft_cap, window
CASES = [
    (2, 32, 32, 4, 2, 16, True, None, None),
    (1, 40, 40, 7, 1, 64, True, None, None),
    (2, 17, 47, 4, 4, 16, True, None, None),
    (1, 64, 64, 4, 2, 16, True, None, 16),
    (1, 50, 50, 2, 1, 64, True, 5.0, 20),
    (2, 32, 32, 4, 2, 16, False, 5.0, None),
    (1, 33, 100, 14, 2, 16, True, 5.0, 25),
    (2, 1, 40, 8, 2, 64, True, None, None),
]
IDS = [str(i) for i in range(len(CASES))]


def _inputs(case, seed):
    b, lq, lk, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, lq, hq, d)).astype(np.float32)
    return q, k, v, do


def _kw(case):
    return dict(causal=case[6], soft_cap=case[7], window=case[8])


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _port_grads(impl, q, k, v, do, kw):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.attention(*leaves, impl=impl, **kw)
    return torch.autograd.grad(out, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_gradient_equals_chunked_and_ref(case):
    """The fault and its repair: autograd through impl="flash"."""
    q, k, v, do = _inputs(case, 1)
    flash = _port_grads("flash", q, k, v, do, _kw(case))
    for impl in ("chunked", "ref"):
        for got, want in zip(flash, _port_grads(impl, q, k, v, do,
                                                _kw(case))):
            _close(got, want)


@pytest.mark.parametrize("jimpl", ["chunked", "ref"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case, jimpl):
    q, k, v, do = _inputs(case, 2)
    kw = _kw(case)
    want = jax.jit(lambda a, b, c, g: jax.vjp(
        lambda x, y, z: jops.attention(x, y, z, impl=jimpl, **kw),
        a, b, c)[1](g))(*map(jnp.asarray, (q, k, v, do)))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    _, lse = fa._plain_forward(qt, kt, vt, block_k=fa.BLOCK_K, **kw)
    plain = fa.flash_attention_backward_plain(qt, kt, vt, lse, dot, **kw)
    through = _port_grads("flash", q, k, v, do, kw)
    for got, via, w in zip(plain, through, want):
        _close(got, w)
        assert torch.equal(got, via)     # the CPU path runs the plain one


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_lse_is_the_rows_logsumexp(case):
    b, lq, lk, hq, hkv, d = case[:6]
    causal, cap, win = case[6:]
    q, k, v, _ = map(torch.from_numpy, _inputs(case, 3))
    o, lse = fa._plain_forward(q, k, v, causal=causal, soft_cap=cap,
                               window=win, block_k=fa.BLOCK_K)
    assert torch.equal(o, fa.flash_attention_plain(q, k, v, **_kw(case)))
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(hq // hkv, 2)) / np.sqrt(d)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    q_pos = torch.arange(lq) + lk - lq
    mask = fa._mask(q_pos, 0, lk, causal, win)
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    _close(lse, want.numpy())


@pytest.mark.parametrize("scale, cap, win", [(1.0, None, None),
                                             (6.0, None, None),
                                             (6.0, 30.0, 20)])
def test_backward_does_not_inherit_an_lse_error(scale, cap, win):
    """q, k scaled by 6: scores of |y| ~ 100, nearly one-hot rows."""
    gen = torch.Generator().manual_seed(7)
    q = torch.randn((1, 64, 4, 64), generator=gen) * scale
    k = torch.randn((1, 64, 2, 64), generator=gen) * scale
    v = torch.randn((1, 64, 2, 64), generator=gen)
    do = torch.randn((1, 64, 4, 64), generator=gen)
    kw = dict(causal=True, soft_cap=cap, window=win)
    _, lse = fa._plain_forward(q, k, v, block_k=fa.BLOCK_K, **kw)
    exact = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
    off = lse + 1e-3 * torch.randn(lse.shape, generator=gen)
    for got, want in zip(fa.flash_attention_backward_plain(
            q, k, v, off, do, **kw), exact):
        _close(got, want.numpy())


def test_wide_heads_under_grad_raise():
    q = torch.ones((1, 8, 4, 264), requires_grad=True)
    kv = torch.ones((1, 8, 2, 264))
    with pytest.raises(NotImplementedError, match="Queue 2 C item 8"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="Queue 2 C item 8"):
        ops.attention(q, kv, kv, impl="flash")
    # without grad the wide route still runs
    with torch.no_grad():
        assert fa.flash_attention(q, kv, kv).shape == (1, 8, 4, 264)
    assert fa.flash_attention(q.detach(), kv, kv).shape == (1, 8, 4, 264)


def test_plain_autograd_counts_no_launch():
    fa.reset_launch_counts()
    q, k, v, do = _inputs(CASES[0], 4)
    _port_grads("flash", q, k, v, do, _kw(CASES[0]))
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bf16": 0}
    assert set(fa.BWD_LAUNCHES.values()) == {0}
