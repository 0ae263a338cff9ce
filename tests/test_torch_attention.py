"""The port's attention against the JAX package on the CPU.

``ops.attention`` with ``impl="flash"`` (on the CPU the flash kernel's
plain version), ``"chunked"`` and ``"ref"`` against JAX ``ops.attention(
impl="pallas")`` (the Pallas kernel in interpret mode) and JAX
``ref.attention``, on ``tests/test_kernels.py``'s six cases (GQA, soft
cap, ragged Lq/Lk, non-causal, local window, Lq = 1); ``decode_attention``
against JAX's and the oracle; and a hypothesis property over shapes.
Inputs are numpy draws from a seed, handed to both packages.  Tolerance:
f32, 1e-5 of max|JAX| — the two packages sum in another order, nothing
else differs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = 1e-5
# b, lq, lk, hq, hkv, d, causal, soft_cap, window (tests/test_kernels.py)
CASES = [
    (2, 32, 32, 4, 2, 16, True, None, None),
    (1, 64, 64, 8, 8, 32, True, 30.0, None),
    (2, 17, 47, 4, 1, 16, True, None, None),
    (2, 32, 32, 4, 2, 16, False, None, None),
    (1, 64, 64, 4, 2, 16, True, None, 16),
    (2, 1, 40, 8, 2, 32, True, None, None),
]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _qkv(rng, b, lq, lk, hq, hkv, d):
    return (rng.standard_normal((b, lq, hq, d)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, d)).astype(np.float32))


@functools.cache
def _jax_case(i):
    """Inputs of case ``i`` and the JAX Pallas kernel's and oracle's
    outputs on them."""
    b, lq, lk, hq, hkv, d, causal, cap, win = CASES[i]
    q, k, v = _qkv(np.random.default_rng(i), b, lq, lk, hq, hkv, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jops.attention(jq, jk, jv, causal=causal, soft_cap=cap,
                            window=win, impl="pallas")
    oracle = jref.attention(jq, jk, jv, causal=causal, logits_soft_cap=cap,
                            window=win)
    return (q, k, v), np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("impl", ["flash", "chunked", "ref"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[str(c[:6]) for c in CASES])
def test_attention_matches_jax_pallas_and_oracle(case, impl):
    (q, k, v), pallas, oracle = _jax_case(case)
    _, _, _, _, _, _, causal, cap, win = CASES[case]
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        soft_cap=cap, window=win, impl=impl, chunk=16)
    _close(got, pallas)
    _close(got, oracle)


# D > 256: the kernel's wide-head route on the card; on the CPU its plain
# version.  b, lq, lk, hq, hkv, d, causal, window
WIDE_CASES = [(1, 40, 40, 4, 2, 320, True, None),
              (1, 40, 40, 4, 2, 320, True, 16),
              (1, 33, 70, 2, 1, 512, True, None),
              (1, 33, 70, 2, 1, 512, True, 24)]


@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=[f"d{c[5]}-w{c[7]}" for c in WIDE_CASES])
def test_flash_wide_head_matches_jax_pallas_and_chunked(case):
    """head_dim 320 and 512: the port's flash takes them as JAX's Pallas
    kernel does, and matches it and JAX ``chunked``."""
    b, lq, lk, hq, hkv, d, causal, win = case
    q, k, v = _qkv(np.random.default_rng(d + lk), b, lq, lk, hq, hkv, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jops.attention(jq, jk, jv, causal=causal, window=win,
                            impl="pallas")
    chunked = jops.attention(jq, jk, jv, causal=causal, window=win,
                             impl="chunked", chunk=16)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=win, impl="flash")
    _close(got, pallas)
    _close(got, chunked)


def test_flash_plain_version_is_the_wrapper_on_cpu():
    (q, k, v), _, _ = _jax_case(2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert torch.equal(fa.flash_attention(tq, tk, tv),
                       fa.flash_attention_plain(tq, tk, tv))


@pytest.mark.parametrize("cap,win", [(None, None), (20.0, 5)])
def test_decode_attention_matches_jax(cap, win):
    b, lmax, hq, hkv, d, clen = 2, 24, 4, 2, 16, 17
    rng = np.random.default_rng(3)
    q, kc, vc = _qkv(rng, b, 1, lmax, hq, hkv, d)
    got = ops.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                               torch.full((b,), clen), soft_cap=cap,
                               window=win)
    want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                 jnp.full((b,), clen), soft_cap=cap,
                                 window=win)
    _close(got, want)
    if win is None:    # the dense oracle over the valid prefix
        oracle = jref.attention(*map(jnp.asarray, (q, kc[:, :clen],
                                                   vc[:, :clen])),
                                causal=True, logits_soft_cap=cap)
        _close(got, oracle)


def test_decode_attention_per_row_cache_lengths():
    """Rows with different ``cache_len`` each see their own prefix."""
    b, lmax, hq, hkv, d = 3, 20, 4, 1, 8
    q, kc, vc = map(torch.from_numpy, _qkv(np.random.default_rng(4), b, 1,
                                           lmax, hq, hkv, d))
    lens = [5, 20, 11]
    got = ops.decode_attention(q, kc, vc, torch.tensor(lens))
    for i, n in enumerate(lens):
        want = ref.attention(q[i:i + 1], kc[i:i + 1, :n], vc[i:i + 1, :n])
        _close(got[i:i + 1], want)


def test_unknown_impl_raises():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, q, q, impl="pallas")


@settings(max_examples=10, deadline=None)
@given(lq=st.integers(1, 40), lk_extra=st.integers(0, 40),
       hkv=st.sampled_from([1, 2, 4]), group=st.sampled_from([1, 2, 3]),
       causal=st.booleans(), block_k=st.sampled_from([8, 64]))
def test_attention_property(lq, lk_extra, hkv, group, causal, block_k):
    lk, b, d = lq + lk_extra, 1, 8
    hq = hkv * group
    q, k, v = _qkv(np.random.default_rng(lq * 100 + lk), b, lq, lk, hq,
                   hkv, d)
    want = jref.attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, block_k=block_k)
    _close(got, want)


# ---------------------------------------------------------------------------
# The narrow kernel's 3xTF32 products, emulated in plain PyTorch
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _einsum_3xtf32(eq, a, b):
    """``a_small b_big + a_big b_small + a_big b_big``, each operand split
    as the kernel splits it (big = tf32(a), small = tf32(a - big)), the
    TF32 products exact and summed in f32."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
            + torch.einsum(eq, ab, bb))


def _einsum_tf32(eq, a, b):
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _flash_emulated(q, k, v, causal, cap, win, einsum, block_k=64):
    """``flash_attention_plain``'s tiles, mask and online softmax, with
    both products (Q K^T and P V) through ``einsum``."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, lq, hkv, group, d).permute(0, 2, 3, 1, 4)
    q_pos = torch.arange(lq) + lk - lq
    m = torch.full((b, hkv, group, lq, 1), fa.NEG_INF)
    l = torch.zeros((b, hkv, group, lq, 1))
    acc = torch.zeros((b, hkv, group, lq, d))
    for k0 in range(0, lk, block_k):
        kc, vc = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = einsum("bhgqd,bchd->bhgqc", qg, kc) * (1.0 / np.sqrt(d))
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        k_pos = torch.arange(k0, k0 + kc.shape[1])
        mask = torch.ones((lq, kc.shape[1]), dtype=torch.bool)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if win is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < win
        s = torch.where(mask, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + einsum("bhgqc,bchd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12,
                      -(1.0 + 2**-11), 3.0e-5], dtype=torch.float32)
    got = _tf32(x)
    assert got[0] == 1.0 + 2**-10                 # representable
    assert got[1] == 1.0 + 2**-10                 # tie: away from zero
    assert got[2] == 1.0 + 2**-10                 # below half: down
    assert got[3] == -(1.0 + 2**-10)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    big = _tf32(x)
    small = _tf32(x - big)
    assert ((big + small - x).abs() <= x.abs() * 2**-21).all()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[str(c[:6]) for c in CASES])
def test_flash_3xtf32_matches_jax_pallas_and_oracle(case):
    """Flash built from 3xTF32 products (the narrow kernel's arithmetic on
    the card) stays within 1e-5 of JAX's Pallas kernel (interpret mode)
    and of JAX ``ref.attention`` on the six shapes of
    ``tests/test_kernels.py``."""
    (q, k, v), pallas, oracle = _jax_case(case)
    _, _, _, _, _, _, causal, cap, win = CASES[case]
    got = _flash_emulated(*map(torch.from_numpy, (q, k, v)), causal, cap,
                          win, _einsum_3xtf32)
    _close(got, pallas)
    _close(got, oracle)


# b, lq, lk, hq, hkv, d, causal, soft_cap, window: the narrow route's
# padded head dims 64, 128 and 256 with ragged Lq / Lk, a window and a cap
WIDE_D_CASES = [(1, 40, 70, 4, 2, 64, True, None, None),
                (1, 33, 100, 4, 1, 128, True, 30.0, 24),
                (1, 20, 45, 2, 1, 256, False, None, None)]


@pytest.mark.parametrize("case", WIDE_D_CASES,
                         ids=[f"d{c[5]}" for c in WIDE_D_CASES])
def test_flash_3xtf32_needs_the_split(case):
    """At D = 64-256 the 3xTF32 products stay within 1e-5 of JAX
    ``ref.attention``; one TF32 pass (2^-11 a product) does not."""
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    q, k, v = _qkv(np.random.default_rng(d), b, lq, lk, hq, hkv, d)
    want = jref.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                          logits_soft_cap=cap, window=win)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(_flash_emulated(tq, tk, tv, causal, cap, win, _einsum_3xtf32),
           want)
    one = _flash_emulated(tq, tk, tv, causal, cap, win, _einsum_tf32)
    want = np.asarray(want)
    assert np.abs(one.numpy() - want).max() > TOL * np.abs(want).max()
