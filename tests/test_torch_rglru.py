"""The port's RecurrentGemma hybrid (recurrentgemma-2b) against the JAX
package on the CPU.

Parameters come from the JAX ``init_params`` and reach the port through
``repro_torch.convert.params_from_jax`` (the hybrid tree of per-layer
``layer_{i}`` dicts, unchanged); inputs come from a numpy seed.  Both
packages are f32 and differ in summation order only (GEMMs), so
comparisons are within 1e-5 of the reference's largest magnitude, except
where an attention softmax nearly ties at these narrow widths (head_dim
16, one KV head): there the logits are also held against a float64 run
of the port (``test_forward_at_the_test_models_config``,
``test_decode_steps_match_jax_across_the_ring_wrap``).

* ``_rg_lru`` (with and without an initial state, odd lengths that reach
  the scan recursion's tail) and ``rec_mixer_apply`` (prefill and one
  decode step);
* ``api.forward`` at recurrentgemma-2b SMOKE (``"ref"``, and
  ``"flash"``, the kernel's plain version, past its 64-key tiles); the
  temporal conv goes through the ``trim_conv1d`` wrapper once a rec
  layer; at the hybrid config of ``tests/test_models.py`` sublayer by
  sublayer, and end to end against float64 (that config's f32 function
  is ill-conditioned: see the test);
* 20 decode steps across the ring wrap (window 8): logits, every ring
  cache, conv window and LRU state at every step, updated in place; the
  port's decode against its own prefill; ``serve_batch`` tokens equal to
  JAX's;
* ``registry.count_params`` at full width without allocation, the tree
  layout, and the serving CLI on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.distributed import steps as jsteps
from repro.distributed.sharding import make_rules
from repro.launch import serve as jserve
from repro.models import ModelConfig as JModelConfig
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models.base import init_params as jinit
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.distributed import steps
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import api, layers, rglru
from repro_torch.models.base import init_params
from repro_torch.models.config import ModelConfig

ARCH = "recurrentgemma-2b"
TOL = 1e-5
F64_FACTOR = 2.0
DECODE_LOGITS_TOL = 1e-4

# tests/test_models.py's hybrid family config, in both packages
TEST_MODELS_HYBRID = dict(
    family="hybrid", n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=97, window=8, block_pattern=("rec", "rec", "att"),
    lru_width=64, mlp="geglu", attn_impl="ref", remat=False)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _models(config: str = "smoke", **kw):
    """(jax cfg, jax params as numpy, port cfg, port params)."""
    if config == "smoke":
        jcfg = jregistry.get(ARCH).SMOKE.replace(dtype="float32")
        cfg = registry.get(ARCH).SMOKE
    else:
        jcfg = JModelConfig(**TEST_MODELS_HYBRID)
        cfg = ModelConfig(**TEST_MODELS_HYBRID)
    jp = jax.tree.map(np.asarray, jinit(japi.params(jcfg),
                                        jax.random.PRNGKey(0)))
    return jcfg, jp, cfg.replace(**kw), params_from_jax(jp)


def _tokens(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _rec_params(jp, p, i=0):
    return jp["blocks"][f"layer_{i}"]["rec"], p["blocks"][f"layer_{i}"]["rec"]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 37])
def test_rg_lru_matches_jax(n, with_h0):
    rng = np.random.default_rng(n + 100 * with_h0)
    w = 12
    xb = rng.standard_normal((2, n, w)).astype(np.float32)
    r = rng.uniform(0.0, 1.0, (2, n, w)).astype(np.float32)
    i = rng.uniform(0.0, 1.0, (2, n, w)).astype(np.float32)
    lam = rng.standard_normal(w).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32) if with_h0 else None
    jh, jlast = jrglru._rg_lru(
        jnp.asarray(xb), jnp.asarray(r), jnp.asarray(i), jnp.asarray(lam),
        h0=None if h0 is None else jnp.asarray(h0))
    th = [torch.from_numpy(a) for a in (xb, r, i, lam)]
    h, last = rglru._rg_lru(*th, h0=None if h0 is None
                            else torch.from_numpy(h0))
    assert _rel_err(h, jh) <= TOL and _rel_err(last, jlast) <= TOL
    # and the plain recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t x_t
    a = np.exp(-8.0 * np.logaddexp(lam, 0.0) * r)
    ht = np.zeros((2, w), np.float64) if h0 is None else h0.astype(np.float64)
    for t in range(n):
        ht = a[:, t] * ht + np.sqrt(np.maximum(1 - a[:, t] ** 2, 1e-12)) \
            * (i[:, t] * xb[:, t])
    assert _rel_err(last, ht) <= TOL


def test_rec_mixer_prefill_matches_jax():
    jcfg, jp, cfg, p = _models()
    jrec, rec = _rec_params(jp, p)
    x = np.random.default_rng(1).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    jy, _ = jrglru.rec_mixer_apply(jrec, jnp.asarray(x), jcfg, make_rules())
    y = rglru.rec_mixer_apply(rec, torch.from_numpy(x), cfg)
    assert _rel_err(y, jy) <= TOL


def test_rec_mixer_decode_step_matches_jax_in_place():
    jcfg, jp, cfg, p = _models()
    jrec, rec = _rec_params(jp, p)
    rng = np.random.default_rng(2)
    w = cfg.lru_width
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.d_conv - 1, w)).astype(np.float32)
    h = rng.standard_normal((2, w)).astype(np.float32)
    jy, (jconv, jh) = jrglru.rec_mixer_apply(
        jrec, jnp.asarray(x), jcfg, make_rules(),
        state=(jnp.asarray(conv), jnp.asarray(h)))
    tconv, th = torch.from_numpy(conv.copy()), torch.from_numpy(h.copy())
    y = rglru.rec_mixer_apply(rec, torch.from_numpy(x), cfg,
                              state=(tconv, th))
    assert _rel_err(y, jy) <= TOL
    # the state tensors themselves now hold the new state
    assert _rel_err(tconv, jconv) <= TOL and _rel_err(th, jh) <= TOL
    np.testing.assert_array_equal(tconv[:, :-1].numpy(), conv[:, 1:])


@pytest.mark.parametrize("impl,seq", [("ref", 37), ("flash", 150)])
def test_forward_matches_jax(impl, seq, monkeypatch):
    jcfg, jp, cfg, p = _models(attn_impl=impl)
    toks = _tokens(cfg, s=seq)
    jlogits, jtok = jsteps.make_prefill_step(jcfg, make_rules())(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    calls = []
    real = ops.trim_conv1d
    monkeypatch.setattr(ops, "trim_conv1d",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    logits, tok = steps.make_prefill_step(cfg)(
        p, {"tokens": torch.from_numpy(toks)})
    assert logits.shape == (2, seq, cfg.vocab)
    assert _rel_err(logits, jlogits) <= TOL
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    # one conv through the kernel's wrapper a rec layer
    n_rec = sum(cfg.pattern_at(i) == "rec" for i in range(cfg.n_layers))
    assert calls == [(2, seq, cfg.lru_width)] * n_rec
    # the final logit soft cap
    assert float(logits.abs().max()) < cfg.logits_soft_cap


def test_forward_at_the_test_models_config(monkeypatch):
    """tests/test_models.py's hybrid config (untied head, no soft caps,
    head_dim 16 with one KV head: the JAX initialiser's ``wk`` std 1 gives
    attention scores of |s| ~ 30, where the softmax multiplies an f32
    rounding of a score by |s|).  There the JAX forward itself lies
    1.6e-5-2.6e-5 of max|logits| from a float64 forward, so the two f32
    packages are held (i) sublayer by sublayer on JAX's own activations
    at ``TOL`` and (ii) end to end against the float64 forward: the
    port's logits at most ``F64_FACTOR`` times as far from it as JAX's
    (or within ``TOL``), with the same greedy tokens."""
    jcfg, jp, cfg, p = _models("test_models")
    toks = _tokens(cfg, s=16)
    rules = make_rules()
    x = jlayers.embed_apply(jp["tok"], jnp.asarray(toks), jcfg, rules)
    pos = jnp.arange(toks.shape[1])[None]
    for i in range(cfg.n_layers):
        jpi, pi = jp["blocks"][f"layer_{i}"], p["blocks"][f"layer_{i}"]
        h = jlayers.norm_apply(jpi["ln_mix"], x, jcfg)
        th = torch.from_numpy(np.array(h))
        if cfg.pattern_at(i) == "att":
            y, _ = jlayers.attention_apply(jpi["att"], h, jcfg, rules,
                                           positions=pos, window=cfg.window)
            ty = layers.attention_apply(
                pi["att"], th, cfg, positions=torch.from_numpy(np.array(pos)),
                window=cfg.window)
        else:
            y, _ = jrglru.rec_mixer_apply(jpi["rec"], h, jcfg, rules)
            ty = rglru.rec_mixer_apply(pi["rec"], th, cfg)
        assert _rel_err(ty, y) <= TOL, i
        x = x + y
        z = jlayers.norm_apply(jpi["ln_mlp"], x, jcfg)
        m = jlayers.mlp_apply(jpi["mlp"], z, jcfg, rules)
        assert _rel_err(layers.mlp_apply(
            pi["mlp"], torch.from_numpy(np.array(z)), cfg), m) <= TOL, i
        x = x + m
    jlogits, jtok = jsteps.make_prefill_step(jcfg, rules)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    logits, tok = steps.make_prefill_step(cfg)(
        p, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    # float64: the same port function on double weights, the conv on its
    # oracle (the kernel's wrapper takes f32 only)
    monkeypatch.setattr(ops, "trim_conv1d", ref.depthwise_conv1d)
    p64 = jax.tree.map(lambda t: t.double(), p)
    l64, _ = rglru.lm_apply(p64, torch.from_numpy(toks), cfg)
    jax_err = _rel_err(jlogits, l64)
    assert jax_err <= 1e-4
    assert _rel_err(logits, l64) <= max(TOL, F64_FACTOR * jax_err)


def test_flash_plain_matches_ref_past_the_window():
    """The flash kernel's plain version (64-key tiles, tiles before the
    first query's window skipped) and the ``ref`` oracle give the same
    hybrid forward at 150 tokens on a window of 8."""
    _, _, cfg, p = _models()
    toks = torch.from_numpy(_tokens(cfg, s=150, seed=4))
    lf, _ = api.forward(p, {"tokens": toks}, cfg.replace(attn_impl="flash"))
    lr, _ = api.forward(p, {"tokens": toks}, cfg)
    assert _rel_err(lf, lr) <= TOL


def test_decode_steps_match_jax_across_the_ring_wrap():
    """Every ring cache, conv window and LRU state within ``TOL`` of JAX's
    at every step, and updated in place.  The logits within
    ``DECODE_LOGITS_TOL`` of JAX's at every step, and as close to the
    port's float64 decode as JAX's are, on the mean over the steps, within
    ``F64_FACTOR``: the att layer's window softmax of soft-capped scores
    nearly ties at some steps (p 0.45 / 0.55) and multiplies the
    residual stream's ~5e-7 f32 rounding there, so either f32 package
    reads up to 1.7e-5 of max|logits| from float64 at one step (the two
    differ by up to 2.2e-5) while a wrong ring slot or mask reads O(1)."""
    jcfg, jp, cfg, p = _models()
    b, n_steps = 2, 20
    assert cfg.window == 8 < n_steps
    toks = _tokens(cfg, b=b, s=n_steps, seed=1)
    jstate = jinit(japi.decode_state(jcfg, b, 8), jax.random.PRNGKey(0))
    jdecode = jax.jit(lambda p_, b_, s_: japi.decode(p_, b_, s_, jcfg,
                                                     make_rules()))
    state = init_params(api.decode_state(cfg, b, 8), torch.Generator())
    p64 = jax.tree.map(lambda t: t.double(), p)
    state64 = init_params(api.decode_state(cfg, b, 8), torch.Generator(),
                          dtype=torch.float64)
    leaves = {(layer, k): v for layer, st in state.items()
              for k, v in st.items()}
    f64_errs = []
    for t in range(n_steps):
        jlogits, jstate = jdecode(jp, {
            "tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32),
            "cache_len": jnp.full((b,), t + 1, jnp.int32)}, jstate)
        batch = {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                 "cache_len": torch.full((b,), t + 1, dtype=torch.int32)}
        logits, state = api.decode(p, batch, state, cfg)
        l64, state64 = api.decode(p64, batch, state64, cfg)
        assert logits.shape == (b, 1, cfg.vocab)
        assert _rel_err(logits, jlogits) <= DECODE_LOGITS_TOL, t
        f64_errs.append((_rel_err(logits, l64), _rel_err(jlogits, l64)))
        for (layer, k), v in leaves.items():
            assert state[layer][k] is v          # updated in place
            want = np.asarray(jstate[layer][k])
            if np.abs(want).max() == 0:
                np.testing.assert_array_equal(v.numpy(), want)
            else:
                assert _rel_err(v, want) <= TOL, (t, layer, k)
    port_err, jax_err = np.mean(f64_errs, axis=0)
    assert port_err <= max(TOL, F64_FACTOR * jax_err)
    # the ring holds the last `window` keys: slots in (pos - 1) % window
    ring = state["layer_2"]["k"]
    assert tuple(ring.shape) == (b, cfg.window, cfg.n_kv_heads, cfg.hd)
    assert tuple(state["layer_0"]["conv"].shape) == (
        b, cfg.d_conv - 1, cfg.lru_width)
    assert tuple(state["layer_0"]["h"].shape) == (b, cfg.lru_width)


def test_decode_matches_prefill_across_the_ring_wrap():
    """Token by token through the ring caches, conv windows and LRU states
    gives the logits of the full-sequence prefill at every position, past
    2.5 windows."""
    cfg = registry.get(ARCH).SMOKE
    p = init_params(api.params(cfg), torch.Generator().manual_seed(0))
    n = 20
    toks = torch.from_numpy(_tokens(cfg, s=n, seed=2))
    logits, _ = steps.make_prefill_step(cfg)(p, {"tokens": toks})
    state = init_params(api.decode_state(cfg, 2, n), torch.Generator())
    for t in range(n):
        step, state = api.decode(p, {
            "tokens": toks[:, t:t + 1],
            "cache_len": torch.full((2,), t + 1, dtype=torch.int32)},
            state, cfg)
        assert _rel_err(step[:, 0], logits[:, t]) <= TOL


def test_serve_batch_matches_jax():
    jcfg, jp, cfg, p = _models()
    prompts = _tokens(cfg, b=2, s=6, seed=3)
    want = jserve.serve_batch(jcfg, jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(prompts, jnp.int32), 8,
                              make_rules())
    got = serve.serve_batch(cfg, p, torch.from_numpy(prompts), 8)
    assert got.shape == (2, 6 + 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_count_params_at_full_width_without_allocation():
    cfg = registry.get(ARCH).CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.window) == (26, 2560, 10, 1, 256, 2048)
    assert cfg.attn_impl == "flash" and cfg.logits_soft_cap == 30.0
    assert registry.get(ARCH).SMOKE.attn_impl == "ref"
    assert registry.count_params(cfg) == 2_894_574_080
    assert registry.count_params(cfg) == jregistry.count_params(
        jregistry.get(ARCH).CONFIG)
    assert cfg.param_count() == jregistry.get(ARCH).CONFIG.param_count()


def test_convert_keeps_the_hybrid_tree():
    _, jp, cfg, p = _models()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n = 0
    for path, leaf in flat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), leaf)
        n += 1
    # per rec layer 10 mixer + 2 norms + 3 mlp, the att layer 4 + 2 + 3,
    # then the tied embedding and ln_f
    assert n == 2 * 15 + 9 + 2
    assert sorted(p["blocks"]) == ["layer_0", "layer_1", "layer_2"]
    assert "rec" in p["blocks"]["layer_0"] and "att" in p["blocks"]["layer_2"]
    assert sorted(p["blocks"]["layer_0"]["rec"]) == sorted(
        ["w_x", "w_gate", "conv_w", "conv_b", "w_a", "b_a", "w_i", "b_i",
         "lam", "w_out"])
    assert "head" not in p["tok"]
    # and the port declares the same tree
    decl = api.params(cfg)
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda _: 0, jp)) == jax.tree_util.tree_structure(
        jax.tree.map(lambda d: 0, decl,
                     is_leaf=lambda d: not isinstance(d, dict)))


def test_decode_state_is_a_ring_of_window_slots():
    cfg = registry.get(ARCH).CONFIG
    decl = api.decode_state(cfg, 4, 100_000)       # max_len is ignored
    assert sorted(decl, key=lambda k: int(k.split("_")[1])) == [
        f"layer_{i}" for i in range(26)]
    assert decl["layer_2"]["k"].shape == (4, 2048, 1, 256)
    assert decl["layer_0"]["conv"].shape == (4, 3, 2560)
    assert decl["layer_0"]["h"].shape == (4, 2560)
    assert sum(cfg.pattern_at(i) == "att" for i in range(26)) == 8


def test_serve_cli_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert tuple(out.shape) == (2, 7)
    assert f"arch={ARCH} generated (2, 7)" in capsys.readouterr().out
