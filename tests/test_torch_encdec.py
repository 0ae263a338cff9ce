"""The port's encoder-decoder family against the JAX package on the CPU.

Two configs: seamless-m4t-large-v2's SMOKE and ``tests/test_models.py``'s
encdec config (``n_frontend_tokens`` 12: a decode state with 12 static
cross entries).  Parameters and train states come from JAX's
``init_params`` through ``convert.params_from_jax`` /
``train_state_from_jax``; tokens, labels and the ``src`` frames from
numpy seeds, handed to both packages.  The source is longer than the
target at SMOKE (20 frames against 16 tokens) and shorter at the other
config (12), so the cross-attention runs Lq < Lk and Lq > Lk.  On the CPU
the port's ``"flash"`` runs the kernel's plain version (forward and
backward); JAX's ``"pallas"`` runs its Pallas kernel in interpret mode.

Tolerances, and why:

* ``TOL_FWD`` = 1e-4 of max|logits| for the f32 prefill, same
  implementation on both sides.  The dense LM tests hold 1e-5, but these
  stacks are worse conditioned: the JAX initialiser's fan-in gives
  attention scores of std ~16 in all three attention kinds, and JAX's own
  f32 paths (pallas, chunked, ref) lie up to ~6.5e-5 of max|logits| from
  the float64 oracle below (``test_jax_f32_paths_part_from_float64``).
  The port is also held against that oracle: within ``F64_FACTOR`` (2x)
  of the farthest JAX f32 path's distance.
* The float64 oracle: the port's own functions in float64 throughout,
  with its norms, RoPE and ``ref.attention`` (which keep f32 inside, as
  JAX's do) swapped for float64 versions
  (``repro_torch.testing.float64``).
* Training, f32: one ulp of the params moves JAX's own f32 gradient by
  ~7e-4 (SMOKE) to ~1.6e-3 (the other config) of a leaf's max
  (``test_gradient_is_conditioned_at_one_ulp``), against 5e-5 at the
  dense LM's SMOKE.  So the gradient is held against the float64 oracle
  (within ``F64_FACTOR`` x JAX's f32 ref / chunked gradients' distance
  from it, and within ``TOL_GRAD`` = 2e-3), and a step's mu and nu within
  ``TOL_GRAD`` of each leaf's max|JAX|; the loss within 1e-5 and the
  grad norm within ``TOL_GNORM`` = 1e-3.  Two steps, each from the same
  state on both sides (step 2 from JAX's step-1 state): step 1's params
  by ``tests/test_torch_train_lm.py``'s first-step rule at ``TOL_GRAD``,
  step 2's by its generalisation (``_check_step``).
* Decode: tokens exactly equal over 8 steps, every KV cache within 1e-5
  of max|cache| (the decoder's self caches; its cross output over JAX's
  zero cross caches is exactly 0 on both sides); ``serve_batch``: the
  same tokens.
* The encoder alone (``impl="flash"`` against JAX's Pallas kernel) and
  one cross-attention sublayer (Lq < Lk, Lq > Lk): within 1e-5 of
  max|out|, their inputs being unit-normal rather than the outputs of a
  peaked stack.
* bf16: prefill logits within 3e-2 of max|logits| of JAX's bf16 run or,
  where JAX's own bf16 run lies farther from its f32 run on the same
  weights, ``F32_FACTOR`` x that distance; next tokens equal where JAX's
  top-2 margin exceeds twice the limit (``tests/test_torch_lm_bf16.py``).
  One bf16 train step against JAX's (``"chunked"``, the path JAX trains
  through) by ``tests/test_torch_bf16_lm_train.py``'s per-leaf rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch as jmake_batch
from repro.distributed import steps as jsteps
from repro.distributed.sharding import make_rules
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.base import init_params as jinit
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.distributed import steps
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve, train
from repro_torch.models import api, layers, transformer
from repro_torch.models.base import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.testing import float64
from test_torch_bf16_lm_train import (CAP, F32_FACTOR, _jax_leaves, _leaves,
                                      _port_leaves, _print_rows, _rows)
from test_torch_bf16_lm_train import TOL as TOL_BF16
from test_torch_lm_bf16 import _same_tokens
from test_torch_train_lm import TOL, _leaf_errs

ARCH = "seamless-m4t-large-v2"
# tests/test_models.py's encdec config, the same fields in both packages
MODELS = dict(family="encdec", n_layers=4, enc_layers=2, dec_layers=2,
              d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=97,
              norm="layernorm", mlp="gelu", attn_impl="ref",
              n_frontend_tokens=12, remat=False)
CONFIGS = ["smoke", "models"]
SRC_LEN = {"smoke": 20, "models": 12}    # frames; the target has 16 tokens
TGT_LEN = 16
JAX_IMPL = {"flash": "pallas", "chunked": "chunked", "ref": "ref"}
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=50)
TOL_FWD = 1e-4
TOL_GRAD = 2e-3
TOL_GNORM = 1e-3
F64_FACTOR = 2.0
DEPTH = 1           # the bf16 cut: 1 encoder + 1 decoder layer


def _cfgs(which, impl="ref"):
    """(JAX cfg, port cfg) of a config, f32, on ``impl``."""
    if which == "smoke":
        jcfg, cfg = jregistry.get(ARCH).SMOKE, registry.get(ARCH).SMOKE
    else:
        jcfg, cfg = JModelConfig(**MODELS), ModelConfig(**MODELS)
    return (jcfg.replace(dtype="float32", attn_impl=JAX_IMPL[impl]),
            cfg.replace(attn_impl=impl))


@functools.lru_cache(maxsize=None)
def _jax_params(which, dtype="float32"):
    jcfg, _ = _cfgs(which)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jax.tree.map(np.asarray, jinit(japi.params(jcfg),
                                          jax.random.PRNGKey(0), dt))


def _inputs(which, b=2, seed=0):
    """(tokens, src) numpy: TGT_LEN tokens, SRC_LEN[which] unit-normal
    frames."""
    _, cfg = _cfgs(which)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, TGT_LEN)),
            rng.standard_normal((b, SRC_LEN[which], cfg.d_model))
            .astype(np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_prefill(jcfg, jp, tokens, src, dtype=jnp.float32):
    logits, tok = jsteps.make_prefill_step(jcfg, make_rules())(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32),
             "src": jnp.asarray(src, dtype)})
    return np.asarray(jnp.asarray(logits, jnp.float32)), np.asarray(tok)


def _port_batch(tokens, src, dtype=torch.float32):
    return {"tokens": torch.from_numpy(tokens),
            "src": torch.from_numpy(src).to(dtype)}


# ---------------------------------------------------------------------------
# The float64 oracle (repro_torch.testing.float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_logits(which, impl):
    """JAX's f32 prefill (logits, next tokens) of ``_inputs(which)``."""
    return _jax_prefill(_cfgs(which, impl)[0], _jax_params(which),
                        *_inputs(which))


@functools.lru_cache(maxsize=None)
def _oracle_logits(which):
    """The float64 oracle's logits of ``_inputs(which)``."""
    tokens, src = _inputs(which)
    _, cfg = _cfgs(which, "ref")
    with float64.float64(), torch.no_grad():
        logits, _ = api.forward(
            float64.widen(params_from_jax(_jax_params(which))),
            {"tokens": torch.from_numpy(tokens),
             "src": torch.from_numpy(src).double()}, cfg)
    return logits.numpy()


def _loss64(logits, labels):
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, labels[..., None].long())[..., 0].mean()


# ---------------------------------------------------------------------------
# Prefill and the sublayers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", CONFIGS)
def test_jax_f32_paths_part_from_float64(which):
    """Why TOL_FWD: JAX's own f32 prefills lie more than the dense LM's
    1e-5 and less than TOL_FWD from the float64 oracle."""
    want = _oracle_logits(which)
    dist = [_rel(_jax_logits(which, impl)[0], want) for impl in JAX_IMPL]
    assert 1e-5 < max(dist) < TOL_FWD, dist


@pytest.mark.parametrize("impl", list(JAX_IMPL))
@pytest.mark.parametrize("which", CONFIGS)
def test_prefill_matches_jax(which, impl):
    jcfg, cfg = _cfgs(which, impl)
    tokens, src = _inputs(which)
    jlogits, jtok = _jax_logits(which, impl)
    fa.reset_launch_counts()
    logits, tok = steps.make_prefill_step(cfg)(
        params_from_jax(_jax_params(which)), _port_batch(tokens, src))
    assert logits.shape == (2, TGT_LEN, cfg.vocab)
    assert _rel(logits, jlogits) <= TOL_FWD
    np.testing.assert_array_equal(tok.numpy(), jtok)
    want = _oracle_logits(which)
    jax_worst = max(_rel(_jax_logits(which, i)[0], want) for i in JAX_IMPL)
    assert _rel(logits, want) <= F64_FACTOR * jax_worst
    # the CPU runs the plain versions: no kernel launch is counted
    assert set(fa.LAUNCHES.values()) == {0}


def test_encoder_matches_jax_flash_kernel():
    """The encoder alone (24 non-causal blocks at full depth; SMOKE's 2),
    RoPE over the source positions, then ``enc_ln``: the port's flash
    route against JAX's Pallas kernel in interpret mode."""
    jcfg, cfg = _cfgs("smoke", "flash")
    jp = _jax_params("smoke")
    _, src = _inputs("smoke")
    jenc, _, _, _ = jtransformer._run_blocks(
        jp["enc_blocks"], jnp.asarray(src), jcfg, make_rules(),
        positions=jnp.arange(src.shape[1])[None], caches=None,
        cache_len=None, causal=False, n_layers=jcfg.enc_layers)
    jenc = jlayers.norm_apply(jp["enc_ln"], jenc, jcfg)
    p = params_from_jax(jp)
    with torch.no_grad():
        enc, aux = transformer._run_blocks(
            p["enc_blocks"], torch.from_numpy(src), cfg,
            positions=torch.arange(src.shape[1])[None],
            n_layers=cfg.enc_layers, causal=False)
        enc = layers.norm_apply(p["enc_ln"], enc, cfg)
    assert _rel(enc, jenc) <= TOL and aux == 0.0
    # a causal encoder is another function
    with torch.no_grad():
        causal, _ = transformer._run_blocks(
            p["enc_blocks"], torch.from_numpy(src), cfg,
            positions=torch.arange(src.shape[1])[None],
            n_layers=cfg.enc_layers, causal=True)
    assert _rel(layers.norm_apply(p["enc_ln"], causal, cfg), jenc) > 1e-2


@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("lq,lk", [(9, 23), (23, 9)])
def test_cross_attention_sublayer_matches_jax(lq, lk, impl):
    """One decoder block's cross-attention on unit-normal x (Lq rows) and
    encoder output (Lk rows): no RoPE, non-causal, k and v from the
    encoder output."""
    jcfg, cfg = _cfgs("smoke", impl)
    jp = jax.tree.map(lambda a: a[0], _jax_params("smoke")["dec_blocks"])
    rng = np.random.default_rng(lq)
    x = rng.standard_normal((2, lq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, lk, cfg.d_model)).astype(np.float32)
    want, _ = jlayers.attention_apply(
        jp["cross"], jnp.asarray(x), jcfg, make_rules(),
        encoder_out=jnp.asarray(enc), is_cross=True, causal=False,
        use_rope=False)
    with torch.no_grad():
        got = layers.attention_apply(
            params_from_jax(jp)["cross"], torch.from_numpy(x), cfg,
            encoder_out=torch.from_numpy(enc), is_cross=True, causal=False,
            use_rope=False)
    assert got.shape == (2, lq, cfg.d_model)
    assert _rel(got, want) <= TOL


def test_decode_cross_attention_over_zero_caches_is_zero():
    """Decode's cross-attention reads the static cache (no projection, no
    write): over JAX's zero cross caches its output is exactly 0, as
    JAX's is."""
    jcfg, cfg = _cfgs("models")
    jp = jax.tree.map(lambda a: a[0], _jax_params("models")["dec_blocks"])
    x = np.random.default_rng(1).standard_normal((2, 1, 64)).astype(
        np.float32)
    kc = np.zeros((2, 12, 4, 16), np.float32)
    want, (jk, _) = jlayers.attention_apply(
        jp["cross"], jnp.asarray(x), jcfg, make_rules(),
        kv_cache=(jnp.asarray(kc), jnp.asarray(kc)), is_cross=True,
        causal=False, use_rope=False)
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy()))
    with torch.no_grad():
        got = layers.attention_apply(
            params_from_jax(jp)["cross"], torch.from_numpy(x), cfg,
            kv_cache=cache, is_cross=True, causal=False, use_rope=False)
    assert not np.asarray(want).any() and not got.any()
    assert not cache[0].any() and not cache[1].any()


# ---------------------------------------------------------------------------
# Decode and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", CONFIGS)
def test_decode_steps_match_jax(which):
    jcfg, cfg = _cfgs(which)
    jp = _jax_params(which)
    b, max_len, n_steps = 2, 10, 8
    toks = _inputs(which, seed=1)[0][:, :n_steps]
    jstate = jinit(japi.decode_state(jcfg, b, max_len),
                   jax.random.PRNGKey(0))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, make_rules()))
    p = params_from_jax(jp)
    state = init_params(api.decode_state(cfg, b, max_len), torch.Generator())
    assert sorted(state) == ["caches", "cross"]
    assert state["cross"]["k"].shape == (cfg.dec_layers, b,
                                         cfg.n_frontend_tokens or 1,
                                         cfg.n_kv_heads, cfg.hd)
    decode = steps.make_decode_step(cfg)
    for t in range(n_steps):
        jnxt, jstate = jdecode(jp, jstate, {
            "tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32),
            "cache_len": jnp.full((b,), t + 1, jnp.int32)})
        nxt, state = decode(p, state, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "cache_len": torch.full((b,), t + 1, dtype=torch.int32)})
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        for key in ("k", "v"):
            assert _rel(state["caches"][key], jstate["caches"][key]) <= TOL
            assert not state["cross"][key].any()
            assert not np.asarray(jstate["cross"][key]).any()


@pytest.mark.parametrize("which", CONFIGS)
def test_serve_batch_matches_jax(which):
    jcfg, cfg = _cfgs(which)
    jp = _jax_params(which)
    prompts = _inputs(which, seed=3)[0][:, :6]
    want = jserve.serve_batch(jcfg, jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(prompts, jnp.int32), 8,
                              make_rules())
    got = serve.serve_batch(cfg, params_from_jax(jp),
                            torch.from_numpy(prompts), 8)
    assert got.shape == (2, 6 + 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Training, f32
# ---------------------------------------------------------------------------

def _train_batch(which, seed=0, step=0):
    """JAX make_batch's copy task (4 x 16 tokens and labels) and 4
    unit-normal source sequences."""
    _, cfg = _cfgs(which)
    batch = jmake_batch(JDataConfig(batch=4, seq=TGT_LEN + 1,
                                    vocab=cfg.vocab, task="copy",
                                    seed=seed), step)
    batch["src"] = np.random.default_rng(100 + step).standard_normal(
        (4, SRC_LEN[which], cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_state(which):
    jcfg, _ = _cfgs(which)
    return jax.tree.map(np.asarray, jinit(
        jsteps.train_state_decl(jcfg, JAdamWConfig(**OPT)),
        jax.random.PRNGKey(0), jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_grads(which, impl, moved=False):
    """JAX's f32 gradient of the loss at the train state's params (moved
    by one ulp where ``moved``: ``_moved_by_one_ulp``) on
    ``_train_batch(which)``, each leaf float64."""
    jcfg, _ = _cfgs(which, impl)
    params = _jax_state(which)["params"]
    if moved:
        params = _moved_by_one_ulp(params)
    jb = {k: jnp.asarray(v) for k, v in _train_batch(which).items()}

    def loss(p):
        logits, aux = japi.forward(p, jb, jcfg, make_rules())
        return japi.loss_fn(logits, jb["labels"], aux)
    return [np.asarray(g, np.float64) for g in jax.tree.leaves(
        jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params)))]


def _oracle_grads(which, batch):
    _, cfg = _cfgs(which, "ref")
    params = float64.widen(train_state_from_jax(_jax_state(which))["params"])
    live = [t.requires_grad_() for t in adamw.tree_leaves(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["src"] = tb["src"].double()
    with float64.float64():
        logits, _ = api.forward(adamw.tree_unflatten(params, live), tb, cfg)
        grads = torch.autograd.grad(_loss64(logits, tb["labels"]), live)
    return [g.numpy() for g in grads]


def _moved_by_one_ulp(params, seed=1):
    """Each element times 1 +- 2^-23 (one ulp), the signs from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a * (1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], a.shape))).astype(np.float32), params)


@pytest.mark.parametrize("which", CONFIGS)
def test_gradient_against_float64(which):
    """The port's gradient (flash, remat) per leaf against the float64
    oracle: within TOL_GRAD, and within F64_FACTOR x the farthest JAX f32
    gradient (ref or chunked) from it, JAX's taken at these params and at
    params one ulp away (no f32 computation of so conditioned a function
    is expected closer than one ulp of its inputs moves it)."""
    _, cfg = _cfgs(which, "flash")
    batch = _train_batch(which)
    params = train_state_from_jax(_jax_state(which))["params"]
    live = [t.requires_grad_() for t in adamw.tree_leaves(params)]
    logits, aux = api.forward(adamw.tree_unflatten(params, live),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              cfg.replace(remat=True))
    grads = torch.autograd.grad(
        api.loss_fn(logits, torch.from_numpy(batch["labels"]), aux), live)
    want = _oracle_grads(which, batch)
    port = max(_leaf_errs([g.numpy().astype(np.float64) for g in grads],
                          want))
    jax32 = max(max(_leaf_errs(_jax_grads(which, impl, moved), want))
                for impl in ("ref", "chunked") for moved in (False, True))
    assert port <= TOL_GRAD, port
    assert port <= F64_FACTOR * jax32, (port, jax32)


@pytest.mark.parametrize("which", CONFIGS)
def test_gradient_is_conditioned_at_one_ulp(which):
    """Why TOL_GRAD: JAX's own f32 gradient, at params moved by one ulp,
    moves by more than the dense LM tests' 5e-5 of some leaf's max, and
    by less than TOL_GRAD."""
    spread = max(_leaf_errs(_jax_grads(which, "ref", True),
                            _jax_grads(which, "ref")))
    assert 5e-5 < spread < TOL_GRAD, spread


def _adam_ratio_slope(mu0, mu, nu, opt, t):
    """|d r / d g| of AdamW's ratio r = m_hat / (sqrt(v_hat) + eps) at step
    ``t`` (1-based) in the step's gradient g = (mu - b1 mu0) / (1 - b1),
    and g (float64)."""
    g = (mu - opt.b1 * mu0) / (1 - opt.b1)
    mh = mu / (1 - opt.b1 ** t)
    sv = np.sqrt(nu / (1 - opt.b2 ** t))
    dm = (1 - opt.b1) / (1 - opt.b1 ** t)
    dsv = np.where(sv > 0, (1 - opt.b2) * g / ((1 - opt.b2 ** t)
                                               * np.maximum(sv, 1e-300)), 0)
    return np.abs(dm / (sv + opt.eps) - mh * dsv / (sv + opt.eps) ** 2), g


def _check_step(old, new, jnew, jmu0, jmu, jnu, mu, nu, opt, lr, t,
                tol_step):
    """Each param after AdamW step ``t`` from the same state on both
    sides, the generalisation of the first-step rule: a gradient error of
    ``tol_step`` x max|g| moves the ratio r by at most |dr/dg| of it (to
    first order), so where ``lr`` times that is below TOL of the leaf's
    max|JAX change| the param is held to TOL of it plus an ulp; elsewhere
    it is held to its own moments: ``lr`` |r_port - r_JAX| (the moments'
    difference, which the caller bounds) plus the f32 roundings of the
    update on both sides (2^-21 of each r, four ulps of the largest value
    the update rounds)."""
    for i, (p0, got, want, m0, m, v, pm, pv) in enumerate(zip(
            old, new, jnew, jmu0, jmu, jnu, mu, nu)):
        p0, got, want = (np.asarray(a, np.float64) for a in (p0, got, want))
        slope, g = _adam_ratio_slope(*(np.asarray(a, np.float64)
                                       for a in (m0, m, v)), opt, t)
        err = np.abs(got - want)
        # an ulp of the largest f32 value the update rounds: p0, lr r, p
        ulp = np.spacing(np.maximum.reduce([
            np.abs(p0), np.abs(got), np.abs(want),
            np.full_like(p0, lr)]).astype(np.float32)).astype(np.float64)
        scale = np.abs(want - p0).max()
        settled = lr * slope * tol_step * np.abs(g).max() <= TOL * scale
        assert np.all((err - ulp)[settled] <= TOL * scale), (
            i, float((err - ulp)[settled].max() / scale))
        r = [np.asarray(mm, np.float64) / (1 - opt.b1 ** t)
             / (np.sqrt(np.asarray(vv, np.float64) / (1 - opt.b2 ** t))
                + opt.eps) for mm, vv in ((pm, pv), (m, v))]
        bound = lr * (np.abs(r[0] - r[1]) + 2.0 ** -21 * (
            np.abs(r[0]) + np.abs(r[1]))) + 4 * ulp
        assert np.all(err[~settled] <= bound[~settled]), i


def _trees(state):
    """{"params", "mu", "nu"}: the leaves in sorted-key order as numpy, of
    a port state (tensors) or a JAX one (numpy)."""
    def leaves(tree):
        return [t.detach().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t) for t in adamw.tree_leaves(tree)]
    return {"params": leaves(state["params"]),
            "mu": leaves(state["opt"]["mu"]),
            "nu": leaves(state["opt"]["nu"])}


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("which", CONFIGS)
def test_two_train_steps_match_jax(which, n_micro):
    """Two AdamW steps of ``make_train_step`` (flash, remat; the batch's
    ``src`` split into the micro-batches with tokens and labels), each
    from the same state as JAX's jitted step on ``"ref"`` (step 2 from
    JAX's step-1 state): loss, grad norm, mu and nu, and the params by
    the first-step rule, then ``_check_step``."""
    jcfg, cfg = _cfgs(which, "ref")
    opt = AdamWConfig(**OPT)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                           make_rules(), n_micro))
    pstep = steps.make_train_step(cfg.replace(attn_impl="flash",
                                              remat=True), opt,
                                  n_micro=n_micro)
    jstate = _jax_state(which)
    for t in (1, 2):
        batch = _train_batch(which, step=t - 1)
        jnew, jmet = jstep(jax.tree.map(jnp.asarray, jstate),
                           {k: jnp.asarray(v) for k, v in batch.items()})
        jnew = jax.tree.map(np.asarray, jnew)
        state, met = pstep(train_state_from_jax(jstate),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
        assert int(state["step"]) == int(jnew["step"]) == t
        assert _rel(met["loss"], jmet["loss"]) <= TOL
        assert _rel(met["grad_norm"], jmet["grad_norm"]) <= TOL_GNORM
        assert _rel(met["lr"], jmet["lr"]) <= TOL
        got, want, old = _trees(state), _trees(jnew), _trees(jstate)
        for name in ("mu", "nu"):
            errs = _leaf_errs(got[name], want[name])
            assert max(errs) <= TOL_GRAD, (t, name, max(errs))
        _check_step(old["params"], got["params"], want["params"],
                    old["mu"], want["mu"], want["nu"], got["mu"], got["nu"],
                    opt, float(jmet["lr"]), t, TOL_GRAD)
        jstate = jnew


@pytest.mark.parametrize("which", CONFIGS)
def test_remat_on_and_off_are_bitwise_equal(which):
    """Both stacks checkpointed per block (the encoder output an input of
    every decoder block's checkpoint) give the step without remat bit for
    bit."""
    _, cfg = _cfgs(which, "flash")
    out = {}
    for remat in (False, True):
        state, met = steps.make_train_step(
            cfg.replace(remat=remat), AdamWConfig(**OPT))(
            train_state_from_jax(_jax_state(which)),
            {k: torch.from_numpy(v) for k, v in _train_batch(which).items()})
        out[remat] = (adamw.tree_leaves(state), met)
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[False][1]["loss"], out[True][1]["loss"])


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def _cut(cfg, depth):
    """A config cut to ``depth`` encoder and ``depth`` decoder layers
    (None: as it is)."""
    return cfg if depth is None else cfg.replace(
        enc_layers=depth, dec_layers=depth, n_layers=2 * depth)


def _bf16_cut(which, impl, depth):
    """(JAX bf16 cfg, port bf16 cfg, JAX bf16 params as numpy), the
    params drawn at the cut's depth."""
    jcfg, cfg = (_cut(c.replace(dtype="bfloat16"), depth)
                 for c in _cfgs(which, impl))
    jp = jax.tree.map(np.asarray, jinit(japi.params(jcfg),
                                        jax.random.PRNGKey(0), jnp.bfloat16))
    return jcfg, cfg, jp


@pytest.mark.parametrize("depth", [None, DEPTH])
@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("which", CONFIGS)
def test_bf16_prefill_matches_jax(which, impl, depth):
    """bf16 params and a bf16 ``src`` (what JAX's input_specs gives a bf16
    config): bf16 logits.  At the cut, within 3e-2 of JAX's bf16 run or
    F32_FACTOR x JAX's own distance from its f32 run on the same weights
    (capped at 1/2).  At full SMOKE depth JAX's own bf16 run reads ~0.5
    of max|logits| from that f32 run (``test_bf16_is_ill_conditioned_at_
    full_depth``): there the port is held to the f32 run within
    F32_FACTOR x JAX's distance, tokens by the f32 run's margin, as
    ``tests/test_torch_lm_bf16.py`` holds recurrentgemma-2b's prefill."""
    jcfg, cfg, jp = _bf16_cut(which, impl, depth)
    tokens, src = _inputs(which)
    src = np.asarray(jnp.asarray(src, jnp.bfloat16).astype(jnp.float32))
    jlogits, jtok = _jax_prefill(jcfg, jp, tokens, src, jnp.bfloat16)
    f32, f32_tok = _jax_prefill(
        jcfg.replace(dtype="float32"),
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tokens, src)
    logits, tok = steps.make_prefill_step(cfg)(
        params_from_jax(jp), _port_batch(tokens, src, torch.bfloat16))
    assert logits.dtype == torch.bfloat16
    own = _rel(jlogits, f32)
    if depth is None:
        limit = F32_FACTOR * max(own, TOL_BF16)
        assert _rel(logits.float(), f32) <= limit, (own, limit)
        assert _same_tokens(tok.numpy(), f32_tok, f32[:, -1], limit)
        return
    limit = max(TOL_BF16, min(F32_FACTOR * own, CAP))
    assert _rel(logits.float(), jlogits) <= limit, (own, limit)
    assert _same_tokens(tok.numpy(), jtok, jlogits[:, -1], limit)


def _bf16_x(rng, shape):
    """A unit-normal input rounded to bf16: (JAX bf16, torch bf16)."""
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, params_from_jax(np.asarray(j))


@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("kind", ["encoder", "decoder", "cross", "mlp"])
def test_bf16_sublayers_match_jax(kind, impl):
    """Each sublayer of SMOKE's first blocks in bf16 on the same bf16
    inputs as JAX's (encoder self-attention: non-causal, RoPE; decoder
    self-attention: causal; cross-attention: 23 queries onto 9 encoder
    rows; the gelu MLP) within 3e-2 of max|out|, as
    ``tests/test_torch_lm_bf16.py`` holds the LMs' sublayers."""
    jcfg, cfg, jp = _bf16_cut("smoke", impl, None)
    p = params_from_jax(jp)
    rng = np.random.default_rng(7)
    jx, x = _bf16_x(rng, (2, 23, cfg.d_model))
    stack = "enc_blocks" if kind == "encoder" else "dec_blocks"
    jb = jax.tree.map(lambda a: a[0], jp[stack])
    pb = transformer.layer_slice(p[stack], 0)
    if kind == "mlp":
        jy = jlayers.mlp_apply(jb["mlp"], jx, jcfg, make_rules())
        y = layers.mlp_apply(pb["mlp"], x, cfg)
    elif kind == "cross":
        je, e = _bf16_x(rng, (2, 9, cfg.d_model))
        jy, _ = jlayers.attention_apply(jb["cross"], jx, jcfg, make_rules(),
                                        encoder_out=je, is_cross=True,
                                        causal=False, use_rope=False)
        y = layers.attention_apply(pb["cross"], x, cfg, encoder_out=e,
                                   is_cross=True, causal=False,
                                   use_rope=False)
    else:
        causal = kind == "decoder"
        jy, _ = jlayers.attention_apply(jb["att"], jx, jcfg, make_rules(),
                                        positions=jnp.arange(23)[None],
                                        causal=causal)
        y = layers.attention_apply(pb["att"], x, cfg,
                                   positions=torch.arange(23)[None],
                                   causal=causal)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert _rel(y.float(), jnp.asarray(jy, jnp.float32)) <= TOL_BF16


@functools.lru_cache(maxsize=None)
def _bf16_steps(which, depth):
    """(bf16 train state, JAX's bf16 step, JAX's f32 step on the widened
    params and src), each step (new state, metrics) as numpy; JAX on
    "chunked"."""
    jcfg, _ = _cfgs(which, "chunked")
    jcfg = _cut(jcfg, depth)
    state = jax.tree.map(np.asarray, jinit(
        jsteps.train_state_decl(jcfg, JAdamWConfig(**OPT)),
        jax.random.PRNGKey(0), jnp.bfloat16))
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                           make_rules()))
    out = []
    for widen in (False, True):
        st = jax.tree.map(jnp.asarray, state)
        jb = {k: jnp.asarray(v) for k, v in _train_batch(which).items()}
        jb["src"] = jb["src"].astype(jnp.bfloat16)
        if widen:
            st = dict(st, params=jax.tree.map(
                lambda a: a.astype(jnp.float32), st["params"]))
            jb["src"] = jb["src"].astype(jnp.float32)
        new, met = jstep(st, jb)
        out.append((jax.tree.map(np.asarray, new),
                    {k: float(v) for k, v in met.items()}))
    return state, out[0], out[1]


def _bf16_port_step(which, depth, state):
    _, cfg = _cfgs(which, "flash")
    cfg = _cut(cfg.replace(remat=True), depth)
    tb = {k: torch.from_numpy(v) for k, v in _train_batch(which).items()}
    tb["src"] = tb["src"].to(torch.bfloat16)
    port, met = steps.make_train_step(cfg, AdamWConfig(**OPT))(
        train_state_from_jax(state), tb)
    return port, {k: float(v) for k, v in met.items()}


@pytest.mark.parametrize("which", CONFIGS)
def test_bf16_train_step_matches_jax(which):
    """One step at the depth cut on bf16 params (norm scales f32, moments
    f32) and a bf16 ``src`` against JAX's jitted bf16 step on
    ``"chunked"``, every leaf by ``tests/test_torch_bf16_lm_train.py``'s
    rule (against JAX's f32 step on the same widened params and
    ``src``), every leaf of JAX's dtype."""
    state, jax_bf16, jax_f32 = _bf16_steps(which, DEPTH)
    port, met = _bf16_port_step(which, DEPTH, state)
    for (name, _), got, want in zip(_leaves(jax_bf16[0]), _port_leaves(port),
                                    _jax_leaves(jax_bf16[0])):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32), name
    rows = _rows(port, met, jax_bf16, jax_f32)
    _print_rows(f"{ARCH} {which} bf16 step, depth {DEPTH} + {DEPTH}", rows)
    bad = [row for row in rows if not row[1] <= row[3]]
    assert not bad, bad


@pytest.mark.parametrize("which", CONFIGS)
def test_bf16_is_ill_conditioned_at_full_depth(which):
    """At full SMOKE depth one bf16 step's loss and grad norm lie within
    that rule's limits of JAX's bf16 step, every leaf finite and of JAX's
    dtype; and why its leaves are held at the cut: JAX's own bf16 step
    reads a median of more than 0.5 of a mu or nu leaf's max from its f32
    step at full depth (its bf16 prefill ~0.5 of max|logits| from the f32
    run), and under 0.5 at the cut."""
    state, jax_bf16, jax_f32 = _bf16_steps(which, None)
    port, met = _bf16_port_step(which, None, state)
    rows = _rows(port, met, jax_bf16, jax_f32)
    _print_rows(f"{ARCH} {which} bf16 step, full SMOKE depth", rows)
    assert all(row[1] <= row[3] for row in rows[:2]), rows[:2]
    for (name, _), got, want in zip(_leaves(jax_bf16[0]), _port_leaves(port),
                                    _jax_leaves(jax_bf16[0])):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32), name
        assert torch.isfinite(got).all(), name
    cut = _rows(*_bf16_port_step(which, DEPTH,
                                 _bf16_steps(which, DEPTH)[0]),
                *_bf16_steps(which, DEPTH)[1:])

    def own(rows_):
        return float(np.median([r[2] for r in rows_
                                if r[0].startswith(("mu/", "nu/"))]))
    print(f"JAX bf16 vs f32, median over mu and nu: full depth "
          f"{own(rows):.3e}, the cut {own(cut):.3e}")
    assert own(rows) > CAP > own(cut)


# ---------------------------------------------------------------------------
# Refusals, the tree, the entry points
# ---------------------------------------------------------------------------

def test_src_of_another_dtype_is_refused():
    """The encoder takes ``src`` in the params' dtype: an f32 ``src``
    with bf16 params (or bf16 with f32) raises, naming the expected
    dtype, where JAX would promote and torch's matmul would fail."""
    _, cfg = _cfgs("smoke")
    tokens, src = _inputs("smoke")
    p16 = params_from_jax(_jax_params("smoke", "bfloat16"))
    with pytest.raises(ValueError, match="torch.bfloat16"):
        api.forward(p16, _port_batch(tokens, src),
                    cfg.replace(dtype="bfloat16"))
    p32 = params_from_jax(_jax_params("smoke"))
    with pytest.raises(ValueError, match="torch.float32"):
        api.forward(p32, _port_batch(tokens, src, torch.bfloat16), cfg)


def test_convert_keeps_the_encdec_tree_and_layout():
    """``params_from_jax`` carries ``enc_blocks``, ``enc_ln``,
    ``dec_blocks.{cross, ln_cross}`` and ``dec_ln`` unchanged, and the
    port declares the same tree."""
    jp = _jax_params("smoke")
    _, cfg = _cfgs("smoke")
    p = params_from_jax(jp)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(adamw.tree_leaves(p))
    for path, leaf in flat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), leaf)
    assert sorted(p) == ["dec_blocks", "dec_ln", "enc_blocks", "enc_ln",
                         "tok"]
    assert "cross" not in p["enc_blocks"]
    assert tuple(p["dec_blocks"]["cross"]["wq"].shape) == (
        cfg.dec_layers, cfg.d_model, cfg.n_heads, cfg.hd)
    assert tuple(p["dec_blocks"]["ln_cross"]["scale"].shape) == (
        cfg.dec_layers, cfg.d_model)
    decl = init_params(api.params(cfg), torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in adamw.tree_leaves(decl)] == [
        tuple(t.shape) for t in adamw.tree_leaves(p)]
    moved = train_state_from_jax(_jax_state("smoke"))
    assert sorted(moved["opt"]["mu"]) == sorted(p)


def test_registry_runs_the_family_at_full_width():
    mod = registry.get(ARCH)
    assert mod.CONFIG.family == "encdec" and mod.CONFIG.attn_impl == "flash"
    assert (mod.SMOKE.attn_impl, mod.SMOKE.remat) == ("ref", False)
    assert registry.count_params(mod.CONFIG) == 1_632_698_368
    assert ARCH in registry.archs()
    # the MoE ids, refused here until their family was ported, resolve
    for arch in ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"):
        mod = registry.get(arch)
        assert mod.CONFIG.family == "moe" and arch in registry.archs()
        assert registry.count_params(mod.CONFIG) == jregistry.count_params(
            jregistry.get(arch).CONFIG)


def test_entry_points_refuse_encdec_as_jax_does(tmp_path):
    """``launch.serve.main`` refuses the family with JAX's message;
    ``launch.train.main`` refuses it up front, naming the missing src
    stream (JAX's trainer fails there with a KeyError)."""
    with pytest.raises(SystemExit, match="enc-dec serving"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="src"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "1", "--ckpt-dir", str(tmp_path)])
