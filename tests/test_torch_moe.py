"""The port's MoE family against the JAX package on the CPU.

Three configs: qwen3-moe-30b-a3b's SMOKE (8 experts, top 2), phi3.5-moe-
42b-a6.6b's SMOKE (4 experts, top 2, LayerNorm) and
``tests/test_models.py``'s moe config (8 experts, top 2, moe_dff 96).
Parameters and train states come from JAX's ``init_params`` through
``convert.params_from_jax`` / ``train_state_from_jax``; inputs, tokens
and batches from numpy seeds, handed to both packages.  On the CPU the
port's ``"flash"`` runs the kernel's plain version (forward and
backward); JAX's ``"pallas"`` runs its Pallas kernel in interpret mode.

What the routing must match exactly.  Each token's experts (JAX's
``jax.lax.top_k``: the lower index first on ties), which choices are
kept or dropped at capacity, the buffer row of each kept choice, and
each expert's count: these are integers, so they are held equal, not
close.  JAX keeps its routing inside ``moe_apply``; the tests recompute
it with JAX's own primitives on JAX's arrays (``_jax_routing``, the
lines of ``repro/models/layers.py:696-731``) and record the port's from
the call under test (``testing.float64.routes``).

Tolerances, and why:

* ``moe_apply`` in f32: y within ``TOL`` = 1e-5 of max|y| (f32 products
  summed in another order), aux within ``TOL_AUX`` = 1e-6 of it; the
  planted tie, the forced overflow, decode's one group (``s == 1``) and
  the ``shared`` expert alike.
* ``moe_apply`` in bf16: within ``TOL_BF16`` = 3e-2 of max|y| over the
  tokens whose routing agrees with JAX's (each package rounds the router
  logits to bf16 itself, so a near tie may flip; the count is printed).
* Prefill: logits within ``TOL_FWD`` = 1e-4 of max|logits| (the
  encoder-decoder's rule: these stacks' attention is as peaked), the
  next tokens equal, aux within ``TOL_AUX``; and within ``F64_FACTOR`` x
  JAX's distance from the float64 oracle, which replays the port's
  routing (``testing.float64``).
* Decode, 8 steps: the tokens equal, every KV cache within ``TOL`` of
  max|cache|; ``serve_batch``: the same tokens.
* A train step (flash, remat; ``n_micro`` 1 and 2) against JAX's jitted
  step on ``"ref"``: loss within ``TOL``, grad norm and every leaf of mu
  within ``TOL_STEP`` = 5e-5 of the leaf's max (the dense LM tests'
  rule), nu within ``TOL_NU`` = 2 x ``TOL_STEP`` (nu is the gradient
  squared: twice its relative error), the params by
  ``tests/test_torch_encdec.py``'s ``_check_step``; remat on and off
  bitwise.  Why nu needs the factor: the port's gradient and JAX's each
  lie ~2-4e-5 of a leaf's max from the float64 oracle on the same
  routing (``test_gradient_against_float64`` holds the port within
  ``F64_FACTOR`` x JAX's farthest f32 gradient and ``TOL_STEP``), and
  their errors add: the port's nu reads up to 6.4e-5 from JAX's, mu
  4.1e-5 (phi3.5-moe SMOKE, n_micro 1).
* One bf16 step against JAX's bf16 step (``"chunked"``, what JAX trains
  through) by ``tests/test_torch_bf16_lm_train.py``'s per-leaf rule:
  within max(3e-2, 2x JAX's own bf16-vs-f32 distance on that leaf),
  every limit capped at 1/2; at a depth-1 cut (``BF16_DEPTH``), since at
  full SMOKE depth JAX's own bf16 step already reads a median of more
  than 0.2 of a mu or nu leaf's max from its f32 step (most limits sit
  at the cap there; ``test_bf16_is_ill_conditioned_at_full_depth``).
* The initialiser: every other family's f32 and bf16 init bitwise the
  old per-leaf draw; qwen3-moe-30b-a3b's full-width bf16 init (traced on
  the meta device) draws each expert leaf one layer at a time.
"""

import functools
import math

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
from repro.models.base import init_params as jinit
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.distributed import steps
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, train
from repro_torch.models import api, layers, transformer
from repro_torch.models.base import Param, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.testing import float64
from test_torch_bf16_lm_train import (_jax_leaves, _leaves, _port_leaves,
                                      _print_rows, _rows)
from test_torch_encdec import _check_step, _trees

QWEN, PHI = "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"
# tests/test_models.py's moe config, the same fields in both packages
MODELS = dict(family="moe", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, moe_dff=96, n_experts=8, top_k=2, vocab=97,
              attn_impl="ref", remat=False)
CONFIGS = ["qwen3", "phi35", "models"]
JAX_IMPL = {"flash": "pallas", "chunked": "chunked", "ref": "ref"}
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=50)
SEQ = 16
TOL = 1e-5
TOL_AUX = 1e-6
TOL_BF16 = 3e-2
TOL_FWD = 1e-4
TOL_STEP = 5e-5
TOL_NU = 2 * TOL_STEP
F64_FACTOR = 2.0
BF16_DEPTH = 1        # the bf16 step's cut (module docstring)


def _cfgs(which, impl="ref", **kw):
    """(JAX cfg, port cfg) of a config, f32, on ``impl``."""
    if which == "models":
        jcfg, cfg = JModelConfig(**MODELS), ModelConfig(**MODELS)
    else:
        arch = QWEN if which == "qwen3" else PHI
        jcfg, cfg = jregistry.get(arch).SMOKE, registry.get(arch).SMOKE
    return (jcfg.replace(dtype="float32", attn_impl=JAX_IMPL[impl], **kw),
            cfg.replace(attn_impl=impl, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(which, dtype="float32"):
    jcfg, _ = _cfgs(which)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jax.tree.map(np.asarray, jinit(japi.params(jcfg),
                                          jax.random.PRNGKey(0), dt))


def _np64(a) -> np.ndarray:
    """A tensor, JAX array or numpy array (bf16 too) as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a.astype(np.float64)


def _rel(got, want) -> float:
    got, want = _np64(got), _np64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _layer0_moe(which, dtype="float32"):
    """Layer 0's ``moe`` subtree: (JAX's, as numpy)."""
    return jax.tree.map(lambda a: a[0],
                        _jax_params(which, dtype)["blocks"]["moe"])


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _jax_routing(jp, x, jcfg):
    """JAX's routing of ``moe_apply`` (``repro/models/layers.py:696-731``)
    with its own primitives on its own arrays: (gate_idx (g, tg, k), slot
    (g, tg, k) in choice order, ``e * cap`` where dropped, counts (g,
    e))."""
    b, s, d = x.shape
    e, k = jcfg.n_experts, jcfg.top_k
    xg = x.reshape(1, b, d) if s == 1 else x
    g, tg, _ = xg.shape
    logits = jnp.einsum("gtd,de->gte", xg, jp["router"]).astype(jnp.float32)
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    cap = max(int(math.ceil(tg * k / e * jcfg.capacity_factor)), 1)

    def one(idx1):
        flat_e = idx1.reshape(tg * k)
        order = jnp.argsort(flat_e)
        seg = flat_e[order]
        counts = jnp.bincount(flat_e, length=e)
        starts = jnp.concatenate([jnp.zeros(1, counts.dtype),
                                  jnp.cumsum(counts)[:-1]])
        rank = jnp.arange(tg * k) - starts[seg]
        slot = jnp.where(rank < cap, seg * cap + rank, e * cap)
        return jnp.zeros_like(slot).at[order].set(slot), counts
    slot, counts = jax.vmap(one)(gate_idx)
    return (np.asarray(gate_idx), np.asarray(slot).reshape(g, tg, k),
            np.asarray(counts))


def _port_routing(gate_idx, cfg, tg):
    """The port's (gate_idx, slot in choice order, counts) from the
    recorded choices, through ``layers.moe_dispatch``."""
    cap = max(int(math.ceil(tg * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)), 1)
    rows, by_expert, _, _, counts = layers.moe_dispatch(
        gate_idx, cfg.n_experts, cap)
    slot = np.empty(tuple(rows.shape), np.int64)
    np.put_along_axis(slot, by_expert.numpy(), rows.numpy(), axis=2)
    return gate_idx.numpy(), slot, counts.numpy()


def _moe_both(which, x, dtype="float32", jp=None, **kw):
    """``moe_apply`` of layer 0 in both packages on ``x`` (numpy f32, cast
    to ``dtype`` on both sides): (JAX (y, aux), port (y, aux), JAX
    routing, port routing)."""
    jcfg, cfg = _cfgs(which, **kw)
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jp = _layer0_moe(which, dtype) if jp is None else jp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    jy, jaux = jlayers.moe_apply(jax.tree.map(jnp.asarray, jp), jx, jcfg,
                                 make_rules())
    tx = params_from_jax(np.asarray(jx))
    with float64.routes() as rec, torch.no_grad():
        y, aux = layers.moe_apply(params_from_jax(jp), tx, cfg)
    tg = x.shape[0] if x.shape[1] == 1 else x.shape[1]
    return ((jy, jaux), (y, aux), _jax_routing(jp, jx, jcfg),
            _port_routing(rec[0], cfg, tg))


def _assert_same_routing(jr, pr):
    for name, a, b in zip(("gate_idx", "slot", "counts"), jr, pr):
        np.testing.assert_array_equal(b, a, err_msg=name)


def _x(cfg, b=2, s=SEQ, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [SEQ, 1])
@pytest.mark.parametrize("which", CONFIGS)
def test_moe_apply_matches_jax(which, s):
    """Prefill groups (one a sequence) and decode's one group over the
    batch (``s == 1``): routing identical, y within TOL, aux within
    TOL_AUX."""
    _, cfg = _cfgs(which)
    x = _x(cfg, b=4 if s == 1 else 2, s=s)
    (jy, jaux), (y, aux), jr, pr = _moe_both(which, x)
    _assert_same_routing(jr, pr)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _rel(y, jy) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL_AUX * abs(float(jaux))


def test_moe_shared_expert_matches_jax():
    """``shared_expert_dff`` (no registered config sets it): the dense
    SwiGLU expert beside the routed ones, on the same group."""
    jcfg, cfg = _cfgs("qwen3", shared_expert_dff=40)
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jinit(
        japi.params(jcfg), jax.random.PRNGKey(0), jnp.float32)["blocks"]
        ["moe"])
    assert sorted(jp["shared"]) == ["w_down", "w_gate", "w_up"]
    for s in (SEQ, 1):
        x = _x(cfg, b=3, s=s, seed=4)
        (jy, jaux), (y, aux), jr, pr = _moe_both(
            "qwen3", x, jp=jp, shared_expert_dff=40)
        _assert_same_routing(jr, pr)
        assert _rel(y, jy) <= TOL
        assert abs(float(aux) - float(jaux)) <= TOL_AUX * abs(float(jaux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planted_tie_picks_jax_experts(dtype):
    """Router columns 1, 3, 4 and 6 equal (and 2 = 5): equal logits, equal
    probabilities, ties at every token; JAX's top_k takes the lower index
    first, and so must the port."""
    jp = dict(_layer0_moe("qwen3", dtype))
    router = np.array(jp["router"], copy=True)
    for c in (3, 4, 6):
        router[:, c] = router[:, 1]
    router[:, 5] = router[:, 2]
    jp["router"] = router
    _, cfg = _cfgs("qwen3")
    x = _x(cfg, seed=5)
    (jy, _), (y, _), jr, pr = _moe_both("qwen3", x, dtype, jp=jp)
    _assert_same_routing(jr, pr)
    # the tie is real: some token's two choices are tied columns
    tied = {1: 1, 3: 1, 4: 1, 6: 1, 2: 2, 5: 2}
    pairs = [tuple(sorted(r)) for r in jr[0].reshape(-1, 2)]
    assert any(a in tied and b in tied and tied[a] == tied[b]
               for a, b in pairs)
    assert _rel(y, jy) <= (TOL if dtype == "float32" else TOL_BF16)


def test_forced_overflow_drops_jax_tokens():
    """Every token's first choice is expert 0 (a dominant router
    direction, prob ~0.998): cap = 5 of its 16 choices a group are kept,
    the other 11 dropped, the same ones as JAX's; a dropped token keeps
    only its second expert's share."""
    jp = dict(_layer0_moe("qwen3"))
    router = np.array(jp["router"], copy=True)
    router[0, 0] = 2.0
    jp["router"] = router
    _, cfg = _cfgs("qwen3")
    x = _x(cfg, seed=6)
    x[..., 0] = 4.0
    (jy, jaux), (y, aux), jr, pr = _moe_both("qwen3", x, jp=jp)
    _assert_same_routing(jr, pr)
    e, cap = cfg.n_experts, 5
    assert (jr[0][..., 0] == 0).all()
    dropped = (jr[0] == 0) & (jr[1] == e * cap)
    assert (dropped.sum(axis=(1, 2)) == SEQ - cap).all()
    assert _rel(y, jy) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL_AUX * abs(float(jaux))


@pytest.mark.parametrize("seed", range(4))
def test_dispatch_maps_every_kept_choice_both_ways(seed):
    """``moe_dispatch``'s maps agree: the buffer row a kept choice fills
    takes that choice's token, and names that choice back; empty rows
    read nothing; drops follow capacity in (expert, token, choice)
    order; counts are the choices before drops."""
    rng = np.random.default_rng(seed)
    g, tg, e, k = 2, 12, 5, 3
    idx = np.stack([np.stack([rng.choice(e, k, replace=False)
                              for _ in range(tg)]) for _ in range(g)])
    if seed == 0:                     # every token on expert 0: overflow
        idx = np.stack([np.stack([[0, *1 + rng.choice(e - 1, k - 1,
                                                      replace=False)]
                                  for _ in range(tg)]) for _ in range(g)])
    cap = 4
    rows, by_expert, src, back, counts = (t.numpy() for t in
                                          layers.moe_dispatch(
                                              torch.from_numpy(idx), e, cap))
    for gi in range(g):
        seen = np.zeros(e, int)
        taken = {}
        for ei in range(e):
            for t in range(tg):
                for j in range(k):
                    if idx[gi, t, j] != ei:
                        continue
                    row = ei * cap + seen[ei] if seen[ei] < cap else e * cap
                    seen[ei] += 1
                    taken[(t, j)] = row
        np.testing.assert_array_equal(counts[gi], seen)
        for t in range(tg):
            assert (np.diff(idx[gi, t, by_expert[gi, t]]) > 0).all()
            for i in range(k):
                j = by_expert[gi, t, i]
                assert rows[gi, t, i] == taken[(t, j)]
                if rows[gi, t, i] < e * cap:
                    r = rows[gi, t, i]
                    assert src[gi, r] == t and back[gi, r] == t * k + i
        filled = {r for r in taken.values() if r < e * cap}
        for r in set(range(e * cap)) - filled:
            assert src[gi, r] == tg and back[gi, r] == tg * k


@pytest.mark.parametrize("which", ["qwen3", "phi35"])
def test_moe_apply_bf16_matches_jax_where_routing_agrees(which):
    """bf16 params and a bf16 input: each package rounds its router
    logits to bf16 itself; over the tokens whose experts and rows agree
    with JAX's, y within TOL_BF16 of max|y|; aux within TOL_BF16."""
    _, cfg = _cfgs(which)
    x = _x(cfg, b=2, s=32, seed=7)
    (jy, jaux), (y, aux), jr, pr = _moe_both(which, x, "bfloat16")
    assert y.dtype == torch.bfloat16
    same = ((jr[0] == pr[0]) & (jr[1] == pr[1])).all(-1)      # (g, tg)
    print(f"\n{which} bf16: {int((~same).sum())} of {same.size} tokens "
          "routed otherwise than JAX's")
    assert same.mean() >= 0.9
    jy = np.asarray(jnp.asarray(jy, jnp.float32))
    diff = np.abs(y.float().numpy() - jy)[same]
    assert diff.max() <= TOL_BF16 * np.abs(jy).max()
    assert abs(float(aux) - float(jaux)) <= TOL_BF16 * abs(float(jaux))


def test_moe_gradient_sums_a_tokens_choices_in_order():
    """Autograd of the dispatch and combine runs ``_GatherRows``' gather
    backward (an ordered sum over a token's k choices; no index_put or
    scatter node, which would sum them with atomics on the card), and
    matches autograd of the same function through plain gathers."""
    _, cfg = _cfgs("qwen3")
    p = params_from_jax(_layer0_moe("qwen3"))
    x = torch.from_numpy(_x(cfg, seed=8)).requires_grad_()
    y, aux = layers.moe_apply(p, x, cfg)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    dx, = torch.autograd.grad((y * g).sum() + aux, x)
    names = set()

    def walk(fn):
        if fn is None or fn in seen:
            return
        seen.add(fn)
        names.add(type(fn).__name__)
        for nxt, _ in fn.next_functions:
            walk(nxt)
    seen = set()
    walk((y * g).sum().grad_fn)
    assert "_GatherRowsBackward" in names
    assert not any("Scatter" in n or "IndexPut" in n or "Index" == n[:5]
                   for n in names), names
    # the same function with autograd's own gathers
    saved = layers._GatherRows.apply
    try:
        layers._GatherRows.apply = lambda src, idx, inv: layers._rows_of(
            src, idx)
        x2 = x.detach().requires_grad_()
        y2, aux2 = layers.moe_apply(p, x2, cfg)
        dx2, = torch.autograd.grad((y2 * g).sum() + aux2, x2)
    finally:
        layers._GatherRows.apply = saved
    assert torch.equal(y, y2)
    assert _rel(dx, dx2.numpy()) <= TOL


# ---------------------------------------------------------------------------
# Prefill, decode, serving
# ---------------------------------------------------------------------------

def _tokens(cfg, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


@functools.lru_cache(maxsize=None)
def _jax_forward(which, impl):
    jcfg, cfg = _cfgs(which, impl)
    logits, aux = japi.forward(jax.tree.map(jnp.asarray, _jax_params(which)),
                               {"tokens": jnp.asarray(_tokens(cfg))}, jcfg,
                               make_rules())
    return np.asarray(logits), float(aux)


@functools.lru_cache(maxsize=None)
def _oracle(which):
    """The float64 oracle's logits and aux on the port's f32 routing."""
    _, cfg = _cfgs(which, "ref")
    p = params_from_jax(_jax_params(which))
    tokens = torch.from_numpy(_tokens(cfg))
    with float64.routes() as rec, torch.no_grad():
        api.forward(p, {"tokens": tokens}, cfg)
    assert len(rec) == cfg.n_layers
    with float64.float64(routes=rec), torch.no_grad():
        logits, aux = api.forward(float64.widen(p), {"tokens": tokens}, cfg)
    assert logits.dtype == torch.float64 and aux.dtype == torch.float64
    return logits.numpy(), float(aux)


@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("which", CONFIGS)
def test_prefill_matches_jax(which, impl):
    jcfg, cfg = _cfgs(which, impl)
    jlogits, jaux = _jax_forward(which, impl)
    p = params_from_jax(_jax_params(which))
    tokens = torch.from_numpy(_tokens(cfg))
    fa.reset_launch_counts()
    logits, tok = steps.make_prefill_step(cfg)(p, {"tokens": tokens})
    with torch.no_grad():
        _, aux = api.forward(p, {"tokens": tokens}, cfg)
    assert logits.shape == (2, SEQ, cfg.vocab)
    assert _rel(logits, jlogits) <= TOL_FWD
    np.testing.assert_array_equal(tok.numpy(), jlogits[:, -1].argmax(-1))
    assert abs(float(aux) - jaux) <= TOL_AUX * abs(jaux)
    # the float64 oracle on the port's routing
    want, aux64 = _oracle(which)
    jax_dist = max(_rel(_jax_forward(which, i)[0], want)
                   for i in ("flash", "ref"))
    assert _rel(logits, want) <= max(F64_FACTOR * jax_dist, TOL)
    assert abs(float(aux) - aux64) <= TOL_AUX * abs(aux64)
    assert set(fa.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("which", CONFIGS)
def test_decode_steps_match_jax(which):
    """8 decode steps, each one group of the batch's B tokens (cap 1 at B
    2, so drops are common): the tokens equal, every cache within TOL."""
    jcfg, cfg = _cfgs(which)
    jp = _jax_params(which)
    b, max_len, n_steps = 2, 10, 8
    toks = _tokens(cfg, b, n_steps, seed=1)
    jstate = jinit(japi.decode_state(jcfg, b, max_len),
                   jax.random.PRNGKey(0))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, make_rules()))
    p = params_from_jax(jp)
    state = init_params(api.decode_state(cfg, b, max_len), torch.Generator())
    assert sorted(state) == ["caches"]
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


def test_decode_logits_match_jax():
    """One decode step's logits (B 4: one group, cap 1) against JAX's
    ``api.decode`` on the same state."""
    jcfg, cfg = _cfgs("qwen3")
    jp = _jax_params("qwen3")
    b, max_len = 4, 6
    toks = _tokens(cfg, b, 3, seed=2)
    jstate = jinit(japi.decode_state(jcfg, b, max_len),
                   jax.random.PRNGKey(0))
    state = init_params(api.decode_state(cfg, b, max_len), torch.Generator())
    p = params_from_jax(jp)
    for t in range(3):
        jl, jstate = japi.decode(jax.tree.map(jnp.asarray, jp), {
            "tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32),
            "cache_len": jnp.full((b,), t + 1, jnp.int32)}, jstate, jcfg,
            make_rules())
        with torch.no_grad():
            logits, state = api.decode(p, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "cache_len": torch.full((b,), t + 1, dtype=torch.int32)},
                state, cfg)
        assert logits.shape == (b, 1, cfg.vocab)
        assert _rel(logits, jl) <= TOL


@pytest.mark.parametrize("which", CONFIGS)
def test_serve_batch_matches_jax(which):
    jcfg, cfg = _cfgs(which)
    jp = _jax_params(which)
    prompts = _tokens(cfg, 2, 6, seed=3)
    want = jserve.serve_batch(jcfg, jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(prompts, jnp.int32), 8,
                              make_rules())
    got = serve.serve_batch(cfg, params_from_jax(jp),
                            torch.from_numpy(prompts), 8)
    assert got.shape == (2, 6 + 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_is_not_stepped_decode():
    """Why the card checks decode against ``api.decode`` on ``"ref"``,
    not against prefill: capacity is a sequence's in prefill and the
    batch's at decode, so a token kept in one is dropped in the other."""
    _, cfg = _cfgs("qwen3")
    p = params_from_jax(_jax_params("qwen3"))
    toks = torch.from_numpy(_tokens(cfg, 4, 12, seed=9))
    logits, _ = steps.make_prefill_step(cfg)(p, {"tokens": toks})
    state = init_params(api.decode_state(cfg, 4, 12), torch.Generator())
    worst = 0.0
    with torch.no_grad():
        for t in range(12):
            step, state = api.decode(p, {
                "tokens": toks[:, t:t + 1],
                "cache_len": torch.full((4,), t + 1, dtype=torch.int32)},
                state, cfg)
            worst = max(worst, _rel(step[:, 0], logits[:, t].numpy()))
    assert worst > 1e-3


# ---------------------------------------------------------------------------
# Training, f32
# ---------------------------------------------------------------------------

def _train_batch(which, seed=0):
    _, cfg = _cfgs(which)
    return jmake_batch(JDataConfig(batch=4, seq=SEQ + 1, vocab=cfg.vocab,
                                   task="copy", seed=seed), 0)


@functools.lru_cache(maxsize=None)
def _jax_state(which):
    jcfg, _ = _cfgs(which)
    return jax.tree.map(np.asarray, jinit(
        jsteps.train_state_decl(jcfg, JAdamWConfig(**OPT)),
        jax.random.PRNGKey(0), jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_step(which, n_micro):
    jcfg, _ = _cfgs(which, "ref")
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                           make_rules(), n_micro))
    new, met = jstep(jax.tree.map(jnp.asarray, _jax_state(which)),
                     {k: jnp.asarray(v)
                      for k, v in _train_batch(which).items()})
    return jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, met)


def _port_step(which, n_micro, remat):
    _, cfg = _cfgs(which, "flash")
    step = steps.make_train_step(cfg.replace(remat=remat),
                                 AdamWConfig(**OPT), n_micro=n_micro)
    return step(train_state_from_jax(_jax_state(which)),
                {k: torch.from_numpy(v)
                 for k, v in _train_batch(which).items()})


def _leaf_errs(got, want) -> list:
    return [_rel(np.asarray(a), b) for a, b in zip(got, want)]


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("which", CONFIGS)
def test_train_step_matches_jax(which, n_micro):
    """One AdamW step (flash, remat) against JAX's jitted step on
    ``"ref"``: the loss (with the routers' aux), grad norm, mu and nu,
    and the params by ``_check_step``."""
    jnew, jmet = _jax_step(which, n_micro)
    state, met = _port_step(which, n_micro, True)
    assert int(state["step"]) == int(jnew["step"]) == 1
    assert _rel(met["loss"], jmet["loss"]) <= TOL
    assert _rel(met["grad_norm"], jmet["grad_norm"]) <= TOL_STEP
    assert _rel(met["lr"], jmet["lr"]) <= TOL
    got, want, old = _trees(state), _trees(jnew), _trees(_jax_state(which))
    for name, tol in (("mu", TOL_STEP), ("nu", TOL_NU)):
        errs = _leaf_errs(got[name], want[name])
        assert max(errs) <= tol, (name, max(errs))
    _check_step(old["params"], got["params"], want["params"], old["mu"],
                want["mu"], want["nu"], got["mu"], got["nu"],
                AdamWConfig(**OPT), float(jmet["lr"]), 1, TOL_STEP)


@pytest.mark.parametrize("which", CONFIGS)
def test_remat_on_and_off_are_bitwise_equal(which):
    """The MoE blocks checkpointed (aux returned through the checkpoint)
    give the step without remat bit for bit."""
    out = {remat: _port_step(which, 1, remat) for remat in (False, True)}
    for a, b in zip(adamw.tree_leaves(out[False][0]),
                    adamw.tree_leaves(out[True][0])):
        assert torch.equal(a, b)
    for key in ("loss", "grad_norm"):
        assert torch.equal(out[False][1][key], out[True][1][key])


def test_loss_carries_the_summed_aux():
    """``api.forward``'s aux is the layers' aux summed in layer order, and
    the train step's loss adds 0.01 of it, as JAX's."""
    _, cfg = _cfgs("qwen3")
    p = params_from_jax(_jax_params("qwen3"))
    batch = {k: torch.from_numpy(v)
             for k, v in _train_batch("qwen3").items()}
    auxes = []
    saved = layers.moe_apply

    def spy(*args, **kw):
        y, aux = saved(*args, **kw)
        auxes.append(aux)
        return y, aux
    layers.moe_apply = spy
    try:
        with torch.no_grad():
            logits, aux = api.forward(p, batch, cfg)
    finally:
        layers.moe_apply = saved
    assert len(auxes) == cfg.n_layers
    assert torch.equal(aux, 0.0 + auxes[0] + auxes[1])
    jlogits, jaux = japi.forward(
        jax.tree.map(jnp.asarray, _jax_params("qwen3")),
        {"tokens": jnp.asarray(batch["tokens"].numpy())},
        _cfgs("qwen3")[0], make_rules())
    loss = api.loss_fn(logits, batch["labels"], aux)
    jloss = japi.loss_fn(jlogits, jnp.asarray(batch["labels"].numpy()), jaux)
    assert _rel(loss, jloss) <= TOL
    assert float(loss - api.loss_fn(logits, batch["labels"])) == \
        pytest.approx(0.01 * float(aux), rel=1e-4)


def _loss64(logits, labels, aux):
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    return nll.mean() + 0.01 * aux


@functools.lru_cache(maxsize=None)
def _jax_grads(which, impl):
    """JAX's f32 gradient of the loss (with aux) at the train state's
    params on ``_train_batch(which)``, each leaf float64."""
    jcfg, _ = _cfgs(which, impl)
    jb = {k: jnp.asarray(v) for k, v in _train_batch(which).items()}

    def loss(p):
        logits, aux = japi.forward(p, jb, jcfg, make_rules())
        return japi.loss_fn(logits, jb["labels"], aux)
    return [np.asarray(g, np.float64) for g in jax.tree.leaves(
        jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray,
                                             _jax_state(which)["params"])))]


@pytest.mark.parametrize("which", CONFIGS)
def test_gradient_against_float64(which):
    """The port's gradient (flash) per leaf against the float64 oracle on
    the port's routing: within TOL_STEP of each leaf's max, and within
    F64_FACTOR x the farthest of JAX's f32 gradients (ref, chunked) from
    the same oracle."""
    _, cfg = _cfgs(which, "flash")
    batch = {k: torch.from_numpy(v)
             for k, v in _train_batch(which).items()}
    params = train_state_from_jax(_jax_state(which))["params"]
    live = [t.requires_grad_() for t in adamw.tree_leaves(params)]
    with float64.routes() as rec:
        logits, aux = api.forward(adamw.tree_unflatten(params, live), batch,
                                  cfg.replace(remat=False))
    grads = torch.autograd.grad(
        api.loss_fn(logits, batch["labels"], aux), live)
    wide = [t.detach().double().requires_grad_()
            for t in adamw.tree_leaves(params)]
    with float64.float64(routes=rec):
        logits, aux = api.forward(adamw.tree_unflatten(params, wide), batch,
                                  cfg.replace(attn_impl="ref", remat=False))
        want = torch.autograd.grad(_loss64(logits, batch["labels"], aux),
                                   wide)
    want = [w.numpy() for w in want]
    port = max(_leaf_errs([g.numpy() for g in grads], want))
    jax32 = max(max(_leaf_errs(_jax_grads(which, impl), want))
                for impl in ("ref", "chunked"))
    assert port <= TOL_STEP, port
    assert port <= F64_FACTOR * jax32, (port, jax32)


# ---------------------------------------------------------------------------
# bf16 training
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bf16_steps(which, depth=None):
    """(bf16 train state, JAX's bf16 step, JAX's f32 step on the widened
    params), each (new state, metrics) as numpy; JAX on "chunked"; the
    state drawn at ``depth`` layers (None: the config's)."""
    jcfg, _ = _cfgs(which, "chunked")
    jcfg = jcfg.replace(n_layers=depth or jcfg.n_layers)
    state = jax.tree.map(np.asarray, jinit(
        jsteps.train_state_decl(jcfg, JAdamWConfig(**OPT)),
        jax.random.PRNGKey(0), jnp.bfloat16))
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                           make_rules()))
    jb = {k: jnp.asarray(v) for k, v in _train_batch(which).items()}
    out = []
    for widen in (False, True):
        st = jax.tree.map(jnp.asarray, state)
        if widen:
            st = dict(st, params=jax.tree.map(
                lambda a: a.astype(jnp.float32), st["params"]))
        new, met = jstep(st, jb)
        out.append((jax.tree.map(np.asarray, new),
                    {k: float(v) for k, v in met.items()}))
    return state, out[0], out[1]


def _bf16_port_step(which, depth=None):
    """The port's bf16 step (flash, remat) on ``_bf16_steps``' state:
    (rows of the bf16 LM rule, JAX's bf16 new state)."""
    state, jax_bf16, jax_f32 = _bf16_steps(which, depth)
    _, cfg = _cfgs(which, "flash")
    cfg = cfg.replace(dtype="bfloat16", remat=True,
                      n_layers=depth or cfg.n_layers)
    port, met = steps.make_train_step(cfg, AdamWConfig(**OPT))(
        train_state_from_jax(state),
        {k: torch.from_numpy(v) for k, v in _train_batch(which).items()})
    met = {k: float(v) for k, v in met.items()}
    for (name, _), got, want in zip(_leaves(jax_bf16[0]), _port_leaves(port),
                                    _jax_leaves(jax_bf16[0])):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32), name
        assert torch.isfinite(got).all(), name
    return _rows(port, met, jax_bf16, jax_f32)


@pytest.mark.parametrize("which", CONFIGS)
def test_bf16_train_step_matches_jax(which):
    """One step at the depth-1 cut on bf16 params (norm scales f32,
    moments f32) against JAX's jitted bf16 step, every leaf by the bf16
    LM rule, every leaf of JAX's dtype."""
    rows = _bf16_port_step(which, BF16_DEPTH)
    _print_rows(f"{which} bf16 step, depth {BF16_DEPTH}", rows)
    bad = [row for row in rows if not row[1] <= row[3]]
    assert not bad, bad


@pytest.mark.parametrize("which", CONFIGS)
def test_bf16_is_ill_conditioned_at_full_depth(which):
    """At full SMOKE depth (2 layers) one bf16 step's loss and grad norm
    lie within the rule's limits of JAX's bf16 step, every leaf finite
    and of JAX's dtype; and why the leaves are held at the cut: JAX's own
    bf16 step reads a median of more than 0.2 of a mu or nu leaf's max
    from its f32 step at full depth, several times its median at the
    cut."""
    rows = _bf16_port_step(which)
    _print_rows(f"{which} bf16 step, full SMOKE depth", rows)
    assert all(row[1] <= row[3] for row in rows[:2]), rows[:2]
    cut = _bf16_port_step(which, BF16_DEPTH)

    def own(rows_):
        return float(np.median([r[2] for r in rows_
                                if r[0].startswith(("mu/", "nu/"))]))
    print(f"JAX bf16 vs f32, median over mu and nu: full depth "
          f"{own(rows):.3e}, the cut {own(cut):.3e}")
    assert own(rows) > 0.2 and own(rows) > 2 * own(cut)


# ---------------------------------------------------------------------------
# The initialiser, the tree, the configs, the entry points
# ---------------------------------------------------------------------------

def _old_init(tree, generator, dtype):
    """``init_params`` as it was before sliced draws: each normal leaf
    drawn whole in f32, scaled, then cast."""
    if isinstance(tree, Param):
        dt = tree.dtype or dtype
        if tree.init == "zeros":
            return torch.zeros(tree.shape, dtype=dt)
        if tree.init == "ones":
            return torch.ones(tree.shape, dtype=dt)
        fan_in = tree.shape[-2] if len(tree.shape) >= 2 else tree.shape[-1]
        std = tree.scale / math.sqrt(max(fan_in, 1))
        return torch.randn(tree.shape, generator=generator,
                           dtype=torch.float32).mul_(std).to(dtype=dt)
    return {k: _old_init(v, generator, dtype) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "falcon-mamba-7b",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_other_families_init_is_bitwise_the_old_draw(arch, dtype):
    cfg = registry.get(arch).SMOKE
    got = init_params(api.params(cfg), torch.Generator().manual_seed(3),
                      dtype=dtype)
    want = _old_init(api.params(cfg), torch.Generator().manual_seed(3),
                     dtype)
    for a, b in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_full_width_bf16_init_draws_a_layer_slice_at_a_time(monkeypatch):
    """qwen3-moe-30b-a3b at full width in bf16, traced on the meta device:
    each expert leaf (48 x 128 x 2048 x 768, 38.7 GB as one f32 draw) is
    drawn in 48 slices of one layer (0.81 GB of f32); every other leaf
    whole, as before, the largest the stacked ``wq`` (48 x 2048 x 32 x
    128: 1.6 GB of f32, as every stacked leaf of the other families)."""
    cfg = registry.get(QWEN).CONFIG
    decl = api.params(cfg)
    draws = []

    def fake_randn(shape, *, generator=None, dtype=None, device=None):
        draws.append(tuple(shape))
        return torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setattr(torch, "randn", fake_randn)
    tree = init_params(decl, torch.Generator(), device="meta",
                       dtype=torch.bfloat16)
    sliced = {(cfg.n_experts, cfg.d_model, cfg.moe_dff): 2 * cfg.n_layers,
              (cfg.n_experts, cfg.moe_dff, cfg.d_model): cfg.n_layers}
    for shape, n in sliced.items():
        assert draws.count(shape) == n
    whole = [tuple(p.shape) for p in _decl_leaves(decl)
             if p.init == "normal" and not p.sliced]
    assert [s for s in draws if s not in sliced] == whole
    assert max(math.prod(s) for s in whole) == (
        cfg.n_layers * cfg.d_model * cfg.n_heads * cfg.hd)
    moe = tree["blocks"]["moe"]
    assert tuple(moe["w_gate"].shape) == (cfg.n_layers, cfg.n_experts,
                                          cfg.d_model, cfg.moe_dff)
    assert moe["w_down"].dtype == torch.bfloat16
    assert tree["blocks"]["ln_att"]["scale"].dtype == torch.float32


def _decl_leaves(tree):
    if isinstance(tree, Param):
        yield tree
    else:
        for v in tree.values():
            yield from _decl_leaves(v)


def test_sliced_draw_keeps_the_fan_in_and_the_seed():
    """A sliced leaf draws with std scale / sqrt(shape[-2]) of the whole
    leaf, the same numbers on every call with one seed, and its f32 and
    bf16 draws are one rounding apart."""
    cfg = registry.get(QWEN).SMOKE.replace(d_model=128, moe_dff=64)
    decl = api.params(cfg)
    a = init_params(decl, torch.Generator().manual_seed(0))
    b = init_params(decl, torch.Generator().manual_seed(0))
    c = init_params(decl, torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16)
    wg, wd = a["blocks"]["moe"]["w_gate"], a["blocks"]["moe"]["w_down"]
    assert torch.equal(wg, b["blocks"]["moe"]["w_gate"])
    assert torch.equal(c["blocks"]["moe"]["w_gate"], wg.to(torch.bfloat16))
    assert abs(wg.std().item() * cfg.d_model ** 0.5 - 1) < 0.03
    assert abs(wd.std().item() * cfg.moe_dff ** 0.5 - 1) < 0.03
    router = a["blocks"]["moe"]["router"]
    assert abs(router.std().item() * cfg.d_model ** 0.5 - 0.1) < 0.01


def test_convert_keeps_the_moe_tree_and_layout():
    """``params_from_jax`` carries ``blocks.moe`` unchanged (router (L, d,
    e), w_gate / w_up (L, e, d, f), w_down (L, e, f, d)), and the port
    declares the same tree; train states too."""
    jp = _jax_params("qwen3")
    _, cfg = _cfgs("qwen3")
    p = params_from_jax(jp)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(adamw.tree_leaves(p))
    for path, leaf in flat:
        t = p
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
    moe = p["blocks"]["moe"]
    L, d, e, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.moe_dff
    assert "mlp" not in p["blocks"]
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (L, d, e), "w_gate": (L, e, d, f), "w_up": (L, e, d, f),
        "w_down": (L, e, f, d)}
    decl = init_params(api.params(cfg), torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in adamw.tree_leaves(decl)] == [
        tuple(t.shape) for t in adamw.tree_leaves(p)]
    moved = train_state_from_jax(_jax_state("qwen3"))
    assert sorted(moved["opt"]["mu"]["blocks"]) == sorted(p["blocks"])


def test_config_checks_the_moe_fields():
    cfg = registry.get(QWEN).CONFIG
    assert cfg.attn_impl == "flash" and cfg.family == "moe"
    assert (registry.get(QWEN).SMOKE.attn_impl,
            registry.get(QWEN).SMOKE.remat) == ("ref", False)
    for bad in (dict(top_k=0), dict(top_k=129), dict(moe_dff=0),
                dict(moe_impl="dense"), dict(family="gpt")):
        with pytest.raises(ValueError):
            cfg.replace(**bad)
    assert registry.count_params(cfg) == 30_532_110_336
    assert registry.count_params(registry.get(PHI).CONFIG) == 41_872_793_600


@pytest.mark.parametrize("arch", [QWEN, PHI])
def test_entry_points_run_the_family(arch, tmp_path, capsys):
    """``launch.serve`` and ``launch.train`` take the MoE ids (``--smoke
    --device cpu``)."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--gen", "4"])
    assert tuple(out.shape) == (4, 16 + 4)
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "17",
                      "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(res["final_loss"])
    assert res["state"]["params"]["blocks"]["moe"]["w_gate"].dtype == \
        torch.float32
    assert '"final_loss"' in capsys.readouterr().out
