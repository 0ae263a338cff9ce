"""bf16 LM training in the port against the JAX package on the CPU.

The train state is JAX's ``init_params(train_state_decl(...),
jnp.bfloat16)`` (bf16 params, the norms' scales f32, f32 moments), handed
to the port through ``convert.train_state_from_jax``; batches are JAX
``make_batch``'s.  On the CPU the port's kernels run their plain versions
(the conv1d's dx and dw, the flash backward), each computing in f32 and
rounding once to bf16.  Checked here:

* one step of ``steps.make_train_step`` on bf16 params for qwen2.5-3b,
  recurrentgemma-2b and falcon-mamba-7b SMOKE against JAX's jitted
  ``make_train_step`` on the same params and batch (the port on
  ``attn_impl="flash"``, JAX on ``"chunked"``, the path JAX trains
  through; qwen2.5-3b also at ``n_micro=2``).  The loss, the grad norm
  and every leaf of params, mu and nu are held on their own scale
  (max|port - JAX| over max|JAX|), each within ``TOL`` = 3e-2 of JAX's
  bf16 step or, where that is larger, ``F32_FACTOR`` (2x) JAX's own
  bf16-vs-f32 distance on that leaf (JAX's f32 step on the same widened
  params): ROADMAP Queue 3's ruling for ill-conditioned references.  The
  limits stop at ``CAP`` = 1/2, so a zeroed, unmoved or sign-flipped
  leaf (1.0, 1.0, 2.0) fails (``test_bf16_train_step_check_catches_a_
  planted_fault``).  After one AdamW step an element of a
  zero-initialised leaf is -lr g / (|g| + eps): where |g| lies within its
  mu leaf's limit of max|mu| the gradient's sign is not fixed (the port's
  and JAX's steps flip only at such elements, and where |g| nears eps
  the size is not fixed either), so a params leaf is held at the other
  elements, which include its largest gradient's.  A nonzero leaf
  moves by lr, under 3e-2 of its max: the moments carry the gradient.
  The distances are printed (``pytest -s``);
* recurrentgemma-2b is held at SMOKE widths cut to its first two layers
  (both recurrent; ``DEPTH``).  At the full SMOKE depth its third layer,
  local attention (window 8, soft cap 30, JAX's initialiser), sees
  saturated scores with near-tied rows: one bf16 rounding of anything
  before it flips such rows, so JAX's own bf16 step reads up to ~0.9 of
  a leaf's max from its f32 step there and no two bf16 computations
  agree per leaf.
  ``test_bf16_hybrid_full_depth_step`` holds that step's loss and grad
  norm and shows the reference's conditioning at both depths, and
  ``test_hybrid_gradient_amplifies_one_rounding_through_its_attention``
  the mechanism, on the port in f32;
* ``_FlashAttentionFn`` on bf16 q, k, v against ``jax.vjp`` of JAX's
  ``chunked_attention`` on the same bf16 values (GQA, a window, a soft
  cap, recurrentgemma-2b SMOKE's attention layer): within 2^-8 of max|grad|, since both are f32 math rounded once to
  bf16 (a value near a rounding boundary may land one ulp apart);
* ``_TrimConv1dFn`` on bf16 against ``jax.vjp`` of JAX's
  ``ref.depthwise_conv1d`` on bf16: within 3e-2 (JAX rounds after every
  bf16 operation, the port sums in f32 and rounds once; Queue 3);
* the redesigned weight-gradient plan's plain version, f32 and bf16,
  against an exact float64 sum within its order bound (below);
* ``apply_updates_`` on bf16 leaves bitwise equal to ``apply_updates``.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import registry
from repro_torch.convert import train_state_from_jax
from repro_torch.core import conv_plan
from repro_torch.distributed import steps
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import trim_conv1d as tc1
from repro_torch.optim import AdamWConfig, adamw

TOL = 3e-2
F32_FACTOR = 2.0
CAP = 0.5
FLASH_TOL = 2.0 ** -8
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=50)
ARCHS = ["qwen2.5-3b", "recurrentgemma-2b", "falcon-mamba-7b"]
DEPTH = {"recurrentgemma-2b": 2}    # layers held per leaf (module doc)
JAX_ATTN = "chunked"   # what JAX trains through (ops.py:867)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()


def _rel(got, want, where=None) -> float:
    """max|got - want| / max|want|, the max over ``where`` (all by
    default)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    if where is not None:
        diff = np.where(where, diff, 0.0)
    return float(diff.max() / (np.abs(want).max() + 1e-30))


def _leaves(state):
    """(name, leaf) of params, mu and nu in sorted-key order."""
    for name in ("params", "mu", "nu"):
        tree = state["params"] if name == "params" else state["opt"][name]
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            yield f"{name}/" + "/".join(k.key for k in path), np.asarray(
                leaf, np.float64)


def _jcfg(arch, n_layers=None):
    jcfg = jregistry.get(arch).SMOKE.replace(dtype="float32")
    if n_layers:
        jcfg = jcfg.replace(n_layers=n_layers)
    return jcfg.replace(attn_impl=JAX_ATTN) if jcfg.family != "ssm" \
        else jcfg


def _batch():
    return jmake_batch(JDataConfig(batch=4, seq=17, vocab=128, task="copy",
                                   seed=0), 0)


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, n_micro, n_layers):
    """(bf16 state, JAX's bf16 step, JAX's f32 step on the widened
    params), each step (new state, metrics) as numpy."""
    jcfg = _jcfg(arch, n_layers)
    state = jax.tree.map(np.asarray, jinit(
        jsteps.train_state_decl(jcfg, JAdamWConfig(**OPT)),
        jax.random.PRNGKey(0), jnp.bfloat16))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    step = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                          make_rules(), n_micro))
    out = []
    for widen in (False, True):
        st = jax.tree.map(jnp.asarray, state)
        if widen:
            st = dict(st, params=jax.tree.map(
                lambda a: a.astype(jnp.float32), st["params"]))
        new, met = step(st, batch)
        out.append((jax.tree.map(np.asarray, new),
                    {k: float(v) for k, v in met.items()}))
    return state, out[0], out[1]


def _port_step(arch, n_micro, n_layers, state):
    cfg = registry.get(arch).SMOKE
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if cfg.family != "ssm":
        cfg = cfg.replace(attn_impl="flash")
    port = train_state_from_jax(state)
    assert {t.dtype for t in adamw.tree_leaves(port["params"])} == {
        torch.bfloat16, torch.float32}
    port, met = steps.make_train_step(cfg, AdamWConfig(**OPT),
                                      n_micro=n_micro)(
        port, {k: torch.from_numpy(v) for k, v in _batch().items()})
    assert int(port["step"]) == 1
    return port, {k: float(v) for k, v in met.items()}


def _rows(port, met, jax_bf16, jax_f32):
    """(name, port vs JAX bf16, JAX bf16 vs JAX f32, limit) of the loss,
    the grad norm and every leaf (module docstring); a params leaf's
    distances over the elements where its mu leaf's limit fixes the
    gradient's sign (|mu| of JAX's bf16 step above it)."""
    (jnew, jmet), (fnew, fmet) = jax_bf16, jax_f32
    rows, limits = [], {}

    def row(name, got, want, f32, where=None):
        own = _rel(want, f32, where)
        limit = max(TOL, min(F32_FACTOR * own, CAP))
        rows.append((name, _rel(got, want, where), own, limit))
        limits[name] = limit
    for key in ("loss", "grad_norm"):
        row(key, met[key], jmet[key], fmet[key])
    leaves = [(name, _np(got), want, f32) for (name, want), (_, f32), got
              in zip(_leaves(jnew), _leaves(fnew), _port_leaves(port))]
    mu = {name[3:]: want for name, _, want, _ in leaves
          if name.startswith("mu/")}
    for name, got, want, f32 in leaves[len(mu):] + leaves[:len(mu)]:
        where = None
        if name.startswith("params/"):
            g = np.abs(mu[name[7:]])
            where = g > limits["mu/" + name[7:]] * g.max()
        row(name, got, want, f32, where)
    order = [name for name, *_ in leaves]
    return rows[:2] + sorted(rows[2:], key=lambda r: order.index(r[0]))


def _print_rows(title, rows):
    print(f"\n{title}: leaf, port vs JAX bf16, JAX bf16 vs JAX f32, limit")
    for name, got, own, limit in rows:
        print(f"  {name:32s} {got:.3e} {own:.3e} {limit:.3e}")


@pytest.mark.parametrize("arch,n_micro",
                         [(a, 1) for a in ARCHS] + [("qwen2.5-3b", 2)])
def test_bf16_train_step_matches_jax(arch, n_micro):
    depth = DEPTH.get(arch)
    state, jax_bf16, jax_f32 = _jax_steps(arch, n_micro, depth)
    tc1.reset_launch_counts()
    fa.reset_launch_counts()
    port, met = _port_step(arch, n_micro, depth, state)
    # every leaf keeps its dtype: params as JAX's, moments f32
    for (name, _), got, want in zip(_leaves(jax_bf16[0]), _port_leaves(port),
                                    _jax_leaves(jax_bf16[0])):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32), name
    rows = _rows(port, met, jax_bf16, jax_f32)
    _print_rows(f"{arch} n_micro={n_micro} depth={depth or 'SMOKE'}", rows)
    bad = [row for row in rows if not row[1] <= row[3]]
    assert not bad, bad
    # the CPU runs the plain versions: no kernel launch is counted
    for counts in (tc1.LAUNCHES, tc1.BWD_LAUNCHES, fa.LAUNCHES,
                   fa.BWD_LAUNCHES):
        assert set(counts.values()) == {0}


@pytest.mark.parametrize("fault", ["zeroed", "negated", "unmoved_nu",
                                   "unmoved_params"])
def test_bf16_train_step_check_catches_a_planted_fault(fault, monkeypatch):
    """The per-leaf check of ``test_bf16_train_step_matches_jax`` flags a
    fault planted in one leaf, the recurrentgemma-2b cut's first conv
    weight (fed by the conv1d weight gradient's plain version): its
    gradient zeroed or negated before AdamW (mu and nu, or mu, of that
    leaf fail), or its nu left at zero (nu fails); or the first rec
    layer's zero-initialised gate bias left unmoved by AdamW (params
    fail); and nothing else."""
    arch, depth = "recurrentgemma-2b", DEPTH["recurrentgemma-2b"]
    state, jax_bf16, jax_f32 = _jax_steps(arch, 1, depth)
    leaf = "blocks/layer_0/rec/conv_w"
    bias = "blocks/layer_0/rec/b_a"
    names = [name for name, _ in _leaves(jax_bf16[0])]
    index, bias_index = (names.index(f"params/{n}") for n in (leaf, bias))
    real = adamw.apply_updates_

    def planted(params, grads, moments, step, cfg):
        leaves = adamw.tree_leaves(grads)
        if fault == "zeroed":
            leaves[index].zero_()
        elif fault == "negated":
            leaves[index].neg_()
        before = adamw.tree_leaves(params)[bias_index].clone()
        out = real(params, grads, moments, step, cfg)
        if fault == "unmoved_nu":
            adamw.tree_leaves(moments["nu"])[index].zero_()
        if fault == "unmoved_params":
            adamw.tree_leaves(params)[bias_index].copy_(before)
        return out
    monkeypatch.setattr(adamw, "apply_updates_", planted)
    port, met = _port_step(arch, 1, depth, state)
    bad = {row[0] for row in _rows(port, met, jax_bf16, jax_f32)
           if not row[1] <= row[3]}
    want = {"zeroed": {f"mu/{leaf}", f"nu/{leaf}"},
            "negated": {f"mu/{leaf}"},
            "unmoved_nu": {f"nu/{leaf}"},
            "unmoved_params": {f"params/{bias}"}}[fault]
    assert want <= bad, (fault, bad)
    if fault != "zeroed":
        assert bad == want, (fault, bad)
    # a zeroed gradient also lowers the grad norm, which scales every
    # leaf's clipped gradient: leaves near their limits may fail too


def test_bf16_hybrid_full_depth_step():
    """recurrentgemma-2b at its full SMOKE depth (rec, rec, att): one bf16
    step's loss and grad norm within ``TOL`` of JAX's bf16 step, every
    leaf finite and of JAX's dtype; and why its leaves are held at the
    cut: JAX's own bf16 step reads a median of more than 0.1 of a mu or nu
    leaf's max from its f32 step at full depth, under ``TOL`` at the cut
    (the printed table holds every leaf's distances)."""
    arch = "recurrentgemma-2b"
    state, jax_bf16, jax_f32 = _jax_steps(arch, 1, None)
    port, met = _port_step(arch, 1, None, state)
    rows = _rows(port, met, jax_bf16, jax_f32)
    _print_rows(f"{arch} full SMOKE depth", rows)
    assert all(row[1] <= TOL for row in rows[:2]), rows[:2]
    for (name, _), got, want in zip(_leaves(jax_bf16[0]), _port_leaves(port),
                                    _jax_leaves(jax_bf16[0])):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32), name
        assert torch.isfinite(got).all(), name
    cut = _rows(*_port_step(arch, 1, DEPTH[arch],
                            _jax_steps(arch, 1, DEPTH[arch])[0]),
                *_jax_steps(arch, 1, DEPTH[arch])[1:])

    def own(rows_):
        return float(np.median([r[2] for r in rows_
                                if r[0].startswith(("mu/", "nu/"))]))
    print(f"JAX bf16 vs f32, median over mu and nu: full depth "
          f"{own(rows):.3e}, the cut {own(cut):.3e}")
    assert own(rows) > 0.1 and own(cut) < TOL


def test_hybrid_gradient_amplifies_one_rounding_through_its_attention():
    """The cause of the full-depth hybrid's conditioning, on the port in
    f32 (plain versions): each rec mixer's output multiplied by 1 + 2^-9
    N(0, 1), one bf16 rounding's size, moves the gradient by more than
    0.03 of a leaf's max (median over leaves) at full SMOKE depth, whose
    third layer attends, and by under a tenth of that at the two-layer
    cut; the attention layer's own output, so perturbed, moves it by
    under 0.01 (the amplification is in what reaches its scores)."""
    from repro_torch.models import api, rglru
    from repro_torch.models import layers as L
    arch = "recurrentgemma-2b"
    state = train_state_from_jax(_jax_steps(arch, 1, None)[0])
    params = adamw.tree_unflatten(state["params"], [
        t.float() for t in adamw.tree_leaves(state["params"])])
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def moved(n_layers, module, name):
        cfg = registry.get(arch).SMOKE.replace(n_layers=n_layers,
                                               attn_impl="flash")
        p = dict(params, blocks={f"layer_{i}": params["blocks"][
            f"layer_{i}"] for i in range(n_layers)})
        leaves = adamw.tree_leaves(p)

        def grads():
            live = [t.detach().requires_grad_() for t in leaves]
            logits, aux = api.forward(adamw.tree_unflatten(p, live), batch,
                                      cfg)
            return torch.autograd.grad(
                api.loss_fn(logits, batch["labels"], aux), live)
        base = grads()
        real = getattr(module, name)
        gen = torch.Generator().manual_seed(1)

        def rounded(*a, **k):
            y = real(*a, **k)
            return y * (1 + 2.0 ** -9 * torch.randn(y.shape, generator=gen))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, name, rounded)
            got = grads()
        return float(np.median([_rel(a, b) for a, b in zip(got, base)]))
    full = moved(3, rglru, "rec_mixer_apply")
    cut = moved(2, rglru, "rec_mixer_apply")
    att = moved(3, L, "attention_apply")
    print(f"\ngradient moved (median of a leaf's max) by one rounding of "
          f"the rec mixers' outputs: full depth {full:.3e}, the cut "
          f"{cut:.3e}; of the attention output {att:.3e}")
    assert full > 0.03 and cut < full / 10 and att < 0.01


def _port_leaves(state):
    for name in ("params", "mu", "nu"):
        tree = state["params"] if name == "params" else state["opt"][name]
        yield from adamw.tree_leaves(tree)


def _jax_leaves(state):
    for name in ("params", "mu", "nu"):
        tree = state["params"] if name == "params" else state["opt"][name]
        yield from jax.tree.leaves(tree)


def _bf16(rng, shape, scale=1.0):
    """A numpy f32 array of bf16 values (both packages get the same)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


FLASH_CASES = {
    "gqa": dict(shape=(2, 33, 40, 4, 2, 16), causal=True, soft_cap=None,
                window=None),
    "window": dict(shape=(1, 40, 40, 6, 3, 12), causal=True, soft_cap=None,
                   window=9),
    "soft_cap": dict(shape=(2, 24, 24, 4, 1, 16), causal=True, soft_cap=5.0,
                     window=None),
    "full": dict(shape=(1, 17, 30, 2, 2, 8), causal=False, soft_cap=None,
                 window=None),
    # recurrentgemma-2b SMOKE's attention layer (its step is held at the
    # two-layer cut, which has none)
    "hybrid": dict(shape=(4, 17, 17, 4, 1, 16), causal=True, soft_cap=30.0,
                   window=8),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_bf16_gradient_matches_jax_chunked(name):
    case = FLASH_CASES[name]
    b, lq, lk, hq, hkv, d = case["shape"]
    kw = dict(causal=case["causal"], soft_cap=case["soft_cap"],
              window=case["window"])
    rng = np.random.default_rng(len(name))
    q, do = _bf16(rng, (b, lq, hq, d), 2.0), _bf16(rng, (b, lq, hq, d))
    k, v = _bf16(rng, (b, lk, hkv, d), 2.0), _bf16(rng, (b, lk, hkv, d))
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, **kw)
    assert type(o.grad_fn).__name__ == "_FlashAttentionFnBackward"
    grads = torch.autograd.grad(o, (tq, tk, tv),
                                torch.from_numpy(do).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)

    def jfn(q_, k_, v_):
        return jops.chunked_attention(q_, k_, v_, causal=kw["causal"],
                                      soft_cap=kw["soft_cap"],
                                      window=kw["window"])
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jax.vjp(jfn, bf(q), bf(k), bf(v))[1](bf(do))
    for g, w in zip(grads, want):
        assert w.dtype == jnp.bfloat16
        err = _rel(_np(g), np.asarray(w, np.float32))
        assert err <= FLASH_TOL, (name, err)


@pytest.mark.parametrize("k,length,strided",
                         [(4, 40, True), (4, 300, False), (2, 17, False),
                          (9, 64, True)])
def test_conv1d_bf16_gradient_matches_jax_ref(k, length, strided):
    rng = np.random.default_rng(k * length)
    d = 24
    xz = _bf16(rng, (2, length, 2 * d if strided else d))
    w, dy = _bf16(rng, (k, d), 0.5), _bf16(rng, (2, length, d))
    tx = torch.from_numpy(xz).bfloat16()[..., :d].requires_grad_() \
        if not strided else None
    txz = torch.from_numpy(xz).bfloat16().requires_grad_()
    x = txz[..., :d] if strided else tx
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    y = tc1.trim_conv1d(x, tw)
    assert type(y.grad_fn).__name__ == "_TrimConv1dFnBackward"
    leaves = (txz if strided else tx, tw)
    gx, gw = torch.autograd.grad(y, leaves, torch.from_numpy(dy).bfloat16())
    assert gx.dtype == gw.dtype == torch.bfloat16
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jx, jw = jax.vjp(jref.depthwise_conv1d, bf(xz[..., :d]), bf(w))[1](bf(dy))
    assert _rel(_np(gw), np.asarray(jw, np.float32)) <= TOL
    assert _rel(_np(gx)[..., :d], np.asarray(jx, np.float32)) <= TOL
    if strided:    # the other half of the in-projection gets zeros
        assert not _np(gx)[..., d:].any()
    # the bf16 route is the f32 sums on the widened values, rounded once
    assert torch.equal(gw, tc1.trim_conv1d_wgrad_plain(
        x.detach().float(), torch.from_numpy(dy), k).bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,length,d,k,tile_l",
                         [(1, 4096, 64, 4, None), (2, 300, 40, 4, None),
                          (3, 17, 5, 9, None), (2, 1000, 16, 3, 8)])
def test_wgrad_plain_within_its_order_bound(b, length, d, k, tile_l, dtype):
    """Each dw element is a chain of ``tile_l`` adds (the run), then
    CONV1D_WGRAD_RUNS (the group) and ``groups`` (the partials), every
    product rounded first, all in f32: within ``(tile_l + runs + groups +
    1) 2^-24 sum|x dy|`` of the exact sum (the first-order bound of
    recursive summation), plus the bf16 route's one rounding, half a bf16
    ulp (2^-8 of the value)."""
    rng = np.random.default_rng(length + k)
    x = _bf16(rng, (b, length, d))
    dy = _bf16(rng, (b, length, d))
    plan = tc1._wgrad_plan(torch.from_numpy(x).to(dtype),
                           torch.from_numpy(dy).to(dtype), k, tile_l)
    got = tc1.trim_conv1d_wgrad_plain(torch.from_numpy(x).to(dtype),
                                      torch.from_numpy(dy).to(dtype), k,
                                      tile_l=tile_l)
    assert got.dtype == dtype and got.shape == (k, d)
    xp = np.pad(x.astype(np.float64), ((0, 0), (k - 1, 0), (0, 0)))
    terms = np.stack([xp[:, i:i + length] * dy for i in range(k)])
    exact, mag = terms.sum((1, 2)), np.abs(terms).sum((1, 2))
    depth = plan.tile_l + conv_plan.CONV1D_WGRAD_RUNS + plan.groups + 1
    bound = depth * 2.0 ** -24 * mag
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * (np.abs(exact) + bound)
    err = np.abs(_np(got).astype(np.float64) - exact)
    assert np.all(err <= bound), float((err / bound).max())


@pytest.mark.parametrize("chunk", [adamw.UPDATE_CHUNK, 7])
def test_in_place_adamw_on_bf16_leaves_equals_the_functional_one(
        chunk, monkeypatch):
    """Bitwise over several steps, f32 and bf16 moments, a bf16 matrix,
    an f32 norm scale and a bf16 3-D leaf; also in flat slices of 7
    elements (ragged last slice), as a leaf larger than UPDATE_CHUNK
    goes."""
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
    rng = np.random.default_rng(1)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10,
                      grad_clip=0.5)

    def tree(scale, dtypes):
        return {name: torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32) * scale).to(dt)
                for name, (shape, dt) in dtypes.items()}

    kinds = {"w": ((6, 5), torch.bfloat16), "norm": ((5,), torch.float32),
             "emb": ((3, 2, 4), torch.bfloat16)}
    for moment in (torch.float32, torch.bfloat16):
        mcfg = AdamWConfig(**{**cfg.__dict__, "moment_dtype": moment})
        p = tree(1.0, kinds)
        p2 = {k: t.clone() for k, t in p.items()}
        m, m2 = adamw.init_moments(p, mcfg), adamw.init_moments(p2, mcfg)
        for step in range(4):
            g = tree(3.0, kinds)
            g2 = {k: t.clone() for k, t in g.items()}
            p, m, met = adamw.apply_updates(p, g, m, step, mcfg)
            met2 = adamw.apply_updates_(p2, g2, m2, torch.tensor(step), mcfg)
            for a, b in zip(adamw.tree_leaves({"p": p, "m": m}),
                            adamw.tree_leaves({"p": p2, "m": m2})):
                assert a.dtype == b.dtype and torch.equal(a, b)
            assert torch.equal(met["grad_norm"], met2["grad_norm"])
        assert p2["w"].dtype == torch.bfloat16
        assert m2["mu"]["w"].dtype == moment
