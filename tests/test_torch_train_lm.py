"""LM training in the port against the JAX package on the CPU.

The train state comes from the JAX ``init_params(train_state_decl(...))``
and reaches the port through ``convert.train_state_from_jax``; batches are
the JAX ``make_batch``'s numpy arrays.  Checked here:

* one train step of ``steps.make_train_step`` against JAX's jitted
  ``make_train_step`` on the qwen2.5-3b SMOKE config: the port on
  ``attn_impl="flash"`` (on the CPU the flash kernels' plain forward and
  backward), with and without remat, JAX on its SMOKE ``"ref"``, with
  ``n_micro`` 1 and 2.  The loss holds 1e-5.  Each leaf is held on its
  own scale:

  - mu and nu within ``TOL_STEP`` = 5e-5 of the leaf's max|JAX|, and the
    grad norm within ``TOL_STEP``.  Why not 1e-5: the JAX initialiser's
    fan-in gives attention logits of std ~20 at these widths, and the
    backward through so peaked a softmax amplifies f32 rounding, so two
    correct f32 paths part by more than 1e-5: JAX's own ``"ref"`` and
    ``"chunked"`` steps differ by up to 2.0e-5 of a leaf's max|mu| or
    max|nu| (``test_jax_paths_part_by_as_much``), the port's from JAX's
    "ref" by up to 3.1e-5;
  - each param's change (new - old) within 1e-5 of the leaf's
    max|JAX change|, plus one ulp of the param (each side rounds its new
    param to f32), where the reference gradient (mu / (1 - b1), the
    clipped gradient of a first step) is not near AdamW's ``eps`` by the
    rule of ``_settled``: a first step moves an element by
    ``lr g / (|g| + eps)``, whose slope ``lr eps / g**2`` turns a
    gradient error ``TOL_STEP max|g|`` into more than 1e-5 of ``lr`` for
    smaller |g|, and takes the sign of rounding where |g| is at the
    gradient's error.  There the change is held within one
    ``lr (1 + wd |p|)`` step of JAX's, what AdamW's first step can
    move at all;
* remat on and off give the same state bit for bit;
* the in-place AdamW (``apply_updates_``) against the functional one,
  bitwise, over several steps;
* ``make_batch`` bit-identical to JAX's for every task and several steps;
  the stream's state and resume;
* ``StragglerWatchdog`` flags what JAX's flags;
* ``launch.train.main --device cpu --smoke``: 3 + 3 steps with a restart
  from the checkpoint equal 6 straight bit for bit, and the final JSON
  line is JAX's object;
* the ssm and hybrid families train a step (``tests/test_torch_train_ssm.py``
  holds them against JAX).

Tolerance: f32 in both packages, sums in another order.
"""

import json

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
from repro.launch.train import StragglerWatchdog as JWatchdog
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.convert import train_state_from_jax
from repro_torch.data import DataConfig, SyntheticStream, make_batch
from repro_torch.distributed import steps
from repro_torch.launch import train
from repro_torch.optim import AdamWConfig, adamw

TOL = 1e-5
TOL_STEP = 5e-5
ARCH = "qwen2.5-3b"
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=50)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * (float(np.abs(want).max()) + 1e-12), err


def _leaf_errs(tree, jtree) -> list:
    """max|port - JAX| of each leaf, of that leaf's max|JAX|."""
    assert len(tree) == len(jtree)
    assert [np.shape(t) for t in tree] == [np.shape(t) for t in jtree]
    return [float(np.abs(np.asarray(t) - w).max()
                  / (np.abs(w).max() + 1e-30)) for t, w in zip(tree, jtree)]


def _settled(g, eps, tol_step=TOL_STEP):
    """Elements whose reference gradient ``g`` is far enough above AdamW's
    ``eps`` for a first step's change to hold TOL: the step moves an
    element by ``lr g / (|g| + eps)``, so a gradient error of ``tol_step``
    x max|g| moves it by ``lr eps tol_step max|g| / g**2``, below TOL x lr
    where ``|g| > sqrt(eps tol_step max|g| / TOL)``."""
    g = np.abs(g)
    return g > np.sqrt(eps * tol_step * g.max() / TOL)


def _check_param_change(old, new, jnew, jmu, cfg, lr, tol_step=TOL_STEP):
    """Each leaf's change held against JAX's (module docstring), the
    gradients' stated error ``tol_step`` x max|g| deciding which elements
    are settled."""
    for i, (p0, got, want, mu) in enumerate(zip(old, new, jnew, jmu)):
        change, jchange = got - p0, want - p0
        err = np.abs(change - jchange)
        ulp = np.spacing(np.maximum(np.abs(p0), np.abs(want)))
        ok = _settled(mu / (1 - cfg.b1), cfg.eps, tol_step)
        scale = np.abs(jchange).max()
        assert np.all((err - ulp)[ok] <= TOL * scale), (
            i, float(((err - ulp)[ok]).max() / scale))
        step = lr * (1 + cfg.weight_decay * np.abs(p0)) + ulp
        assert np.all(err[~ok] <= step[~ok]), i


def _trees(state, jstate):
    """(name, port leaves, JAX leaves) of params, mu and nu."""
    for name, get in (("params", lambda s: s["params"]),
                      ("mu", lambda s: s["opt"]["mu"]),
                      ("nu", lambda s: s["opt"]["nu"])):
        port = [t.detach().numpy() for t in adamw.tree_leaves(get(state))] \
            if state is not None else None
        yield name, port, jax.tree.leaves(get(jstate))


def _jax_state(jcfg):
    st = jinit(jsteps.train_state_decl(jcfg, JAdamWConfig(**OPT)),
               jax.random.PRNGKey(0), jnp.float32)
    return jax.tree.map(np.asarray, st)


def _batch(seed=0, batch=4, seq=17, vocab=128):
    return jmake_batch(JDataConfig(batch=batch, seq=seq, vocab=vocab,
                                   task="copy", seed=seed), 0)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_step(n_micro, impl="ref"):
    jcfg = jregistry.get(ARCH).SMOKE.replace(dtype="float32",
                                             attn_impl=impl)
    jstate = _jax_state(jcfg)
    batch = _batch()
    step = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                          make_rules(), n_micro))
    new, metrics = step(jax.tree.map(jnp.asarray, jstate),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    return jstate, batch, jax.tree.map(np.asarray, new), \
        jax.tree.map(np.asarray, metrics)


def _port_step(jstate, batch, n_micro, remat):
    cfg = registry.get(ARCH).SMOKE.replace(attn_impl="flash", remat=remat)
    state = train_state_from_jax(jstate)
    step = steps.make_train_step(cfg, AdamWConfig(**OPT), n_micro=n_micro)
    return step(state, _torch_batch(batch))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(n_micro, remat):
    jstate, batch, jnew, jmet = _jax_step(n_micro)
    state, metrics = _port_step(jstate, batch, n_micro, remat)
    _close(metrics["loss"], jmet["loss"])
    _close(metrics["grad_norm"], jmet["grad_norm"], TOL_STEP)
    _close(metrics["lr"], jmet["lr"])
    assert int(state["step"]) == int(jnew["step"]) == 1
    trees = {name: (got, want) for name, got, want in _trees(state, jnew)}
    for name in ("mu", "nu"):
        errs = _leaf_errs(*trees[name])
        assert max(errs) <= TOL_STEP, (name, errs)
    _check_param_change(jax.tree.leaves(jstate["params"]), *trees["params"],
                        trees["mu"][1], AdamWConfig(**OPT),
                        float(jmet["lr"]))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_jax_paths_part_by_as_much(n_micro):
    """The spread that sets TOL_STEP: JAX's own "ref" and "chunked"
    steps on the same state and batch differ by more than 1e-5 of some
    leaf's max|mu| or max|nu|, and by less than TOL_STEP in every leaf;
    their param changes agree by the rule the port is held to."""
    jstate, _, jref, jmet = _jax_step(n_micro)
    _, _, jchunked, _ = _jax_step(n_micro, "chunked")
    spread = {name: max(_leaf_errs(c, r)) for (name, _, r), (_, _, c) in
              zip(_trees(None, jref), _trees(None, jchunked))
              if name != "params"}
    assert 1e-5 < max(spread.values()) < TOL_STEP, spread
    _check_param_change(jax.tree.leaves(jstate["params"]),
                        jax.tree.leaves(jchunked["params"]),
                        jax.tree.leaves(jref["params"]),
                        jax.tree.leaves(jref["opt"]["mu"]),
                        AdamWConfig(**OPT), float(jmet["lr"]))


def test_remat_on_and_off_are_bitwise_equal():
    jstate, _, _, _ = _jax_step(1)
    batch = _batch(seed=3)
    out = {}
    for remat in (False, True):
        state, metrics = _port_step(jstate, batch, 1, remat)
        out[remat] = (adamw.tree_leaves(state), metrics)
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(out[False][1][key], out[True][1][key])


def test_in_place_adamw_equals_the_functional_one_bitwise():
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (2, 3, 4)}}

    def tree(scale=1.0):
        return {"a": torch.from_numpy(rng.standard_normal(shapes["a"])
                                      .astype(np.float32) * scale),
                "b": {k: torch.from_numpy(rng.standard_normal(s)
                                          .astype(np.float32) * scale)
                      for k, s in shapes["b"].items()}}

    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10,
                      grad_clip=0.5)
    p = tree()
    p2 = adamw.tree_unflatten(p, [t.clone() for t in adamw.tree_leaves(p)])
    m, m2 = adamw.init_moments(p, cfg), adamw.init_moments(p2, cfg)
    for step in range(6):
        g = tree(scale=3.0)
        g2 = adamw.tree_unflatten(g, [t.clone()
                                      for t in adamw.tree_leaves(g)])
        p, m, met = adamw.apply_updates(p, g, m, step, cfg)
        met2 = adamw.apply_updates_(p2, g2, m2, torch.tensor(step), cfg)
        for a, b in zip(adamw.tree_leaves({"p": p, "m": m}),
                        adamw.tree_leaves({"p": p2, "m": m2})):
            assert torch.equal(a, b)
        assert torch.equal(met["grad_norm"], met2["grad_norm"])
        assert torch.equal(met["lr"], met2["lr"])
    with pytest.raises(ValueError, match="float32"):
        adamw.apply_updates_({"w": torch.zeros(3, dtype=torch.float64)},
                             {"w": torch.zeros(3, dtype=torch.float64)},
                             adamw.init_moments({"w": torch.zeros(3)}, cfg),
                             0, cfg)


@pytest.mark.parametrize("task", ["copy", "arith", "lm"])
def test_make_batch_is_bit_identical_to_jax(task):
    for seq in (16, 17):
        cfg = DataConfig(batch=3, seq=seq, vocab=50, task=task, seed=7)
        jcfg = JDataConfig(batch=3, seq=seq, vocab=50, task=task, seed=7)
        for step in (0, 1, 5, 123):
            got, want = make_batch(cfg, step), jmake_batch(jcfg, step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])


def test_stream_state_resumes():
    cfg = DataConfig(batch=2, seq=9, vocab=20, task="arith", seed=1)
    s = SyntheticStream(cfg)
    first = [next(s) for _ in range(3)]
    assert s.state() == {"seed": 1, "step": 3, "task": "arith"}
    again = SyntheticStream.from_state(cfg, {"step": 1})
    for want in first[1:]:
        got = next(again)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_straggler_watchdog_matches_jax():
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 3.5, 1.2, 10.0, 0.1, 0.4]
    port, jw = train.StragglerWatchdog(), JWatchdog()
    flags = [port.observe(t) for t in times]
    assert flags == [jw.observe(t) for t in times]
    assert port.flagged == jw.flagged == sum(flags) > 0
    assert port.ema == jw.ema
    tight = train.StragglerWatchdog(threshold=1.05)
    assert [tight.observe(t) for t in (1.0, 1.0, 1.2)] == [False, False,
                                                           True]


def _main(tmp, steps, capsys):
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", str(steps), "--batch", "4", "--seq", "17",
                      "--log-every", "1", "--ckpt-dir", str(tmp),
                      "--json", str(tmp / "out.json")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    return out, json.loads(last)


def test_main_resumes_exactly(tmp_path, capsys):
    straight, line = _main(tmp_path / "a", 6, capsys)
    assert line == {"final_loss": straight["final_loss"], "steps": 6,
                    "straggler_flags": straight["straggler_flags"]}
    assert len(straight["losses"]) == 6
    assert all(np.isfinite(straight["losses"]))
    with open(tmp_path / "a" / "out.json") as f:
        assert json.load(f)["losses"] == straight["losses"]
    first, _ = _main(tmp_path / "b", 3, capsys)
    resumed, line = _main(tmp_path / "b", 6, capsys)
    assert first["losses"] + resumed["losses"] == straight["losses"]
    assert line["final_loss"] == straight["final_loss"]
    mgr_a = CheckpointManager(str(tmp_path / "a"))
    mgr_b = CheckpointManager(str(tmp_path / "b"))
    assert mgr_a.latest_step() == mgr_b.latest_step() == 6
    assert mgr_b.all_steps() == [3, 6]
    template = steps.init_train_state(
        registry.get(ARCH).SMOKE, AdamWConfig(), torch.Generator())
    a, man_a = mgr_a.restore(template)
    b, man_b = mgr_b.restore(template)
    assert man_a["data_state"] == man_b["data_state"] == {
        "seed": 0, "step": 6, "task": "copy"}
    for x, y in zip(adamw.tree_leaves(a), adamw.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_ssm_and_hybrid_training_raise(arch):
    """Named for the refusal it replaced: the ssm and hybrid families now
    train.  One ``make_train_step`` step of the SMOKE config (remat) from
    a seeded state gives a finite loss and grad norm and moves every
    param leaf; ``tests/test_torch_train_ssm.py`` holds the step against
    JAX's."""
    cfg = registry.get(arch).SMOKE.replace(remat=True)
    opt = AdamWConfig(**OPT)
    state = steps.init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    before = [t.clone() for t in adamw.tree_leaves(state["params"])]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(DataConfig(
        batch=4, seq=17, vocab=cfg.vocab, task="copy"), 0).items()}
    state, metrics = steps.make_train_step(cfg, opt)(state, batch)
    assert int(state["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    for p0, p1 in zip(before, adamw.tree_leaves(state["params"])):
        assert not torch.equal(p0, p1)


def test_model_parallel_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        train.main(["--smoke", "--device", "cpu", "--model-parallel", "2"])


def test_train_state_from_jax_keeps_the_tree():
    jcfg = jregistry.get(ARCH).SMOKE.replace(dtype="float32")
    jstate = _jax_state(jcfg)
    state = train_state_from_jax(jstate)
    assert set(state) == {"params", "opt", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for tree, jtree in ((state["params"], jstate["params"]),
                        (state["opt"]["mu"], jstate["opt"]["mu"]),
                        (state["opt"]["nu"], jstate["opt"]["nu"])):
        for got, want in zip(adamw.tree_leaves(tree),
                             jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(got.numpy(), want)
    fresh = steps.init_train_state(registry.get(ARCH).SMOKE, AdamWConfig(),
                                   torch.Generator().manual_seed(0))
    assert [t.shape for t in adamw.tree_leaves(fresh)] == \
        [t.shape for t in adamw.tree_leaves(state)]
