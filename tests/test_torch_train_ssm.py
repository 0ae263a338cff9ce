"""ssm and hybrid training in the port against the JAX package on the CPU.

The falcon-mamba-7b and recurrentgemma-2b SMOKE configs: the train state
comes from the JAX ``init_params(train_state_decl(...))`` through
``convert.train_state_from_jax``, the batches are JAX ``make_batch``'s.
The port's temporal conv is ``ops.depthwise_conv1d(impl="trim")``, under
grad ``_TrimConv1dFn`` (on the CPU the kernels' plain versions, forward
and backward); JAX's mixers call ``impl="ref"`` and differentiate it with
XLA.  Checked here:

* the first-step gradient of each leaf against JAX's in float64 (the
  same JAX function under ``jax.enable_x64``): within ``TOL_STEP`` of the
  leaf's max, and no more than ``F64_FACTOR`` times as far from it as
  JAX's own f32 gradient.  At the recurrentgemma-2b SMOKE config JAX's
  f32 gradient reads ~1e-4 of a leaf's max from float64 (the port's
  ~4e-5), more than ``TOL_STEP``, which is why the step below holds that
  family at ``TOL_STEP_HYBRID``;
* one train step of ``steps.make_train_step`` against JAX's jitted
  ``make_train_step``, ``n_micro`` 1 and 2, each leaf held on its own
  scale by ``tests/test_torch_train_lm.py``'s rule: the loss within 1e-5,
  the grad norm within ``TOL_STEP``, each leaf of mu and nu within the
  family's gradient tolerance (``TOL_STEP``; ``TOL_STEP_HYBRID`` for the
  hybrid) of the leaf's max|JAX|, each param's change within 1e-5 of the
  leaf's max|JAX change| where the reference gradient is settled
  (``_settled`` at that tolerance), else within one AdamW step
  ``lr (1 + wd |p|)``;
* remat on and off (each layer checkpointed, and mamba's scan chunks
  under grad in both) give the same state bit for bit;
* ``launch.train.main --smoke --device cpu``: 3 + 3 steps with a restart
  from the checkpoint equal 6 straight bit for bit;
* the train state of both trees (mamba's stacked ``blocks``,
  recurrentgemma's per-layer ``blocks.layer_{i}``) crosses both ways
  with JAX's ``CheckpointManager``, arrays bit for bit.

Tolerance: f32 in both packages, sums in another order (the conv1d
backward's runs and groups against XLA's reductions).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch as jmake_batch
from repro.distributed import steps as jsteps
from repro.distributed.sharding import make_rules
from repro.models import api as japi
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.convert import train_state_from_jax
from repro_torch.distributed import steps
from repro_torch.kernels import trim_conv1d as tc1
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw
from test_torch_train_lm import (TOL, TOL_STEP, _check_param_change,
                                 _leaf_errs, _trees)

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b"]
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=50)
# Two f32 paths each up to ~1e-4 of a leaf's max from float64 at the
# recurrentgemma-2b SMOKE config (test_gradient_against_jax_in_float64)
TOL_STEP_HYBRID = 2e-4
F64_FACTOR = 2.0


def _tol_step(arch):
    return TOL_STEP_HYBRID if arch == "recurrentgemma-2b" else TOL_STEP


def _close(got, want, tol=TOL):
    got = float(got)
    want = float(np.asarray(want))
    assert abs(got - want) <= tol * abs(want), (got, want)


def _jax_state(arch, seed=0):
    jcfg = jregistry.get(arch).SMOKE.replace(dtype="float32")
    st = jinit(jsteps.train_state_decl(jcfg, JAdamWConfig(**OPT)),
               jax.random.PRNGKey(seed), jnp.float32)
    return jax.tree.map(np.asarray, st)


def _batch(seed=0):
    return jmake_batch(JDataConfig(batch=4, seq=17, vocab=128, task="copy",
                                   seed=seed), 0)


def _jax_step(arch, n_micro):
    jcfg = jregistry.get(arch).SMOKE.replace(dtype="float32")
    jstate, batch = _jax_state(arch), _batch()
    step = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                          make_rules(), n_micro))
    new, metrics = step(jax.tree.map(jnp.asarray, jstate),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    return jstate, batch, jax.tree.map(np.asarray, new), \
        jax.tree.map(np.asarray, metrics)


def _port_step(arch, jstate, batch, n_micro, remat):
    cfg = registry.get(arch).SMOKE.replace(remat=remat)
    state = train_state_from_jax(jstate)
    step = steps.make_train_step(cfg, AdamWConfig(**OPT), n_micro=n_micro)
    return step(state, {k: torch.from_numpy(v) for k, v in batch.items()})


def _jax_grads(arch, dtype):
    """JAX's gradient of the loss at the SMOKE state and batch, its params
    and arithmetic in ``dtype``."""
    jcfg = jregistry.get(arch).SMOKE.replace(dtype="float32")
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                          _jax_state(arch)["params"])
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss(p):
        logits, aux = japi.forward(p, batch, jcfg, make_rules())
        return japi.loss_fn(logits, batch["labels"], aux)
    return [np.asarray(g, np.float64)
            for g in jax.tree.leaves(jax.jit(jax.grad(loss))(params))]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_against_jax_in_float64(arch):
    cfg = registry.get(arch).SMOKE.replace(remat=True)
    params = train_state_from_jax(_jax_state(arch))["params"]
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    live = [t.requires_grad_() for t in adamw.tree_leaves(params)]
    logits, aux = api.forward(adamw.tree_unflatten(params, live), batch, cfg)
    grads = torch.autograd.grad(api.loss_fn(logits, batch["labels"], aux),
                                live)
    with jax.enable_x64(True):
        want = _jax_grads(arch, jnp.float64)
    port = _leaf_errs([g.numpy().astype(np.float64) for g in grads], want)
    jax32 = _leaf_errs(_jax_grads(arch, jnp.float32), want)
    assert max(port) <= TOL_STEP, port
    assert max(port) <= F64_FACTOR * max(jax32), (max(port), max(jax32))
    if arch == "recurrentgemma-2b":
        assert TOL_STEP < max(jax32) < TOL_STEP_HYBRID / F64_FACTOR, jax32


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, n_micro):
    jstate, batch, jnew, jmet = _jax_step(arch, n_micro)
    tc1.reset_launch_counts()
    state, metrics = _port_step(arch, jstate, batch, n_micro, remat=True)
    _close(metrics["loss"], jmet["loss"])
    _close(metrics["grad_norm"], jmet["grad_norm"], TOL_STEP)
    _close(metrics["lr"], jmet["lr"])
    assert int(state["step"]) == int(jnew["step"]) == 1
    trees = {name: (got, want) for name, got, want in _trees(state, jnew)}
    for name in ("mu", "nu"):
        errs = _leaf_errs(*trees[name])
        assert max(errs) <= _tol_step(arch), (name, errs)
    _check_param_change(jax.tree.leaves(jstate["params"]), *trees["params"],
                        trees["mu"][1], AdamWConfig(**OPT),
                        float(jmet["lr"]), _tol_step(arch))
    # the CPU runs the plain versions: no kernel launch is counted
    assert set(tc1.LAUNCHES.values()) | set(tc1.BWD_LAUNCHES.values()) == {0}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_are_bitwise_equal(arch):
    jstate, batch = _jax_state(arch, seed=1), _batch(seed=3)
    out = {}
    for remat in (False, True):
        state, metrics = _port_step(arch, jstate, batch, 1, remat)
        out[remat] = (adamw.tree_leaves(state), metrics)
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(out[False][1][key], out[True][1][key])


def _main(arch, tmp, steps_, capsys):
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", str(steps_), "--batch", "4", "--seq", "17",
                      "--log-every", "1", "--ckpt-dir", str(tmp)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    return out, json.loads(last)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_trains_and_resumes_exactly(arch, tmp_path, capsys):
    straight, line = _main(arch, tmp_path / "a", 6, capsys)
    assert line == {"final_loss": straight["final_loss"], "steps": 6,
                    "straggler_flags": straight["straggler_flags"]}
    assert len(straight["losses"]) == 6
    assert np.isfinite(straight["losses"]).all()
    assert np.isfinite(straight["grad_norms"]).all()
    first, _ = _main(arch, tmp_path / "b", 3, capsys)
    resumed, _ = _main(arch, tmp_path / "b", 6, capsys)
    assert first["losses"] + resumed["losses"] == straight["losses"]
    for x, y in zip(adamw.tree_leaves(straight["state"]),
                    adamw.tree_leaves(resumed["state"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_with_jax(arch, tmp_path):
    """A JAX checkpoint of the arch's train state restores in the port,
    and the port's restores in JAX, arrays bit for bit."""
    jstate = _jax_state(arch, seed=2)
    jstate["step"] = np.int32(5)
    meta = {"data_state": {"seed": 0, "step": 5, "task": "copy"}}
    JCheckpointManager(str(tmp_path / "j")).save(5, jstate, meta=meta)
    template = steps.init_train_state(registry.get(arch).SMOKE,
                                      AdamWConfig(**OPT), torch.Generator())
    state, manifest = CheckpointManager(str(tmp_path / "j")).restore(
        template)
    assert manifest["step"] == 5 and int(state["step"]) == 5
    leaves, jleaves = adamw.tree_leaves(state), jax.tree.leaves(jstate)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for t in adamw.tree_leaves(state["params"]):
        t.add_(1.0)
    CheckpointManager(str(tmp_path / "p")).save(6, state, meta=meta)
    back, manifest = JCheckpointManager(str(tmp_path / "p")).restore(
        jax.tree.map(jnp.asarray, jstate))
    assert manifest["step"] == 6
    for want, got in zip(adamw.tree_leaves(state), jax.tree.leaves(back)):
        assert np.asarray(got).dtype == want.numpy().dtype
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
