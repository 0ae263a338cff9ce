"""The port's checkpoints: the counterparts of ``tests/test_checkpoint.py``
(atomic publish, garbage collection, exact crash-resume, the sha256
sidecar against bit-flips, truncation and a tampered manifest, the legacy
warning, a crash before the publish) on ``repro_torch.checkpoint``, and
checkpoints crossing between the packages: one written by the JAX
``CheckpointManager`` restores in the port, and one written by the port
restores in JAX, arrays bit for bit and manifests equal.  The elastic
restore onto a new mesh has no counterpart on one card (ROADMAP Queue 1
item 9).  Corruption is made with the JAX package's file helpers
(``repro.testing.faults``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.distributed import steps as jsteps
from repro.models import ModelConfig as JModelConfig
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro.testing import faults
from repro_torch.checkpoint import (CheckpointCorruptError,
                                    CheckpointManager, manager)
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.distributed import steps
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw

# tests/test_checkpoint.py's config and optimiser
CFG = ModelConfig(family="dense", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=1, d_ff=64, vocab=64, attn_impl="ref",
                  remat=False)
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)


def _state(seed=0):
    return steps.init_train_state(CFG, OPT,
                                  torch.Generator().manual_seed(seed))


def _train(state, step_fn, stream, n):
    for _ in range(n):
        batch = {k: torch.from_numpy(v) for k, v in next(stream).items()}
        state, m = step_fn(state, batch)
    return state, m


def _equal_trees(a, b):
    la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _step_file(tmp_path, step, name):
    return os.path.join(str(tmp_path), f"step_{step:08d}", name)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = _state()
    mgr.save(7, state, meta={"data_state": {"seed": 1, "step": 7}})
    restored, manifest = mgr.restore(_state(seed=99))
    assert manifest["step"] == 7
    assert manifest["data_state"]["step"] == 7
    _equal_trees(state, restored)
    assert restored["step"].dtype == torch.int32


def test_atomic_publish_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = {"w": torch.arange(4.0)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    # a stale .tmp dir (simulated crash) is ignored by restore
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert mgr.latest_step() == 4
    assert CheckpointManager(str(tmp_path / "empty")).restore(state) == (
        None, None)


def test_crash_resume_training_is_exact(tmp_path):
    """Train 6 steps; 'crash' after 3; resume from the checkpoint and data
    state -> a final state bitwise equal to the uninterrupted run's."""
    dc = DataConfig(batch=4, seq=16, vocab=64, task="copy", seed=5)
    step_fn = steps.make_train_step(CFG, OPT)

    s_full, _ = _train(_state(), step_fn, SyntheticStream(dc), 6)

    mgr = CheckpointManager(str(tmp_path))
    stream = SyntheticStream(dc)
    s_a, _ = _train(_state(), step_fn, stream, 3)
    mgr.save(3, s_a, meta={"data_state": stream.state()})
    del s_a                                 # crash

    s_b, manifest = mgr.restore(_state(seed=99))
    stream_b = SyntheticStream.from_state(dc, manifest["data_state"])
    s_b, _ = _train(s_b, step_fn, stream_b, 3)
    _equal_trees(s_full, s_b)
    assert int(s_b["step"]) == 6


def test_save_writes_sha256_sidecar(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(8.0)})
    with open(_step_file(tmp_path, 1, "sha256.json")) as f:
        digests = json.load(f)
    assert set(digests) == {"arrays.npz", "manifest.json"}
    assert all(len(d) == 64 for d in digests.values())
    restored, _ = mgr.restore({"w": torch.zeros(8)})
    assert torch.equal(restored["w"], torch.arange(8.0))


def test_bitflip_raises_checkpoint_corrupt_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    template = {"w": torch.arange(64.0)}
    mgr.save(1, template)
    faults.flip_byte(_step_file(tmp_path, 1, "arrays.npz"))
    with pytest.raises(CheckpointCorruptError, match="sha256 mismatch"):
        mgr.restore(template)
    # verify=False skips the integrity check (salvage): whether the load
    # then succeeds depends on where the flip landed, but it must not be
    # an integrity error
    try:
        mgr.restore(template, verify=False)
    except CheckpointCorruptError:                # pragma: no cover
        pytest.fail("verify=False must skip the integrity check")
    except Exception:
        pass                                      # npz CRC may still balk


def test_truncation_raises_checkpoint_corrupt_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    template = {"w": torch.arange(64.0), "b": torch.ones((16, 16))}
    mgr.save(3, template)
    faults.truncate_file(_step_file(tmp_path, 3, "arrays.npz"), 0.5)
    with pytest.raises(CheckpointCorruptError, match="sha256 mismatch"):
        mgr.restore(template)


def test_manifest_tamper_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(4.0)}, meta={"lr": 1e-3})
    mpath = _step_file(tmp_path, 1, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["lr"] = 99.0                         # hand edit
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointCorruptError, match="manifest.json"):
        mgr.restore({"w": torch.arange(4.0)})
    _, got = mgr.restore({"w": torch.arange(4.0)}, verify=False)
    assert got["lr"] == 99.0


def test_legacy_checkpoint_without_sidecar_warns_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"w": torch.arange(4.0)})
    os.remove(_step_file(tmp_path, 2, "sha256.json"))  # pre-sidecar era
    with pytest.warns(RuntimeWarning, match="unverified"):
        restored, _ = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.arange(4.0))


def test_crash_before_publish_keeps_previous_step_restorable(tmp_path,
                                                             monkeypatch):
    """A crash between the temp write and the atomic rename leaves the
    previous published step as the (verified) latest."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})

    def crash(src, dst):
        raise faults.InjectedCrash("checkpoint: crashed before publish")

    with monkeypatch.context() as m:
        m.setattr(manager, "_publish", crash)
        with pytest.raises(faults.InjectedCrash):
            mgr.save(2, {"w": torch.ones(4)})
    assert mgr.latest_step() == 1                 # step 2 never published
    restored, manifest = mgr.restore({"w": torch.ones(4)})
    assert manifest["step"] == 1
    assert torch.equal(restored["w"], torch.zeros(4))
    mgr.save(2, {"w": torch.ones(4)})             # retries cleanly
    assert mgr.latest_step() == 2


def _jax_state():
    jcfg = JModelConfig(family="dense", n_layers=2, d_model=32, n_heads=2,
                        n_kv_heads=1, d_ff=64, vocab=64, attn_impl="ref",
                        remat=False)
    jopt = JAdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    return jinit(jsteps.train_state_decl(jcfg, jopt),
                 jax.random.PRNGKey(3), jnp.float32)


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jstate["step"] = jnp.int32(4)
    meta = {"data_state": {"seed": 5, "step": 4, "task": "copy"},
            "arch": "test"}
    JCheckpointManager(str(tmp_path)).save(4, jstate, meta=meta)
    state, manifest = CheckpointManager(str(tmp_path)).restore(_state())
    assert manifest["step"] == 4 and manifest["data_state"] == meta[
        "data_state"]
    assert int(state["step"]) == 4 and state["step"].dtype == torch.int32
    for got, want in zip(adamw.tree_leaves(state), jax.tree.leaves(jstate)):
        assert got.dtype == torch.float32 or got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    state = _state(seed=4)
    state["step"] = torch.tensor(9, dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(
        9, state, meta={"data_state": {"seed": 0, "step": 9}})
    jstate, manifest = JCheckpointManager(str(tmp_path)).restore(
        _jax_state())
    assert manifest["step"] == 9 and manifest["data_state"]["step"] == 9
    for want, got in zip(adamw.tree_leaves(state), jax.tree.leaves(jstate)):
        assert np.asarray(got).dtype == want.numpy().dtype
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_restore_puts_arrays_on_the_template_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.arange(3), "b": {"c": torch.ones(2, 2)}})
    restored, _ = mgr.restore({"a": torch.zeros(3, device="meta"),
                               "b": {"c": torch.zeros(2, 2)}})
    assert restored["a"].device.type == "meta"
    assert restored["a"].dtype == torch.int64
    assert torch.equal(restored["b"]["c"], torch.ones(2, 2))
