"""Training parity of the port with the JAX package on the CPU.

Parameters come from the JAX ``init_params`` and reach the port through
``repro_torch.convert``; data is numpy from a seed.  Checked here:

* ``simple_cnn`` (and the depthwise-separable block): the forward, and
  one step's gradients, against ``jax.grad`` of the JAX model on
  ``impl="ref"`` (the JAX weight-grad kernel does not run on this JAX
  version);
* AdamW: five steps on identical params and gradients against
  ``repro.optim.adamw``, moments crossing over through
  ``convert.moments_from_jax``;
* one full ``train_step`` (forward, backward, AdamW) against the JAX
  step;
* the 12-step loss-decrease test of ``tests/test_grad.py`` through the
  port, the trainer CLI, and ``TrimCNN(trainable=True)``.

Tolerance: 1e-5 of max|reference| (f32, summation order only).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro_torch.convert import moments_from_jax, params_from_jax
from repro_torch.core.model import ConvLayer
from repro_torch.launch import train_cnn
from repro_torch.models import layers
from repro_torch.optim import AdamWConfig, adamw

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a per-test temp file: no test reads
    or writes a cache outside it."""
    from repro_torch.core import autotune
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * (float(np.abs(want).max()) + 1e-9), err


def _jax_simple_cnn(seed=0, **kw):
    p = jinit(jlayers.simple_cnn_params(**kw), jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _jax_loss(p, x, y):
    logits = jlayers.simple_cnn_apply(p, x, impl="ref")
    return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None],
                                axis=1).mean()


def _batch(seed, n=4, hw=12, cin=3, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, hw, hw, cin)).astype(np.float32),
            rng.integers(0, classes, size=n))


def test_convert_carries_the_simple_cnn_tree():
    params = _jax_simple_cnn()
    tree = params_from_jax(params)
    assert sorted(tree) == ["conv0", "conv1", "down0", "down1", "dw",
                            "head"]
    for leaf, want in zip(adamw.tree_leaves(tree), jax.tree.leaves(params)):
        assert leaf.dtype == torch.float32 and leaf.is_contiguous()
        np.testing.assert_array_equal(leaf.numpy(), want)
    moments = jax.tree.map(np.asarray, jadamw.init_moments(
        _jnp(params), JAdamWConfig()))
    m = moments_from_jax(moments)
    assert sorted(m) == ["mu", "nu"]
    assert [t.shape for t in adamw.tree_leaves(m["mu"])] == \
        [t.shape for t in adamw.tree_leaves(tree)]


@pytest.mark.parametrize("channels,depthwise", [((8, 16), True),
                                                ((6,), False)])
def test_simple_cnn_forward_and_grads_match_jax(channels, depthwise):
    params = _jax_simple_cnn(channels=channels, depthwise_stage=depthwise)
    x, y = _batch(len(channels))
    loss, grads = jax.value_and_grad(_jax_loss)(
        _jnp(params), jnp.asarray(x), jnp.asarray(y, jnp.int32))
    want_logits = jlayers.simple_cnn_apply(_jnp(params), jnp.asarray(x),
                                           impl="ref")

    tree = params_from_jax(params)
    leaves = [t.requires_grad_() for t in adamw.tree_leaves(tree)]
    logits = layers.simple_cnn_apply(tree, torch.from_numpy(x))
    _close(logits, want_logits)
    got_loss = train_cnn.nll_loss(logits, torch.from_numpy(y))
    _close(got_loss, loss)
    got = torch.autograd.grad(got_loss, leaves)
    for g, want in zip(got, jax.tree.leaves(grads)):
        _close(g, want)


def test_depthwise_separable_block_matches_jax():
    p = jax.tree.map(np.asarray, jinit(
        jlayers.depthwise_separable_params(3, 4, 6), jax.random.PRNGKey(1)))
    x, _ = _batch(5, n=2, hw=9, cin=4)
    want = jlayers.depthwise_separable_apply(_jnp(p), jnp.asarray(x),
                                             stride=2, impl="ref")
    got = layers.depthwise_separable_apply(params_from_jax(p),
                                           torch.from_numpy(x), stride=2)
    _close(got, want)


def test_adamw_five_steps_match_jax():
    """Identical params and gradients; clipping active (|g| > 1), weight
    decay on the matrices only, warmup then cosine."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, decay_steps=8, weight_decay=0.1,
                  grad_clip=1.0)
    jcfg, cfg = JAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    params = _jax_simple_cnn(channels=(4,))
    jp, jm = _jnp(params), jadamw.init_moments(_jnp(params), jcfg)
    p, m = params_from_jax(params), adamw.init_moments(
        params_from_jax(params), cfg)
    rng = np.random.default_rng(3)
    for step in range(5):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        jp, jm, jmet = jadamw.apply_updates(jp, _jnp(g), jm,
                                            jnp.int32(step), jcfg)
        p, m, met = adamw.apply_updates(p, params_from_jax(g), m, step, cfg)
        _close(met["grad_norm"], jmet["grad_norm"])
        _close(met["lr"], jmet["lr"])
    for got, want in zip(adamw.tree_leaves(p), jax.tree.leaves(jp)):
        _close(got, want)
    for key in ("mu", "nu"):
        for got, want in zip(adamw.tree_leaves(m[key]),
                             jax.tree.leaves(jm[key])):
            _close(got, want)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 50, 299, 400])
def test_lr_schedule_matches_jax(step):
    kw = dict(lr=1e-2, warmup_steps=3, decay_steps=300)
    _close(adamw.lr_at(AdamWConfig(**kw), torch.tensor(step)),
           jadamw.lr_at(JAdamWConfig(**kw), jnp.int32(step)))


def test_train_step_matches_the_jax_step():
    """One trainer step (forward, TrIM backward, AdamW) from the same
    params and moments as the JAX example's step; the moments come over
    from JAX mid-run, as after a restart."""
    cfg = train_cnn.OPT
    jcfg = JAdamWConfig(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                        decay_steps=cfg.decay_steps,
                        weight_decay=cfg.weight_decay)
    params = _jax_simple_cnn()
    x, y = _batch(7, n=4, hw=16)
    jp, jm = _jnp(params), jadamw.init_moments(_jnp(params), jcfg)
    for step in range(2):
        loss, grads = jax.value_and_grad(_jax_loss)(
            jp, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        if step == 1:
            p = params_from_jax(jax.tree.map(np.asarray, jp))
            m = moments_from_jax(jax.tree.map(np.asarray, jm))
        jp, jm, _ = jadamw.apply_updates(jp, grads, jm, jnp.int32(step), jcfg)
    p, m, got_loss, _ = train_cnn.train_step(
        p, m, 1, torch.from_numpy(x), torch.from_numpy(y),
        apply_fn=layers.simple_cnn_apply, cfg=cfg)
    _close(got_loss, loss)
    for got, want in zip(adamw.tree_leaves(p), jax.tree.leaves(jp)):
        _close(got, want)


def test_cnn_train_step_decreases_loss():
    """``tests/test_grad.py``'s 12-step miniature of the example, through
    the port: grads flow through stacked strided/depthwise TrIM convs and
    reduce the loss."""
    rng = np.random.default_rng(0)
    templates = rng.standard_normal((4, 12, 12, 3))
    params = params_from_jax(_jax_simple_cnn(channels=(6,), n_classes=4))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=100,
                      weight_decay=0.0)
    moments = adamw.init_moments(params, cfg)
    losses = []
    for i in range(12):
        labels = rng.integers(0, 4, size=8)
        x = torch.from_numpy((templates[labels] + 0.3 * rng.standard_normal(
            (8, 12, 12, 3))).astype(np.float32))
        params, moments, loss, _ = train_cnn.train_step(
            params, moments, i, x, torch.from_numpy(labels),
            apply_fn=layers.simple_cnn_apply, cfg=cfg)
        losses.append(float(loss))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.05, losses


def test_trainer_cli_runs_on_the_cpu_and_writes_json(tmp_path):
    out = tmp_path / "train.json"
    train_cnn.main(["--device", "cpu", "--steps", "12", "--batch", "8",
                    "--json", str(out)])
    rec = json.loads(out.read_text())
    assert rec["steps"] == 12 and rec["device"] == "cpu"
    assert len(rec["losses"]) == 12 and np.isfinite(rec["losses"]).all()
    assert rec["last"] < rec["first"]


def test_trainer_tunes_its_backward_shapes(capsys, monkeypatch):
    """``train_cnn --device cpu --steps 12`` seeds both cotangent records
    of each of the model's five convs before training (the JAX example's
    ``tune_backward_shapes``), and a training step's backward reads them:
    every weight-gradient and input-gradient call gets its record's
    knobs."""
    from repro_torch.core import autotune
    from repro_torch.kernels import ops
    train_cnn.main(["--device", "cpu", "--steps", "12"])
    assert "tuned the backward shapes of 5 convs" in \
        capsys.readouterr().out
    with open(autotune.cache_path()) as f:
        keys = list(json.load(f)["entries"])
    assert sum(k.startswith("conv2d_wgrad:") for k in keys) == 5
    assert sum(k.startswith("conv2d:") for k in keys) == 5
    recs = train_cnn.tune_backward_shapes(4, device="cpu")
    assert list(recs) == ["conv0", "down0", "conv1", "dw", "down1"]
    seen = {"ig": [], "wg": []}
    for name, key in (("ig", "trim_conv2d_input_grad"),
                      ("wg", "trim_conv2d_weight_grad")):
        real = getattr(ops, key)
        monkeypatch.setattr(ops, key, lambda *a, _r=real, _n=name, **kw:
                            seen[_n].append(kw) or _r(*a, **kw))
    params = params_from_jax(_jax_simple_cnn(channels=(8, 16),
                                             n_classes=10))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=100)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    train_cnn.train_step(params, adamw.init_moments(params, cfg), 0, x,
                         torch.arange(4), apply_fn=layers.simple_cnn_apply,
                         cfg=cfg)
    assert len(seen["wg"]) == 5 and len(seen["ig"]) == 4
    assert [kw["tile_go"] for kw in seen["wg"]][::-1] == \
        [r["weight_grad"]["tile_go"] for r in recs.values()]
    assert all(kw["tile_cout"] is not None for kw in seen["ig"])


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        train_cnn.train(steps=1)


def test_trimcnn_trainable_switch():
    topo = [ConvLayer("a", 8, 3, 4, 3, padding=1),
            ConvLayer("b", 4, 4, 6, 3, padding=1)]
    served = layers.TrimCNN.random(topo, n_classes=3, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    model = layers.TrimCNN(topo, served.tree(), trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    x = torch.from_numpy(_batch(2, n=2, hw=8)[0])
    y = torch.tensor([0, 2])
    train_cnn.nll_loss(model(x), y).backward()
    leaves = adamw.tree_leaves(model.tree())
    live = [t.detach().requires_grad_() for t in leaves]
    loss = train_cnn.nll_loss(
        model.apply_tree(adamw.tree_unflatten(model.tree(), live), x), y)
    for p, g in zip(leaves, torch.autograd.grad(loss, live)):
        assert p.grad is not None
        torch.testing.assert_close(p.grad, g, rtol=0, atol=0)
