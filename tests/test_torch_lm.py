"""The port's dense LM against the JAX package on the CPU.

Parameters come from the JAX ``init_params`` and reach the port through
``repro_torch.convert.params_from_jax`` (the LM tree, layouts unchanged),
so both packages compute the same function on the same numpy tokens.

* qwen2.5-3b SMOKE: JAX ``make_prefill_step`` with ``attn_impl="pallas"``
  (interpret mode) against the port with ``"flash"`` (on the CPU the
  flash kernel's plain version), and chunked against chunked, ref against
  ref: logits within 1e-5 * max|logits| and equal next tokens.
* the other dense SMOKE configs (starcoder2: LayerNorm and the gelu MLP
  with biases; llama3; llava: the vision prefix) on ``"ref"`` both sides,
  within 5e-5 * max|logits|.  Both are f32 and differ in summation order
  only, but the JAX initialiser's fan-in (``shape[-2]``: ``wq`` draws with
  std 1/sqrt(heads)) gives attention logits of std ~20 (|s| up to ~60),
  whose 1-ulp differences (~4e-6) move the softmax by as much a layer;
  two layers and the head leave up to ~1e-5, and 5e-5 keeps a margin
  while a wrong layer, mask or layout reads O(1).
* decode steps: KV caches (1e-5 of max|cache|) and tokens equal; the
  port's decode logits against its own flash prefill at every position.
* ``serve_batch``: the same tokens as the JAX ``serve_batch``.
* ``registry.count_params`` equal to JAX's at full width for every dense
  config and seamless-m4t-large-v2 (the encoder-decoder family,
  ``tests/test_torch_encdec.py``), without materialising a parameter.
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
from repro.models import api as japi
from repro.models.base import init_params as jinit
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.distributed import steps
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models.base import init_params

TOL = 1e-5
TOL_REF = 5e-5
DENSE = ["qwen2.5-3b", "starcoder2-3b", "starcoder2-7b", "llama3-405b",
         "llava-next-34b"]
JAX_IMPL = {"flash": "pallas", "chunked": "chunked", "ref": "ref"}
SEQ = 16


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _models(arch, impl="ref"):
    """(jax cfg, jax params as numpy, port cfg, port params)."""
    jcfg = jregistry.get(arch).SMOKE.replace(dtype="float32",
                                             attn_impl=JAX_IMPL[impl])
    jp = jax.tree.map(np.asarray, jinit(japi.params(jcfg),
                                        jax.random.PRNGKey(0)))
    cfg = registry.get(arch).SMOKE.replace(attn_impl=impl)
    return jcfg, jp, cfg, params_from_jax(jp)


def _batch(cfg, b=2, s=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.frontend == "vision":
        batch["vision"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _prefill_both(arch, impl):
    jcfg, jp, cfg, p = _models(arch, impl)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in batch.items()}
    jlogits, jtok = jsteps.make_prefill_step(jcfg, make_rules())(jp, jb)
    logits, tok = steps.make_prefill_step(cfg)(
        p, {k: torch.from_numpy(v) for k, v in batch.items()})
    return (np.asarray(jlogits), np.asarray(jtok)), (logits.numpy(),
                                                     tok.numpy())


@pytest.mark.parametrize("impl", ["flash", "chunked", "ref"])
def test_qwen_prefill_matches_jax(impl):
    (jlogits, jtok), (logits, tok) = _prefill_both("qwen2.5-3b", impl)
    assert logits.shape == (2, SEQ, 128)
    assert _rel_err(logits, jlogits) <= TOL
    np.testing.assert_array_equal(tok, jtok)


@pytest.mark.parametrize("arch", DENSE[1:])
def test_dense_smoke_prefill_matches_jax_ref(arch):
    (jlogits, jtok), (logits, tok) = _prefill_both(arch, "ref")
    assert _rel_err(logits, jlogits) <= TOL_REF
    np.testing.assert_array_equal(tok, jtok)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "starcoder2-3b"])
def test_decode_steps_match_jax(arch):
    jcfg, jp, cfg, p = _models(arch)
    b, max_len, n_steps = 2, 8, 5
    toks = _batch(cfg, b=b, s=n_steps, seed=1)["tokens"]
    jstate = jinit(japi.decode_state(jcfg, b, max_len),
                   jax.random.PRNGKey(0))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, make_rules()))
    state = init_params(api.decode_state(cfg, b, max_len),
                        torch.Generator())
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
            assert _rel_err(state["caches"][key],
                            jstate["caches"][key]) <= TOL


def test_decode_matches_flash_prefill():
    """Token by token through the KV caches gives the logits of the
    full-sequence flash prefill at every position."""
    cfg = registry.get("qwen2.5-3b").SMOKE.replace(attn_impl="flash")
    p = init_params(api.params(cfg), torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batch(cfg, s=12, seed=2)["tokens"])
    logits, _ = steps.make_prefill_step(cfg)(p, {"tokens": toks})
    state = init_params(api.decode_state(cfg, 2, 12), torch.Generator())
    for t in range(12):
        step, state = api.decode(p, {
            "tokens": toks[:, t:t + 1],
            "cache_len": torch.full((2,), t + 1, dtype=torch.int32)},
            state, cfg)
        assert _rel_err(step[:, 0], logits[:, t]) <= TOL


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "starcoder2-3b"])
def test_serve_batch_matches_jax(arch):
    jcfg, jp, cfg, p = _models(arch)
    prompts = _batch(cfg, b=2, s=6, seed=3)["tokens"]
    want = jserve.serve_batch(jcfg, jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(prompts, jnp.int32), 8,
                              make_rules())
    got = serve.serve_batch(cfg, p, torch.from_numpy(prompts), 8)
    assert got.shape == (2, 6 + 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE + ["seamless-m4t-large-v2"])
def test_count_params_matches_jax_at_full_width(arch):
    jcfg = jregistry.get(arch).CONFIG
    cfg = registry.get(arch).CONFIG
    assert registry.count_params(cfg) == jregistry.count_params(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    if arch == "qwen2.5-3b":
        assert registry.count_params(cfg) == 3_397_103_616
    if arch == "seamless-m4t-large-v2":
        assert registry.count_params(cfg) == 1_632_698_368


def test_convert_keeps_the_lm_tree_and_layout():
    _, jp, cfg, p = _models("llava-next-34b")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == sum(1 for _ in _leaves(p))
    for path, leaf in flat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), leaf)
    assert tuple(p["blocks"]["att"]["wq"].shape) == (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd)
    assert tuple(p["blocks"]["att"]["wo"].shape) == (
        cfg.n_layers, cfg.n_heads, cfg.hd, cfg.d_model)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def test_init_keeps_the_jax_fan_in_of_stacked_params():
    """A stacked ``wq`` of shape (L, d, h, hd) draws with std 1/sqrt(h)
    (``shape[-2]``), as the JAX ``init_params`` does."""
    cfg = registry.get("qwen2.5-3b").SMOKE.replace(d_model=256)
    p = init_params(api.params(cfg), torch.Generator().manual_seed(0))
    wq, wk = p["blocks"]["att"]["wq"], p["blocks"]["att"]["wk"]
    assert abs(wq.std().item() * cfg.n_heads ** 0.5 - 1) < 0.03
    assert abs(wk.std().item() * cfg.n_kv_heads ** 0.5 - 1) < 0.03
    assert torch.equal(p["blocks"]["ln_att"]["scale"],
                       torch.ones((cfg.n_layers, cfg.d_model)))


def test_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    want = japi.loss_fn(jnp.asarray(logits), jnp.asarray(labels))
    got = api.loss_fn(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-30b-a3b"])
def test_unported_families_raise_naming_the_roadmap(arch):
    """The two MoE ids, which the port refused naming their ROADMAP item
    until the MoE family was ported, now resolve, with JAX's exact
    parameter count; every id of the JAX package resolves."""
    mod = registry.get(arch)
    assert mod.ARCH_ID == arch and mod.CONFIG.family == "moe"
    assert registry.count_params(mod.CONFIG) == jregistry.count_params(
        jregistry.get(arch).CONFIG)
    assert sorted(registry.archs()) == sorted(jregistry.archs())


def test_config_rejects_what_the_port_does_not_run():
    cfg = registry.get("qwen2.5-3b").CONFIG
    assert cfg.attn_impl == "flash"
    assert registry.get("qwen2.5-3b").SMOKE.attn_impl == "ref"
    assert cfg.replace(dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="2g"):
        cfg.replace(dtype="float16")
    with pytest.raises(ValueError, match="attn_impl"):
        cfg.replace(attn_impl="pallas")
    with pytest.raises(KeyError):
        registry.get("gpt-2")
    assert sorted(registry.archs()) == sorted(
        DENSE + ["falcon-mamba-7b", "recurrentgemma-2b",
                 "seamless-m4t-large-v2", "qwen3-moe-30b-a3b",
                 "phi3.5-moe-42b-a6.6b"])


def test_serve_cli_on_cpu(capsys):
    out = serve.main(["--arch", "starcoder2-3b", "--smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "4",
                      "--gen", "3"])
    assert tuple(out.shape) == (2, 7)
    text = capsys.readouterr().out
    assert "arch=starcoder2-3b generated (2, 7)" in text
    assert "sample:" in text
