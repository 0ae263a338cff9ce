"""The port's bf16 LM inference against the JAX package on the CPU.

Parameters come from JAX's ``init_params(..., jnp.bfloat16)`` and reach
the port through ``repro_torch.convert.params_from_jax`` (bf16 leaves
bit for bit, the f32-pinned norm scales as f32); inputs come from numpy
seeds, rounded to bf16 once by JAX and handed to both packages.

Tolerances:

* the conv1d kernel's plain version against JAX's Pallas ``trim_conv1d``
  in interpret mode: bit for bit (both widen bf16 to f32, where every
  product is exact, sum from 0 in tap order in f32 and round once);
* the flash kernel's plain version against JAX's Pallas
  ``flash_attention`` in interpret mode: 1e-2 of max|o| (both compute in
  f32 and round once to bf16; the f32 sums differ in order, so a value
  near a rounding boundary may land one bf16 ulp, 2^-8 of it, apart);
* mixers, prefill logits and decode caches: 3e-2 of the reference's
  max|.| (DESIGN.md §5's bf16 tolerance).  Beyond summation order, the
  two packages part in three places: JAX's mixers call the per-op-rounded
  ``ref.depthwise_conv1d`` (a bf16 rounding after every product and
  add) where the port's run the ``trim_conv1d`` kernel (f32 sums, one
  rounding), which alone moves a conv output by up to ~2e-2 at these
  widths; XLA's CPU backend may keep bf16 intermediates in f32 between
  elementwise ops where PyTorch rounds each op; and the GEMMs' bf16
  outputs round once from differently ordered f32 sums.  Next tokens
  must be equal wherever JAX's top-2 logit margin exceeds twice the
  tolerance (a closer race is a tie the tolerance cannot resolve).
* recurrentgemma-2b's SMOKE prefill logits: its bf16 function is
  ill-conditioned at these widths.  JAX's own bf16 logits read ~0.17 of
  max|logits| from JAX's f32 run on the same bf16 weights (the third
  block's GeGLU output reaches ~57 while the logits stay ~3, so the
  final RMSNorm and head see bf16 roundings of ~57 / 2^8 on the small
  features), and the port's bf16 run reads 0.125-0.130 from JAX's bf16
  run.  No two bf16 computations of it agree at 3e-2, so there the port
  is held to within ``F32_FACTOR`` (2x) of JAX's own distance from that
  f32 function, with equal next tokens wherever the f32 run's top-2
  margin exceeds twice that distance; its sublayers (rec mixer,
  attention, MLP) are held at 3e-2 like the others'.

Also: the port's ``init_params`` gives every leaf JAX's dtype (the
``Param.dtype`` pins) in all three families' params and decode states,
and an f32 init is the one the port drew before the pins.  bf16
training is held against JAX in ``tests/test_torch_bf16_lm_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.distributed import steps as jsteps
from repro.distributed.sharding import make_rules
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.trim_conv1d import trim_conv1d as jconv1d
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import rglru as jrglru
from repro.models.base import init_params as jinit
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.distributed import steps
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import trim_conv1d as tc1
from repro_torch.models import api, layers, mamba, rglru
from repro_torch.models.base import Param, init_params

TOL = 3e-2
FLASH_TOL = 1e-2
F32_FACTOR = 2.0
ILL_CONDITIONED = ("recurrentgemma-2b",)   # bf16 prefill, module docstring
ARCHS = ["qwen2.5-3b", "falcon-mamba-7b", "recurrentgemma-2b"]
JAX_IMPL = {"flash": "pallas", "ref": "ref"}
SEQ = 24


def _f64(t) -> np.ndarray:
    """A torch tensor or a JAX / numpy array (bf16 included) as float64."""
    if isinstance(t, torch.Tensor):
        return t.double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), dtype=np.float64)


def _rel_err(got, want) -> float:
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16(a: np.ndarray):
    """(JAX bf16 array, the same bits as a torch bf16 tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, params_from_jax(np.asarray(j))


def _models(arch, impl="ref"):
    """(jax cfg, jax bf16 params as numpy, port cfg, port params)."""
    jcfg = jregistry.get(arch).SMOKE.replace(dtype="bfloat16",
                                             attn_impl=JAX_IMPL[impl])
    jp = jax.tree.map(np.asarray, jinit(japi.params(jcfg),
                                        jax.random.PRNGKey(0), jnp.bfloat16))
    cfg = registry.get(arch).SMOKE.replace(dtype="bfloat16", attn_impl=impl)
    return jcfg, jp, cfg, params_from_jax(jp)


def _same_tokens(got, want, ref_logits, tol) -> bool:
    """Equal greedy tokens except where the reference's top two logits
    lie within ``2 * tol * max|logits|`` of each other."""
    ref_logits = _f64(ref_logits)
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    lim = 2 * tol * np.abs(ref_logits).max()
    return bool(((np.asarray(got) == np.asarray(want)) | (margin <= lim))
                .all())


# ---------------------------------------------------------------------------
# The kernels' plain versions against JAX's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,tile_l", [(4, None), (4, 5), (9, None)])
def test_conv1d_plain_equals_jax_kernel_bitwise(k, tile_l):
    rng = np.random.default_rng(k)
    jx, x = _bf16(rng.standard_normal((2, 37, 24)))
    jw, w = _bf16(0.5 * rng.standard_normal((k, 24)))
    want = jconv1d(jx, jw, interpret=True)
    got = tc1.trim_conv1d(x, w, tile_l=tile_l)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    # also through the operator, and the mixer's strided view
    jxz, xz = _bf16(rng.standard_normal((2, 37, 48)))
    np.testing.assert_array_equal(
        ops.depthwise_conv1d(xz[..., :24], w).view(torch.int16).numpy(),
        np.asarray(jconv1d(jxz[..., :24], jw, interpret=True))
        .view(np.int16))
    assert tc1.LAUNCHES == {"trim_conv1d": 0, "trim_conv1d_bf16": 0}


def test_conv1d_decode_step_equals_the_kernel_bitwise():
    """Stepping the bf16 conv window through a sequence gives the bf16
    kernel's output bit for bit (both f32 sums, one rounding)."""
    rng = np.random.default_rng(3)
    _, x = _bf16(rng.standard_normal((2, 11, 16)))
    _, w = _bf16(0.5 * rng.standard_normal((4, 16)))
    full = tc1.trim_conv1d(x, w)
    state = torch.zeros((2, 3, 16), dtype=torch.bfloat16)
    for t in range(11):
        state, y = ops.depthwise_conv1d_step(state, x[:, t], w)
        assert y.dtype == torch.bfloat16 and state.dtype == torch.bfloat16
        assert torch.equal(y, full[:, t])


# (b, lq, lk, hq, hkv, d, causal, soft_cap, window): G 1 and G > 1,
# causal and not, a soft cap, a window, Lq < Lk
FLASH_CASES = [
    (2, 40, 40, 4, 4, 16, True, None, None),
    (1, 33, 70, 8, 2, 16, True, 30.0, None),
    (2, 50, 50, 6, 2, 32, True, None, 16),
    (1, 24, 24, 4, 1, 16, False, None, None),
    (1, 20, 90, 10, 1, 16, True, 30.0, 8),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(i) for i in range(len(FLASH_CASES))])
def test_flash_plain_matches_jax_kernel(case):
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    rng = np.random.default_rng(lq + lk)
    jq, q = _bf16(rng.standard_normal((b, lq, hq, d)))
    jk, k = _bf16(rng.standard_normal((b, lk, hkv, d)))
    jv, v = _bf16(rng.standard_normal((b, lk, hkv, d)))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    want = jflash(jq, jk, jv, interpret=True, **kw)
    got = fa.flash_attention(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel_err(got, want) <= FLASH_TOL
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bf16": 0}


# ---------------------------------------------------------------------------
# Mixers and the attention sublayer, SMOKE widths
# ---------------------------------------------------------------------------

def _x(cfg, seed=0):
    return _bf16(np.random.default_rng(seed).standard_normal(
        (2, SEQ, cfg.d_model)))


def test_mamba_mixer_matches_jax():
    # JAX's mixer runs the per-op-rounded ref conv (module docstring)
    jcfg, jp, cfg, p = _models("falcon-mamba-7b")
    jx, x = _x(cfg)
    jy, _ = jmamba.mixer_apply(jax.tree.map(lambda a: a[0],
                                            jp["blocks"]["mixer"]),
                               jx, jcfg, make_rules())
    pm = {k: v[0] for k, v in p["blocks"]["mixer"].items()}
    y = mamba.mixer_apply(pm, x, cfg)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert _rel_err(y, jy) <= TOL


def test_rec_mixer_matches_jax():
    # JAX's mixer runs the per-op-rounded ref conv (module docstring)
    jcfg, jp, cfg, p = _models("recurrentgemma-2b")
    jx, x = _x(cfg, 1)
    jy, _ = jrglru.rec_mixer_apply(jp["blocks"]["layer_0"]["rec"], jx, jcfg,
                                   make_rules())
    y = rglru.rec_mixer_apply(p["blocks"]["layer_0"]["rec"], x, cfg)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert _rel_err(y, jy) <= TOL


@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b"])
def test_attention_sublayer_matches_jax(arch, impl):
    jcfg, jp, cfg, p = _models(arch, impl)
    jx, x = _x(cfg, 2)
    if arch == "qwen2.5-3b":
        jpa = jax.tree.map(lambda a: a[0], jp["blocks"]["att"])
        pa = {k: v[0] for k, v in p["blocks"]["att"].items()}
    else:
        jpa, pa = (t["blocks"]["layer_2"]["att"] for t in (jp, p))
    jy, _ = jlayers.attention_apply(jpa, jx, jcfg, make_rules(),
                                    positions=jnp.arange(SEQ)[None],
                                    window=jcfg.window)
    y = layers.attention_apply(pa, x, cfg, positions=torch.arange(SEQ)[None],
                               window=cfg.window)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert _rel_err(y, jy) <= TOL


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b"])
def test_mlp_matches_jax(arch):
    jcfg, jp, cfg, p = _models(arch)
    jx, x = _x(cfg, 3)
    if arch == "qwen2.5-3b":
        jpm = jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"])
        pm = {k: v[0] for k, v in p["blocks"]["mlp"].items()}
    else:
        jpm, pm = (t["blocks"]["layer_2"]["mlp"] for t in (jp, p))
    jy = jlayers.mlp_apply(jpm, jx, jcfg, make_rules())
    y = layers.mlp_apply(pm, x, cfg)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert _rel_err(y, jy) <= TOL


# ---------------------------------------------------------------------------
# Prefill and decode through the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,impl", [
    ("qwen2.5-3b", "flash"), ("qwen2.5-3b", "ref"),
    ("falcon-mamba-7b", "ref"),
    ("recurrentgemma-2b", "flash"), ("recurrentgemma-2b", "ref")])
def test_prefill_matches_jax(arch, impl):
    jcfg, jp, cfg, p = _models(arch, impl)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, SEQ))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    jlogits, jtok = jsteps.make_prefill_step(jcfg, make_rules())(jp, jbatch)
    logits, tok = steps.make_prefill_step(cfg)(
        p, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    assert tuple(logits.shape) == (2, SEQ, cfg.vocab)
    if arch not in ILL_CONDITIONED:
        assert _rel_err(logits, jlogits) <= TOL
        assert _same_tokens(tok.numpy(), np.asarray(jtok), jlogits[:, -1],
                            TOL)
        return
    # JAX's f32 function of the same bf16 weights (module docstring)
    jp32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    f32, _ = jsteps.make_prefill_step(jcfg.replace(dtype="float32"),
                                      make_rules())(jp32, jbatch)
    jax_err = _rel_err(jlogits, f32)
    assert _rel_err(logits, f32) <= F32_FACTOR * max(jax_err, TOL)
    assert _same_tokens(tok.numpy(), np.asarray(jtok), f32[:, -1],
                        F32_FACTOR * max(jax_err, TOL))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """10 teacher-forced decode steps on a bf16 state (the ring of
    recurrentgemma-2b's 8-slot SMOKE window wraps): tokens by the margin
    rule, every state leaf within 3e-2 of its max|.|, in JAX's dtype."""
    jcfg, jp, cfg, p = _models(arch)
    b, max_len, n_steps = 2, 12, 10
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (b, n_steps))
    jstate = jinit(japi.decode_state(jcfg, b, max_len),
                   jax.random.PRNGKey(0), jnp.bfloat16)
    state = init_params(api.decode_state(cfg, b, max_len),
                        torch.Generator(), dtype=torch.bfloat16)
    decode = steps.make_decode_step(cfg)
    for t in range(n_steps):
        jbatch = {"tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32),
                  "cache_len": jnp.full((b,), t + 1, jnp.int32)}
        jlogits, jstate = japi.decode(jp, jbatch, jstate, jcfg, make_rules())
        nxt, state = decode(p, state, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]),
            "cache_len": torch.full((b,), t + 1, dtype=torch.int32)})
        assert nxt.dtype == torch.int32
        assert _same_tokens(nxt.numpy(), np.asarray(
            jnp.argmax(jlogits[:, -1], -1)), jlogits[:, -1], TOL)
        jleaves = dict(_leaves(jax.tree.map(np.asarray, jstate)))
        for path, leaf in _leaves(state):
            want = jleaves[path]
            assert str(leaf.dtype).split(".")[-1] == want.dtype.name, path
            if np.abs(_f64(want)).max() > 0:
                assert _rel_err(leaf, want) <= TOL, (t, path)
            else:
                assert not bool(leaf.any()), (t, path)


# ---------------------------------------------------------------------------
# Param.dtype: the pinned leaves
# ---------------------------------------------------------------------------

def _torch_dtype(jdtype) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        jnp.dtype(jdtype).name]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_gives_jax_leaf_dtypes(arch):
    """Every leaf of the params and of the decode state, bf16 init: JAX's
    dtype (norm scales, mamba's ``ssm`` and recurrentgemma's ``h`` f32,
    the rest bf16); an f32 init: all f32."""
    jcfg = jregistry.get(arch).SMOKE.replace(dtype="bfloat16")
    cfg = registry.get(arch).SMOKE.replace(dtype="bfloat16")
    for kind, jdecl, decl in (
            ("params", japi.params(jcfg), api.params(cfg)),
            ("state", japi.decode_state(jcfg, 2, 8),
             api.decode_state(cfg, 2, 8))):
        want = dict(_leaves(jax.eval_shape(
            lambda: jinit(jdecl, jax.random.PRNGKey(0), jnp.bfloat16))))
        got = dict(_leaves(init_params(decl, torch.Generator().manual_seed(0),
                                       dtype=torch.bfloat16)))
        assert got.keys() == want.keys()
        for path, leaf in got.items():
            assert leaf.dtype == _torch_dtype(want[path].dtype), path
            assert tuple(leaf.shape) == want[path].shape, path
        pinned = [path for path, leaf in got.items()
                  if leaf.dtype == torch.float32]
        assert all(path.endswith(("/scale", "/bias", "/ssm", "/h"))
                   for path in pinned), pinned
        # the norms of every family, the scan states of ssm and hybrid
        assert pinned or (arch == "qwen2.5-3b" and kind == "state")
        f32 = init_params(decl, torch.Generator().manual_seed(0))
        assert all(t.dtype == torch.float32 for _, t in _leaves(f32))


def _unpinned(tree):
    """The same declarations without a per-leaf dtype (the port's Param
    before the pins)."""
    if isinstance(tree, Param):
        return dataclasses.replace(tree, dtype=None)
    return {k: _unpinned(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_init_is_unchanged_by_the_pins(arch):
    """With dtype f32 every tensor is the one drawn without the pins, bit
    for bit; a bf16 init draws the same numbers (pinned leaves equal, the
    rest rounded once)."""
    cfg = registry.get(arch).SMOKE
    decl = api.params(cfg)
    f32 = dict(_leaves(init_params(decl, torch.Generator().manual_seed(0))))
    old = dict(_leaves(init_params(_unpinned(decl),
                                   torch.Generator().manual_seed(0))))
    bf16 = dict(_leaves(init_params(decl, torch.Generator().manual_seed(0),
                                    dtype=torch.bfloat16)))
    for path, t in f32.items():
        assert torch.equal(t, old[path]), path
        assert torch.equal(bf16[path], t.to(bf16[path].dtype)), path


def test_config_takes_float32_and_bfloat16_only():
    cfg = registry.get("falcon-mamba-7b").CONFIG
    assert cfg.replace(dtype="bfloat16").dtype == "bfloat16"
    for bad in ("float16", "bf16", "float64"):
        with pytest.raises(ValueError, match="2g"):
            cfg.replace(dtype=bad)
