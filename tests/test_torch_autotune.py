"""The port's conv autotuner (``repro_torch/core/autotune.py``): the cases
of ``tests/test_autotune.py`` on the port, less the sharded and hillclimb
ones, plus what is the port's own.

* the cache: round trip, atomic store, quarantine, wrong version, one
  warning per bad record, records the planner refuses, concurrent stores
  and concurrent prewarms across processes;
* keys: the namespaces never alias, a CPU record never feeds a ``cuda:``
  key (nor one card's another's), the JAX package's cache is never read;
* search: the model's winner is ``ConvPlan.build``'s default plan on
  every VGG-16 and AlexNet layer at batch 1, 2, 4 and 8, f32 and int8;
  a measured tune on the CPU (the plain version's time);
* the consult sites: ``ops.conv2d``, the int8 route, the backward,
  packed weights, ``FusedGroupPlan.build(use_autotune_cache=True)``; K > 8
  never consults; after a model-only prewarm every layer runs the
  no-cache plan;
* parity: a JAX ``cnn_pack_params`` tree of VGG-16/16 at 32x32 through
  ``params_from_jax`` against JAX's packed forward (1e-5).

Every test points ``REPRO_TORCH_CONVTUNE_CACHE`` at its own temp file.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import netplan as jnetplan
from repro.core.model import ConvLayer as JConvLayer
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro.testing import faults
from repro_torch.convert import params_from_jax
from repro_torch.core import autotune, fuse_plan
from repro_torch.core.conv_plan import (SMEM_PER_BLOCK, ConvPlan,
                                        WeightGradPlan, input_grad_geometry)
from repro_torch.core.fuse_plan import FusedGroupPlan, build_group
from repro_torch.core.model import ConvLayer, alexnet_layers, vgg16_layers
from repro_torch.core.netplan import (infer_pools, network_layers,
                                      scale_layers)
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

ROOT = os.path.join(os.path.dirname(__file__), "..")
RNG = np.random.default_rng(5)
CPU = "cpu"
X_SHAPE = (1, 16, 16, 8)
W_SHAPE = (3, 3, 8, 12)
SAME = ((1, 1), (1, 1))


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's cache in a per-test temp file."""
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    monkeypatch.delenv(autotune.AUTOTUNE_ENV, raising=False)
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _spy(monkeypatch, module, name):
    """Record the keyword arguments of each call of ``module.name``."""
    seen, real = [], getattr(module, name)

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(module, name, spy)
    return seen


# ---------------------------------------------------------------------------
# Cache round trip, atomic store, robustness
# ---------------------------------------------------------------------------

def test_tune_round_trip_is_deterministic():
    rec1 = autotune.tune(X_SHAPE, W_SHAPE, device=CPU)
    rec2 = autotune.tune(X_SHAPE, W_SHAPE, device=CPU)
    assert rec1 == rec2
    key = autotune.make_key(X_SHAPE, W_SHAPE, device=CPU)
    assert autotune.lookup(key) == rec1
    autotune.reset_memory_cache()              # read back from the file
    assert autotune.lookup(key) == rec1
    with open(autotune.cache_path()) as f:
        data = json.load(f)
    assert data["version"] == 1
    assert data["entries"][key]["tile_cout"] == rec1["tile_cout"]
    assert rec1["dataflow"] in autotune.DATAFLOWS
    assert rec1["source"] == "model" and rec1["measured_us"] is None
    assert key.startswith("conv2d:") and key.endswith(":float32:cpu")


def test_store_overwrites_and_persists_atomically(monkeypatch):
    key = "conv2d:test"
    autotune.store(key, dict(tile_h=4, tile_cout=8, dataflow="carry"))
    autotune.store(key, dict(tile_h=8, tile_cout=8, dataflow="halo"))
    autotune.reset_memory_cache()
    assert autotune.lookup(key)["tile_h"] == 8
    folder = os.path.dirname(autotune.cache_path())
    assert not [f for f in os.listdir(folder) if ".tmp" in f]
    # a crash before the publish leaves the old cache and no temp file
    before = open(autotune.cache_path()).read()

    def crash(src, dst):
        raise RuntimeError("crash before publish")
    monkeypatch.setattr(autotune, "_publish", crash)
    with pytest.raises(RuntimeError, match="crash"):
        autotune.store(key, dict(tile_h=2, tile_cout=8, dataflow="carry"))
    assert open(autotune.cache_path()).read() == before
    assert not [f for f in os.listdir(folder) if ".tmp" in f]


def test_lookup_missing_cache_returns_none():
    assert autotune.lookup("conv2d:absent") is None
    assert autotune.knobs_for(X_SHAPE, W_SHAPE, device=CPU) is None


def test_knobs_for_validates_records_and_env_kill_switch(monkeypatch):
    key = autotune.make_key(X_SHAPE, W_SHAPE, stride=2, device=CPU)
    # tile_h not a multiple of the stride: rejected, not crashed
    autotune.store(key, dict(tile_h=3, tile_cout=8, dataflow="carry"))
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert autotune.knobs_for(X_SHAPE, W_SHAPE, stride=2,
                                  device=CPU) is None
    autotune.store(key, dict(tile_h=4, tile_cout=8, dataflow="halo"))
    assert autotune.knobs_for(X_SHAPE, W_SHAPE, stride=2,
                              device=CPU)["tile_h"] == 4
    monkeypatch.setenv(autotune.AUTOTUNE_ENV, "0")
    assert autotune.knobs_for(X_SHAPE, W_SHAPE, stride=2,
                              device=CPU) is None


_STRESS_WORKER = r"""
import sys
from repro_torch.core import autotune
path, wid, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
for i in range(n):
    autotune.store(f"conv2d:w{wid}:e{i}",
                   dict(tile_h=4, tile_cout=8, dataflow="carry",
                        worker=wid, i=i), path)
print("done", wid)
"""


def _workers(script, args_list):
    env = dict(os.environ, PYTHONPATH="src")
    procs = [subprocess.Popen([sys.executable, "-c", script, *args],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in args_list]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err


def test_concurrent_store_loses_no_entries(tmp_path):
    """4 processes storing into one cache path keep every entry: the
    .lock sidecar and the read-merge-replace store."""
    n_proc, n_entries = 4, 30
    path = str(tmp_path / "shared.json")
    _workers(_STRESS_WORKER, [(path, str(w), str(n_entries))
                              for w in range(n_proc)])
    with open(path) as f:
        entries = json.load(f)["entries"]
    want = {f"conv2d:w{w}:e{i}" for w in range(n_proc)
            for i in range(n_entries)}
    assert not want - set(entries)
    assert entries["conv2d:w0:e0"]["worker"] == 0


@pytest.mark.parametrize("mode", ["truncate", "garbage", "wrong_version",
                                  "empty"])
def test_corrupt_cache_is_quarantined_not_reset(tmp_path, mode):
    path = str(tmp_path / "c.json")
    autotune.store("conv2d:x", dict(tile_h=4, tile_cout=8,
                                    dataflow="carry"), path)
    faults.corrupt_cache(path, mode)
    autotune.reset_memory_cache()
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert autotune.lookup("conv2d:x", path) is None
    assert len([f for f in tmp_path.iterdir()
                if ".corrupt-" in f.name]) == 1
    assert not os.path.exists(path)
    autotune.reset_memory_cache()
    autotune.store("conv2d:y", dict(tile_h=2, tile_cout=4,
                                    dataflow="halo"), path)
    autotune.reset_memory_cache()
    assert autotune.lookup("conv2d:y", path)["tile_h"] == 2


def test_wrong_version_quarantine_names_the_version(tmp_path):
    path = str(tmp_path / "c.json")
    with open(path, "w") as f:
        json.dump({"version": 999, "entries": {"k": {}}}, f)
    with pytest.warns(RuntimeWarning, match="999"):
        assert autotune.lookup("k", path) is None
    (q,) = [f for f in tmp_path.iterdir() if ".corrupt-" in f.name]
    with open(q) as f:
        assert json.load(f)["version"] == 999


def test_missing_cache_file_is_not_quarantine(tmp_path, recwarn):
    path = str(tmp_path / "nonexistent.json")
    assert autotune.lookup("k", path) is None
    assert not [w for w in recwarn.list if "quarantined" in str(w.message)]
    assert not list(tmp_path.iterdir())


def test_malformed_record_warns_once_and_misses():
    key = autotune.make_key(X_SHAPE, W_SHAPE, pad=SAME, device=CPU)
    autotune.store(key, dict(tile_cout=8, dataflow="carry"))   # no tile_h
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert autotune.knobs_for(X_SHAPE, W_SHAPE, pad=SAME,
                                  device=CPU) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert autotune.knobs_for(X_SHAPE, W_SHAPE, pad=SAME,
                                  device=CPU) is None
        # ops.conv2d runs the default plan instead of crashing
        x = _t(RNG.standard_normal(X_SHAPE))
        w = _t(RNG.standard_normal(W_SHAPE) * .3)
        _close(ops.conv2d(x, w), ref.conv2d(x, w))


def test_geometry_insane_record_is_rejected():
    """Structurally valid knobs ``ConvPlan.build`` refuses for the problem
    (a C_out tile past 128, a strip whose window cannot fit shared
    memory) are a miss and a warning, not a crash in the kernel."""
    xs, ws = (1, 64, 64, 512), (3, 3, 512, 512)
    key = autotune.make_key(xs, ws, pad=SAME, device=CPU)
    for rec in (dict(tile_h=4, tile_cout=200, dataflow="carry"),
                dict(tile_h=64, tile_cout=32, dataflow="halo")):
        autotune.store(key, rec)
        autotune.reset_memory_cache()
        with pytest.warns(RuntimeWarning, match="infeasible"):
            assert autotune.knobs_for(xs, ws, pad=SAME, device=CPU) is None
    with pytest.raises(ValueError):
        ConvPlan.build(xs, ws, pad=SAME, tile_h=64, tile_cout=32)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def test_namespaces_never_alias():
    """conv2d:, conv2d_q8:, conv2d_wgrad: and conv2d_fused: keys of one
    geometry are distinct, and dtype is part of every key; writing one
    never shadows another."""
    keys = {op: autotune.make_key(X_SHAPE, W_SHAPE, op=op, device=CPU,
                                  dtype="int8" if op == "conv2d_q8"
                                  else "float32")
            for op in ("conv2d", "conv2d_q8", "conv2d_wgrad")}
    g = build_group(alexnet_layers()[1:3], 0)
    keys["fused"] = autotune.fused_key(g.signature, device=CPU)
    assert len(set(keys.values())) == 4
    for op, key in keys.items():
        assert key.startswith(op if op != "fused" else "conv2d_fused:d2:")
    for op in ("conv2d", "conv2d_q8", "conv2d_wgrad"):
        assert autotune.make_key(X_SHAPE, W_SHAPE, op=op, dtype="int8",
                                 device=CPU) \
            != autotune.make_key(X_SHAPE, W_SHAPE, op=op, device=CPU)
    # the pads are part of the problem
    assert autotune.make_key(X_SHAPE, W_SHAPE, pad=SAME, device=CPU) \
        != autotune.make_key(X_SHAPE, W_SHAPE, device=CPU)
    autotune.store(keys["conv2d_q8"], dict(tile_h=4, tile_cout=8,
                                           dataflow="halo"))
    assert autotune.knobs_for(X_SHAPE, W_SHAPE, device=CPU) is None
    got = autotune.knobs_for(X_SHAPE, W_SHAPE, dtype="int8", device=CPU,
                             op="conv2d_q8")
    assert (got["tile_h"], got["dataflow"]) == (4, "halo")
    autotune.store(keys["conv2d"], dict(tile_h=8, tile_cout=12,
                                        dataflow="carry"))
    got = autotune.knobs_for(X_SHAPE, W_SHAPE, dtype="int8", device=CPU,
                             op="conv2d_q8")
    assert (got["tile_h"], got["dataflow"]) == (4, "halo")
    assert autotune.weight_grad_knobs_for(X_SHAPE, W_SHAPE,
                                          device=CPU) is None
    assert autotune.fused_knobs_for(g.signature, device=CPU) is None


def _fake_card(monkeypatch, cc=(9, 0), name="NVIDIA H100 80GB HBM3"):
    autotune._cuda_backend.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=None: cc)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: name)


def test_cpu_record_never_feeds_a_cuda_key(monkeypatch):
    """The key's backend is the tensors' device: a record tuned on the
    CPU is not one of the card's, and a record of one card is not
    another's."""
    autotune.tune(X_SHAPE, W_SHAPE, device=CPU)
    _fake_card(monkeypatch)
    try:
        key = autotune.make_key(X_SHAPE, W_SHAPE, device="cuda")
        assert key.endswith(":float32:cuda:sm90:NVIDIA_H100_80GB_HBM3")
        assert autotune.make_key(X_SHAPE, W_SHAPE, device="cuda:0") == key
        assert autotune.knobs_for(X_SHAPE, W_SHAPE, device="cuda") is None
        autotune.store(key, dict(tile_h=4, tile_cout=8, dataflow="halo"))
        assert autotune.knobs_for(X_SHAPE, W_SHAPE,
                                  device="cuda")["dataflow"] == "halo"
        assert autotune.knobs_for(X_SHAPE, W_SHAPE,
                                  device=CPU)["dataflow"] == "carry"
        _fake_card(monkeypatch, (8, 0), "NVIDIA A100-SXM4-80GB")
        assert autotune.knobs_for(X_SHAPE, W_SHAPE, device="cuda") is None
    finally:
        autotune._cuda_backend.cache_clear()


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        autotune.make_key(X_SHAPE, W_SHAPE)
    with pytest.raises(RuntimeError, match="GPU"):
        autotune.tune(X_SHAPE, W_SHAPE, measure=True, write=False)


def test_jax_cache_is_never_read(tmp_path, monkeypatch):
    """The JAX package's env, file and kill switch mean nothing to the
    port, and the port writes nothing into the JAX cache."""
    jpath = str(tmp_path / "jax_convtune.json")
    monkeypatch.setenv(jautotune.CACHE_ENV, jpath)
    jautotune.reset_memory_cache()
    jautotune.tune(X_SHAPE, W_SHAPE, backend="cpu")
    before = open(jpath).read()
    assert autotune.CACHE_ENV != jautotune.CACHE_ENV
    assert autotune.AUTOTUNE_ENV != jautotune.AUTOTUNE_ENV
    assert autotune.cache_path() != jpath
    monkeypatch.delenv(autotune.CACHE_ENV)
    assert autotune.cache_path() != jautotune.cache_path()
    assert os.path.join(".cache", "repro_torch") in autotune.cache_path()
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "port.json"))
    assert autotune.knobs_for(X_SHAPE, W_SHAPE, device=CPU) is None
    monkeypatch.setenv(jautotune.AUTOTUNE_ENV, "0")
    rec = autotune.tune(X_SHAPE, W_SHAPE, device=CPU)
    assert autotune.knobs_for(X_SHAPE, W_SHAPE, device=CPU) == rec
    assert open(jpath).read() == before
    jautotune.reset_memory_cache()


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def test_candidates_cover_both_dataflows_and_fit_smem():
    cands = autotune.candidate_knobs(X_SHAPE, W_SHAPE, pad=SAME)
    plans = [p for _, p in cands]
    assert {p.dataflow for p in plans} == set(autotune.DATAFLOWS)
    assert all(p.smem_bytes <= SMEM_PER_BLOCK for p in plans)
    assert plans[0] == ConvPlan.build(X_SHAPE, W_SHAPE, pad=SAME)
    assert len(set(plans)) == len(plans)
    # the full-height strip (one strip a band) is a candidate
    assert any(p.n_strips == 1 for p in plans)
    # every candidate's knobs replay to it
    for knobs, p in cands:
        assert ConvPlan.build(X_SHAPE, W_SHAPE, pad=SAME, **knobs) == p


def _layer_cases():
    return [(net, l.name, n, dtype)
            for net, layers_ in (("vgg16", vgg16_layers()),
                                 ("alexnet", alexnet_layers()))
            for l in layers_ if l.kernel <= 8
            for n in (1, 2, 4, 8) for dtype in ("float32", "int8")]


def _layer(net, name):
    return next(l for l in network_layers(net) if l.name == name)


@pytest.mark.parametrize("net,name,n,dtype", _layer_cases())
def test_model_winner_is_the_default_plan(net, name, n, dtype):
    """The model's ranking is the planner's objective: its winner, and
    what its record's knobs replay to, is ``ConvPlan.build``'s plan with
    no knobs (dataflow carry), so a model-only sweep moves no plan."""
    layer = _layer(net, name)
    xs, pads, ws = autotune.layer_problem(layer, n=n)
    rec = autotune.tune(xs, ws, stride=layer.stride, pad=pads,
                        groups=layer.groups, dtype=dtype, device=CPU,
                        write=False)
    kw = dict(stride=layer.stride, pad=pads, groups=layer.groups,
              dtype_bytes=autotune.DTYPE_BYTES[dtype])
    default = ConvPlan.build(xs, ws, **kw)
    assert rec["dataflow"] == "carry"
    assert ConvPlan.build(xs, ws, tile_h=rec["tile_h"],
                          tile_cout=rec["tile_cout"],
                          dataflow=rec["dataflow"], **kw) == default
    assert (rec["tile_w"], rec["blocks"]) == (default.tile_w,
                                              default.blocks)


def test_measured_tune_records_its_time():
    rec = autotune.tune((1, 8, 8, 4), (3, 3, 4, 4), pad=1, measure=True,
                        measure_top_k=2, write=False, device=CPU)
    assert rec["source"] == "measured" and rec["measured_us"] > 0
    q8 = autotune.tune((1, 8, 8, 16), (3, 3, 16, 32), pad=1, dtype="int8",
                       measure=True, measure_top_k=3, device=CPU)
    assert q8["source"] == "measured" and q8["measured_us"] > 0
    key = autotune.make_key((1, 8, 8, 16), (3, 3, 16, 32), pad=1,
                            dtype="int8", device=CPU, op="conv2d_q8")
    assert autotune.lookup(key) == q8


def test_weight_grad_candidates_and_model_winner():
    """The wgrad model's winner is ``WeightGradPlan.build``'s chunk
    height, on the GEMM and the depthwise routes."""
    for xs, ws, g in ((X_SHAPE, W_SHAPE, 1), ((8, 56, 56, 128),
                                               (3, 3, 128, 256), 1),
                      ((4, 28, 28, 16), (3, 3, 1, 16), 16)):
        plans = autotune.candidate_weight_grad_knobs(xs, ws, pad=SAME,
                                                     groups=g)
        assert plans[0] == WeightGradPlan.build(xs, ws, pad=SAME, groups=g)
        assert any(p.chunks == 1 for p in plans)
        rec = autotune.tune_weight_grad(xs, ws, pad=SAME, groups=g,
                                        device=CPU, write=False)
        assert rec["tile_go"] == plans[0].tile_go
        assert rec["source"] == "model"


def test_unported_sweeps_name_their_queue_items():
    with pytest.raises(NotImplementedError, match="item 9"):
        autotune.tune_sharded(X_SHAPE, W_SHAPE, spatial_shards=4)
    # tune_graph is ported (the DAG topologies, Queue 1 item 2): it sweeps
    # ResNet-18's 20 conv nodes instead of naming the item
    recs = autotune.tune_graph("resnet18", device=CPU, write=False)
    assert len(recs["layers"]) == 20 and "fused" not in recs


# ---------------------------------------------------------------------------
# The consult sites
# ---------------------------------------------------------------------------

def test_conv2d_uses_cached_knobs(monkeypatch):
    x = _t(RNG.standard_normal((1, 14, 14, 8)))
    w = _t(RNG.standard_normal(W_SHAPE) * .3)
    # the key holds the unpadded input and the 'same' pads
    autotune.store(autotune.make_key((1, 14, 14, 8), W_SHAPE, pad=SAME,
                                     device=CPU),
                   dict(tile_h=6, tile_cout=4, dataflow="halo"))
    seen = _spy(monkeypatch, ops, "trim_conv2d")
    got = ops.conv2d(x, w)
    assert (seen[-1]["tile_h"], seen[-1]["tile_cout"],
            seen[-1]["dataflow"]) == (6, 4, "halo")
    _close(got, ref.conv2d(x, w))
    # explicit knobs win over the record
    ops.conv2d(x, w, tile_h=8, dataflow="carry")
    assert (seen[-1]["tile_h"], seen[-1]["tile_cout"],
            seen[-1]["dataflow"]) == (8, 4, "carry")
    # and the switches restore the plan's defaults
    ops.conv2d(x, w, use_autotune_cache=False)
    assert (seen[-1]["tile_h"], seen[-1]["dataflow"]) == (None, "carry")
    monkeypatch.setenv(autotune.AUTOTUNE_ENV, "0")
    ops.conv2d(x, w)
    assert (seen[-1]["tile_h"], seen[-1]["dataflow"]) == (None, "carry")


def test_int8_route_consults_its_own_namespace(monkeypatch):
    x = _t(RNG.standard_normal((1, 14, 14, 16)))
    w = _t(RNG.standard_normal((3, 3, 16, 32)) * .3)
    pk = layers.calibrate_conv2d({"w": w}, x)["packed"]
    xs, ws = (1, 14, 14, 16), (3, 3, 16, 32)
    autotune.store(autotune.make_key(xs, ws, pad=SAME, device=CPU),
                   dict(tile_h=2, tile_cout=8, dataflow="carry"))
    seen = _spy(monkeypatch, ops, "trim_conv2d_q8")
    want = ops.conv2d(x, pk)
    assert seen[-1]["tile_h"] is None           # the f32 record is not it
    autotune.store(autotune.make_key(xs, ws, pad=SAME, dtype="int8",
                                     device=CPU, op="conv2d_q8"),
                   dict(tile_h=4, tile_cout=32, dataflow="halo"))
    got = ops.conv2d(x, pk)
    assert (seen[-1]["tile_h"], seen[-1]["tile_cout"],
            seen[-1]["dataflow"]) == (4, 32, "halo")
    assert torch.equal(got, want)               # int8 sums are exact


def test_large_k_never_consults(monkeypatch):
    """The K > 8 adder tree reads no record, forward or backward, and
    packing refuses K > 8, as in JAX."""
    xs, ws = (1, 20, 20, 3), (11, 11, 3, 4)
    pads = ref.conv_pads(20, 20, 11, 4, "same")        # 5 x 5 outputs
    for key in (autotune.make_key(xs, ws, stride=4, pad=pads, device=CPU),
                autotune.make_key((1, 19, 19, 3), (3, 3, 3, 4), stride=4,
                                  device=CPU)):        # a 3x3 sub-kernel
        autotune.store(key, dict(tile_h=4, tile_cout=4, dataflow="halo"))
    x = _t(RNG.standard_normal(xs)).requires_grad_()
    w = _t(RNG.standard_normal(ws) * .1).requires_grad_()
    seen = _spy(monkeypatch, ops, "trim_conv2d")
    knobs = _spy(monkeypatch, autotune, "knobs_for")
    out = ops.conv2d(x, w, stride=4)
    out.sum().backward()
    assert len(seen) == 16 and knobs == []
    assert all(kw["dataflow"] == "carry" and kw["tile_h"] is None
               for kw in seen)
    with pytest.raises(ValueError, match="K=11"):
        ops.pack_conv2d_weights(w.detach())


def test_backward_pass_uses_cached_knobs(monkeypatch):
    """The backward reads both records: the input-gradient conv under the
    conv2d: key of its own problem, the weight gradient under
    conv2d_wgrad:."""
    x = _t(RNG.standard_normal(X_SHAPE))
    w = _t(RNG.standard_normal(W_SHAPE) * .3)
    autotune.store(autotune.make_key(X_SHAPE, W_SHAPE, device=CPU,
                                     op="conv2d_wgrad"), dict(tile_go=3))
    geo = input_grad_geometry(X_SHAPE, W_SHAPE)
    autotune.store(autotune.make_key(geo["g_dilated_shape"],
                                     geo["wt_shape"],
                                     pad=(geo["pad_h"], geo["pad_w"]),
                                     device=CPU),
                   dict(tile_h=5, tile_cout=4, dataflow="halo"))
    ig = _spy(monkeypatch, ops, "trim_conv2d_input_grad")
    wg = _spy(monkeypatch, ops, "trim_conv2d_weight_grad")
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ops.conv2d(xr, wr, padding="valid") ** 2).sum().backward()
    assert (ig[0]["tile_h"], ig[0]["tile_cout"], ig[0]["dataflow"]) \
        == (5, 4, "halo")
    assert wg[0]["tile_go"] == 3
    xo, wo = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ref.conv2d(xo, wo, padding="valid") ** 2).sum().backward()
    _close(xr.grad, xo.grad)
    _close(wr.grad, wo.grad)
    # without records the backward runs the forward's dataflow, defaults
    autotune.reset_memory_cache()
    os.remove(autotune.cache_path())
    xr = x.clone().requires_grad_()
    (ops.conv2d(xr, w, padding="valid", dataflow="halo") ** 2).sum() \
        .backward()
    assert (ig[-1]["tile_h"], ig[-1]["dataflow"]) == (None, "halo")


def test_tune_backward_round_trip():
    recs = autotune.tune_backward(X_SHAPE, W_SHAPE, stride=2, pad=SAME,
                                  device=CPU)
    assert set(recs) == {"input_grad", "weight_grad"}
    wrec = autotune.weight_grad_knobs_for(X_SHAPE, W_SHAPE, stride=2,
                                          pad=SAME, device=CPU)
    assert wrec == recs["weight_grad"] and wrec["tile_go"] >= 1
    geo = input_grad_geometry(X_SHAPE, W_SHAPE, stride=2, pad=SAME)
    irec = autotune.knobs_for(geo["g_dilated_shape"], geo["wt_shape"],
                              pad=(geo["pad_h"], geo["pad_w"]), device=CPU)
    assert irec == recs["input_grad"]
    autotune.reset_memory_cache()
    assert autotune.weight_grad_knobs_for(X_SHAPE, W_SHAPE, stride=2,
                                          pad=SAME, device=CPU) == wrec
    autotune.store(autotune.make_key(X_SHAPE, W_SHAPE, stride=2, pad=SAME,
                                     device=CPU, op="conv2d_wgrad"),
                   dict(tile_go="bad"))
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert autotune.weight_grad_knobs_for(
            X_SHAPE, W_SHAPE, stride=2, pad=SAME, device=CPU) is None


def test_conv2d_pack_params_matches_unpacked():
    p = {"w": _t(RNG.standard_normal(W_SHAPE) * .3),
         "b": _t(RNG.standard_normal(12))}
    x = _t(RNG.standard_normal((1, 12, 12, 8)))
    want = layers.conv2d_apply(p, x, activation="relu")
    packed = layers.conv2d_pack_params(p, x_shape=tuple(x.shape))
    assert isinstance(packed["packed"], ops.PackedConv2dWeights)
    assert torch.equal(layers.conv2d_apply(packed, x, activation="relu"),
                       want)
    with pytest.raises(ValueError, match="bias is inside"):
        ops.conv2d(x, packed["packed"], bias=p["b"])


def test_depthwise_separable_pack_matches_unpacked():
    p = {"dw": {"w": _t(RNG.standard_normal((3, 3, 1, 8)) * .3),
                "b": _t(RNG.standard_normal(8))},
         "pw": {"w": _t(RNG.standard_normal((1, 1, 8, 16)) * .3),
                "b": _t(RNG.standard_normal(16))}}
    x = _t(RNG.standard_normal((1, 10, 10, 8)))
    want = layers.depthwise_separable_apply(p, x, stride=2)
    packed = layers.depthwise_separable_pack_params(
        p, x_shape=tuple(x.shape), stride=2)
    assert packed["dw"]["packed"].groups == 8
    assert torch.equal(layers.depthwise_separable_apply(packed, x,
                                                        stride=2), want)


def test_packed_params_pick_up_cached_plan(monkeypatch):
    """Pack-time consultation: the record's knobs ride along as hints;
    an explicit knob still wins at call time."""
    autotune.store(autotune.make_key((1, 12, 12, 8), W_SHAPE, pad=SAME,
                                     device=CPU),
                   dict(tile_h=4, tile_cout=6, dataflow="halo"))
    w = _t(RNG.standard_normal(W_SHAPE) * .3)
    pk = ops.pack_conv2d_weights(w, x_shape=(1, 12, 12, 8))
    assert (pk.tile_cout, pk.tile_h, pk.dataflow) == (6, 4, "halo")
    assert ops.pack_conv2d_weights(w).tile_h is None      # no x_shape
    x = _t(RNG.standard_normal((1, 12, 12, 8)))
    seen = _spy(monkeypatch, ops, "trim_conv2d")
    _close(ops.conv2d(x, pk), ref.conv2d(x, w))
    assert (seen[-1]["tile_h"], seen[-1]["tile_cout"],
            seen[-1]["dataflow"]) == (4, 6, "halo")
    ops.conv2d(x, pk, dataflow="carry")
    assert (seen[-1]["tile_h"], seen[-1]["dataflow"]) == (4, "carry")


# ---------------------------------------------------------------------------
# Fused groups
# ---------------------------------------------------------------------------

def test_fused_keys_never_alias_other_namespaces():
    layers_ = alexnet_layers()[1:]                 # conv2..conv5 (K <= 5)
    g2, g4 = build_group(layers_[:2], 0), build_group(layers_, 0)
    k2 = autotune.fused_key(g2.signature, device=CPU)
    k4 = autotune.fused_key(g4.signature, device=CPU)
    assert k2.startswith("conv2d_fused:d2:")
    assert k4.startswith("conv2d_fused:d4:")
    assert g2.signature == build_group(layers_[:2], 0,
                                       strip_rows=3).signature
    assert autotune.fused_key(g2.signature, n=4, device=CPU) != k2
    assert autotune.fused_key(g2.signature, dtype="int8", device=CPU) != k2
    autotune.store(k2, dict(strip_rows=3, band_cols=2, depth=2))
    autotune.store(k4, dict(strip_rows=7, band_cols=1, depth=4))
    assert autotune.fused_knobs_for(g2.signature,
                                    device=CPU)["strip_rows"] == 3
    assert autotune.fused_knobs_for(g4.signature,
                                    device=CPU)["strip_rows"] == 7
    assert autotune.knobs_for(X_SHAPE, W_SHAPE, device=CPU) is None
    for bad in (dict(strip_rows="bad", band_cols=1),
                dict(strip_rows=0, band_cols=1), dict(strip_rows=2)):
        autotune.store(k2, bad)
        autotune.reset_memory_cache()
        with pytest.warns(RuntimeWarning, match="malformed"):
            assert autotune.fused_knobs_for(g2.signature,
                                            device=CPU) is None


def _vgg16_small():
    return scale_layers(network_layers("vgg16"), 16)


def test_tune_fused_round_trip(monkeypatch):
    """The model-only record is the plan's own tile; a record of another
    tile that fits moves that group's tile and nothing else (the
    partition reads no cache); one that does not fit is a miss."""
    topo = _vgg16_small()
    plan = FusedGroupPlan.build(topo, n=2)
    g = plan.fused_groups[0]
    pools = infer_pools(topo)
    rec = autotune.tune_fused(topo[g.start:g.start + g.depth],
                              start=g.start,
                              pools=pools[g.start:g.start + g.depth], n=2,
                              device=CPU)
    assert (rec["strip_rows"], rec["band_cols"]) == (g.strip_rows,
                                                     g.band_cols)
    assert rec["source"] == "model" and rec["depth"] == g.depth
    got = autotune.fused_knobs_for(g.signature, n=2, device=CPU)
    assert got == rec
    cached = FusedGroupPlan.build(topo, n=2, use_autotune_cache=True,
                                  device=CPU)
    assert cached.groups == plan.groups
    other = (1, 1) if (g.strip_rows, g.band_cols) != (1, 1) else (2, 2)
    autotune.store(autotune.fused_key(g.signature, n=2, device=CPU),
                   dict(rec, strip_rows=other[0], band_cols=other[1]))
    cached = FusedGroupPlan.build(topo, n=2, use_autotune_cache=True,
                                  device=CPU)
    assert [(h.start, h.depth) for h in cached.groups] \
        == [(h.start, h.depth) for h in plan.groups]
    moved = [h for h in cached.groups if h.start == g.start][0]
    assert (moved.strip_rows, moved.band_cols) == other
    assert FusedGroupPlan.build(topo, n=2).groups == plan.groups
    autotune.store(autotune.fused_key(g.signature, n=2, device=CPU),
                   dict(rec, strip_rows=g.last.h_pool + 5))
    autotune.reset_memory_cache()
    with pytest.warns(RuntimeWarning, match="does not fit"):
        cached = FusedGroupPlan.build(topo, n=2, use_autotune_cache=True,
                                      device=CPU)
    assert cached.groups == plan.groups
    monkeypatch.setenv(autotune.AUTOTUNE_ENV, "0")
    assert autotune.fused_knobs_for(g.signature, n=2, device=CPU) is None


def test_tune_fused_network_sweep():
    topo = _vgg16_small()
    recs = autotune.tune_fused_network(topo, n=1, device=CPU)
    plan = FusedGroupPlan.build(topo, n=1)
    assert len(recs) == len(plan.fused_groups) > 0
    assert len({r["key"] for r in recs.values()}) == len(recs)
    for g in plan.fused_groups:
        r = recs[g.label]
        assert r["key"].startswith("conv2d_fused:")
        assert (r["strip_rows"], r["band_cols"]) == (g.strip_rows,
                                                     g.band_cols)


def test_partition_reads_no_cache():
    """Per-layer records (here, ones that would change every per-layer
    plan) do not move the fused partition: it prices the per-layer path
    through ConvPlans built with no knobs."""
    topo = _vgg16_small()
    plan = FusedGroupPlan.build(topo, n=2)
    for layer in topo:
        xs, pads, ws = autotune.layer_problem(layer, n=2)
        autotune.store(autotune.make_key(xs, ws, pad=pads, device=CPU),
                       dict(tile_h=1, tile_cout=1, dataflow="halo"))
    fuse_plan._build_plan.cache_clear()       # partition afresh
    assert FusedGroupPlan.build(topo, n=2).groups == plan.groups
    assert FusedGroupPlan.build(topo, n=2, use_autotune_cache=True,
                                device=CPU).groups == plan.groups


# ---------------------------------------------------------------------------
# Sweeps and the serving prewarm
# ---------------------------------------------------------------------------

def _serving_topo():
    return scale_layers(network_layers("alexnet"), 8)


def test_tune_network_skips_large_k_and_shares_keys():
    recs = autotune.tune_network("vgg16", n=1, device=CPU)
    assert len(recs) == 13
    assert recs["conv6"] is recs["conv7"]              # one key, one tune
    arecs = autotune.tune_network(_serving_topo(), n=1, device=CPU)
    assert "skipped" in arecs["conv1"]
    assert all("key" in arecs[f"conv{i}"] for i in range(2, 6))
    with pytest.raises(ValueError, match="duplicate"):
        autotune.tune_network([vgg16_layers()[0]] * 2, device=CPU)


def test_prewarm_buckets_covers_every_grid_shape(monkeypatch):
    """After prewarm_buckets every (layer, bucket) problem resolves
    through knobs_for without another call into the tuner."""
    topo, buckets = _serving_topo(), (1, 2, 4)
    recs = autotune.prewarm_buckets(topo, buckets, device=CPU)
    assert sorted(recs) == [1, 2, 4]

    def cold(*a, **kw):
        raise AssertionError(f"cold tune after prewarm: {a} {kw}")
    monkeypatch.setattr(autotune, "tune", cold)
    for b in buckets:
        for layer in topo:
            if layer.kernel > ops.MAX_NATIVE_K:
                assert "skipped" in recs[b]["layers"][layer.name]
                continue
            xs, pads, ws = autotune.layer_problem(layer, n=b)
            knobs = autotune.knobs_for(xs, ws, stride=layer.stride,
                                       pad=pads, groups=layer.groups,
                                       device=CPU)
            assert knobs is not None, (layer.name, b)
            assert knobs == {k: v for k, v in
                             recs[b]["layers"][layer.name].items()
                             if k in knobs}


def test_prewarm_buckets_fused_seeds_group_records():
    topo = _vgg16_small()
    recs = autotune.prewarm_buckets(topo, (1, 2), fused=True, device=CPU)
    for b in (1, 2):
        fused = recs[b]["fused"]
        assert fused, f"no fused groups recorded at bucket {b}"
        for r in fused.values():
            assert r["key"].startswith("conv2d_fused:")
            assert f":n{b}:" in r["key"]
            assert autotune.lookup(r["key"]) is not None


def test_prewarm_buckets_dedups_and_validates():
    topo = _serving_topo()
    with pytest.raises(ValueError):
        autotune.prewarm_buckets(topo, (0, 2), device=CPU)
    recs = autotune.prewarm_buckets(topo, (2, 1, 2, 1), device=CPU)
    assert sorted(recs) == [1, 2]
    with pytest.raises(ValueError, match="inference only"):
        autotune.prewarm_buckets(topo, (1,), dtype="int8",
                                 include_backward=True, device=CPU)


_PREWARM_WORKER = r"""
import sys
from repro_torch.core import autotune
from repro_torch.core.netplan import network_layers, scale_layers
topo = scale_layers(network_layers("alexnet"), 8)
autotune.prewarm_buckets(topo, (1, 2), device="cpu", path=sys.argv[1])
print("done")
"""


def test_concurrent_prewarm_merges_cleanly(tmp_path):
    """4 replicas prewarming one cache path at once lose nothing."""
    path = str(tmp_path / "shared.json")
    _workers(_PREWARM_WORKER, [(path,)] * 4)
    want = set()
    for per in autotune.prewarm_buckets(_serving_topo(), (1, 2),
                                        device=CPU, write=False).values():
        want |= {r["key"] for r in per["layers"].values() if "key" in r}
    with open(path) as f:
        entries = json.load(f)["entries"]
    assert want and not want - set(entries)


PREWARM_GRID = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def prewarmed(tmp_path_factory):
    """A model-only prewarm of full-width VGG-16 and AlexNet, f32 and
    int8, over the serving grid, in a cache file of its own."""
    path = str(tmp_path_factory.mktemp("prewarm") / "convtune.json")
    for net in ("vgg16", "alexnet"):
        for dtype in ("float32", "int8"):
            topo = [l for l in network_layers(net)
                    if dtype == "float32" or l.kernel <= 8]
            autotune.prewarm_buckets(topo, PREWARM_GRID, dtype=dtype,
                                     device=CPU, path=path)
    autotune.reset_memory_cache()
    return path


def _knobs_run(monkeypatch, layer, n, dtype):
    """The knobs ``ops.conv2d`` (or its int8 route) passes to the kernel
    wrapper for ``layer`` at batch ``n``: stride-0 views stand in for the
    activations and the wrapper is replaced by a stub."""
    xs, pads, ws = autotune.layer_problem(layer, n=n)
    seen = []

    def stub(x, w, *a, **kw):
        seen.append(kw)
        h = (x.shape[1] + sum(kw["pad"][0]) - w.shape[0]) // kw["stride"] + 1
        wd = (x.shape[2] + sum(kw["pad"][1]) - w.shape[1]) \
            // kw["stride"] + 1
        return torch.zeros(1).expand(x.shape[0], h, wd, w.shape[3])
    padding = "same" if layer.padding else "valid"
    if dtype == "int8":
        monkeypatch.setattr(ops, "trim_conv2d_q8", stub)
        x = torch.zeros(1, dtype=torch.int8).expand(xs)
        pk = ops.quantize_conv2d_weights(
            torch.full(ws, 0.01), x_scale=0.1, groups=layer.groups)
        ops.conv2d(x, pk, stride=layer.stride, padding=padding)
    else:
        monkeypatch.setattr(ops, "trim_conv2d", stub)
        ops.conv2d(torch.zeros(1).expand(xs), torch.zeros(ws),
                   stride=layer.stride, padding=padding,
                   feature_group_count=layer.groups)
    return xs, pads, ws, seen


@pytest.mark.parametrize("net,name", [("vgg16", l.name)
                                      for l in vgg16_layers()]
                         + [("alexnet", l.name) for l in alexnet_layers()])
def test_prewarmed_layers_run_the_no_cache_plan(prewarmed, monkeypatch, net,
                                                name):
    """The consult side of a model-only prewarm: at every bucket the
    knobs ops.conv2d and the int8 route read from the cache build the
    plan they would build with no cache; the K > 8 layer (AlexNet conv1)
    reads no record."""
    monkeypatch.setenv(autotune.CACHE_ENV, prewarmed)
    autotune.reset_memory_cache()
    layer = _layer(net, name)
    for n in PREWARM_GRID:
        for dtype in ("float32", "int8"):
            if layer.kernel > 8:
                if dtype == "float32":
                    *_, seen = _knobs_run(monkeypatch, layer, n, dtype)
                    assert len(seen) == 16
                    assert all(kw["tile_h"] is None
                               and kw["dataflow"] == "carry"
                               for kw in seen)
                continue
            xs, pads, ws, seen = _knobs_run(monkeypatch, layer, n, dtype)
            (kw,) = seen
            assert kw["tile_cout"] is not None, "no record was read"
            db = autotune.DTYPE_BYTES[dtype]
            common = dict(stride=layer.stride, pad=pads,
                          groups=layer.groups, dtype_bytes=db)
            assert ConvPlan.build(xs, ws, tile_h=kw["tile_h"],
                                  tile_cout=kw["tile_cout"],
                                  dataflow=kw["dataflow"], **common) \
                == ConvPlan.build(xs, ws, **common), (n, dtype)


# ---------------------------------------------------------------------------
# Parity with the JAX package: a packed tree
# ---------------------------------------------------------------------------

IMAGE = 32


def _vgg16_32(cls):
    """VGG-16 at 1/16 width with its spatial sizes at a 32x32 image."""
    sizes = (32, 32, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2)
    return [cls(l.name, s, l.in_channels, l.out_channels, l.kernel,
                l.stride, l.padding, l.groups)
            for l, s in zip(_vgg16_small(), sizes)]


def test_jax_packed_tree_matches_jax_forward():
    """A JAX ``cnn_pack_params`` tree (f32 PackedConv2dWeights) carried
    over by ``params_from_jax``: the port's forward equals JAX's
    ``cnn_apply_from_layers`` on the same packed tree within 1e-5; the
    JAX tiles are dropped, its dataflow hint kept."""
    jtopo, topo = _vgg16_32(JConvLayer), _vgg16_32(ConvLayer)
    params = jinit(jlayers.cnn_params_from_layers(jtopo, n_classes=10),
                   jax.random.PRNGKey(0))
    jpacked = jlayers.cnn_pack_params(params, jtopo, n=2)
    jpacked["conv3"]["packed"] = dataclasses.replace(
        jpacked["conv3"]["packed"], dataflow="halo")
    x = RNG.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    want = np.asarray(jlayers.cnn_apply_from_layers(
        jpacked, jtopo, jnp.asarray(x)))
    tree = params_from_jax(jax.tree.map(np.asarray, jpacked))
    pk = tree["conv3"]["packed"]
    assert isinstance(pk, ops.PackedConv2dWeights)
    assert (pk.tile_h, pk.tile_cout, pk.dataflow) == (None, None, "halo")
    assert tuple(pk.w.shape) == (3, 3, topo[3].in_channels,
                                 topo[3].out_channels)
    got = layers.cnn_apply_from_layers(tree, topo, torch.from_numpy(x))
    _close(got.numpy(), want)
    # the port's own packing of the raw tree computes the same
    raw = params_from_jax(jax.tree.map(np.asarray, params))
    mine = layers.cnn_pack_params(raw, topo, n=2)
    assert torch.equal(layers.cnn_apply_from_layers(
        mine, topo, torch.from_numpy(x)), layers.cnn_apply_from_layers(
        raw, topo, torch.from_numpy(x)))
    assert jnetplan.infer_pools(jtopo) == infer_pools(topo)


def test_packed_tree_serves_and_refuses_training():
    topo = _vgg16_32(ConvLayer)[:4]
    model = layers.TrimCNN.random(topo, n_classes=3, device=CPU)
    x = torch.from_numpy(RNG.standard_normal((2, IMAGE, IMAGE, 3))
                         .astype(np.float32))
    packed = layers.TrimCNN(topo, layers.cnn_pack_params(model.tree(),
                                                         topo, n=2))
    with torch.no_grad():
        assert torch.equal(packed(x), model(x))
    assert isinstance(packed.tree()["conv0"]["packed"],
                      ops.PackedConv2dWeights)
    with pytest.raises(ValueError, match="inference only"):
        layers.TrimCNN(topo, packed.tree(), trainable=True)
    with pytest.raises(ValueError, match="inference only"):
        layers.TrimCNN(topo, packed.tree(), fused=True)
