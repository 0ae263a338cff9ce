"""AlexNet, the paper's second workload, in the port against the JAX
package on the CPU: the whole network at 1/16 of its channels and its full
227 x 227 input (conv1 is 11 x 11 at stride 4: the kernel tiling's adder
tree), served through ``ServingEngine`` and with ``fused=True``; the
patch-embed stem (P = 14, 25 sub-kernels) and ``anyres_tile_count`` of
``models/frontends.py``; ``configs/trim_cnn.py``.

Parameters come from the JAX ``init_params`` through ``params_from_jax``.
The network is held against JAX ``impl="ref"`` (the Pallas carry kernel in
interpret mode takes minutes at 227 x 227); the stem against the JAX
Pallas path (``guard.events()`` stays empty).  Tolerance: 1e-4 *
max(1, max|jax|), f32 sums in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import trim_cnn as jtrim_cnn
from repro.core import guard
from repro.core import netplan as jnetplan
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro_torch.configs import trim_cnn
from repro_torch.convert import params_from_jax
from repro_torch.core import netplan
from repro_torch.core.fuse_plan import FusedGroupPlan
from repro_torch.core.serving import ServingEngine, replay
from repro_torch.kernels import ops
from repro_torch.models import frontends, layers

TOL = 1e-4
SCALE = 16


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


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.fixture(scope="module")
def alexnet():
    """AlexNet at 1/16 width: both packages' topologies, JAX parameters
    (10 classes) and two seeded 227 x 227 images."""
    jtopo = jnetplan.scale_layers(jnetplan.network_layers("alexnet"), SCALE)
    topo = netplan.scale_layers(netplan.network_layers("alexnet"), SCALE)
    params = jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo, n_classes=10),
        jax.random.PRNGKey(0)))
    x = np.random.default_rng(3).standard_normal((2, 227, 227, 3)) \
        .astype(np.float32)
    return jtopo, topo, params, x


def test_alexnet_scaled_full_spatial_matches_jax_ref(alexnet):
    jtopo, topo, params, x = alexnet
    assert [t.__dict__ for t in topo] == [t.__dict__ for t in jtopo]
    assert topo[0].kernel == 11 and topo[0].stride == 4
    assert netplan.infer_pools(topo) == [(2, 3), (2, 3), (1, 1), (1, 1),
                                         (1, 1)]
    want = np.asarray(jlayers.cnn_apply_from_layers(
        jax.tree.map(jnp.asarray, params), jtopo, jnp.asarray(x),
        impl="ref"))
    for dataflow in ("carry", "halo"):
        with torch.no_grad():
            got = layers.cnn_apply_from_layers(
                params_from_jax(params), topo, torch.from_numpy(x),
                dataflow=dataflow).numpy()
        assert got.shape == (2, 10)
        _close(got, want)


def test_alexnet_fused_equals_per_layer_bitwise(alexnet):
    _, topo, params, x = alexnet
    tree = params_from_jax(params)
    plan = FusedGroupPlan.build(topo, n=2)
    assert not plan.groups[0].fused      # conv1 (K 11) is never fused
    with torch.no_grad():
        per_layer = layers.cnn_apply_from_layers(tree, topo,
                                                 torch.from_numpy(x))
        fused = layers.cnn_apply_from_layers(tree, topo, torch.from_numpy(x),
                                             fused=True)
    assert torch.equal(per_layer, fused)


@pytest.mark.parametrize("n", [1, 8])
def test_full_width_alexnet_plans_single_stage_groups(n):
    """At full width no AlexNet group fits the fused kernel: fused=True
    serves it per layer."""
    plan = FusedGroupPlan.build("alexnet", n=n)
    assert [g.depth for g in plan.groups] == [1] * 5
    assert not plan.fused_groups


def test_alexnet_served_rows_bit_match_forward_one(alexnet):
    _, topo, params, _ = alexnet
    engine = ServingEngine.for_topology(topo, params, buckets=(1, 2, 4),
                                        device="cpu")
    engine.prewarm()
    xs = np.random.default_rng(4).standard_normal((5, 227, 227, 3)) \
        .astype(np.float32)
    results, rejected = replay(engine, [(0.001 * i, i, xs[i])
                                        for i in range(5)])
    assert not rejected
    assert sorted(results) == list(range(5))
    for i in range(5):
        assert results[i].shape == (10,)
        assert np.array_equal(results[i], engine.forward_one(xs[i]))


def test_alexnet_conv1_runs_sixteen_subkernels():
    assert ops.conv_launches(11) == 16
    assert sum(ops.conv_launches(l.kernel)
               for l in netplan.network_layers("alexnet")) == 20


def test_reference_vision_stem_matches_jax_pallas():
    rng = np.random.default_rng(14)
    images = rng.standard_normal((1, 28, 28, 3)).astype(np.float32)
    w = (rng.standard_normal((14, 14, 3, 8)) / 14).astype(np.float32)
    want = np.asarray(jfrontends.reference_vision_stem(
        jnp.asarray(images), jnp.asarray(w)))
    assert guard.events() == [], "JAX side fell back from the Pallas kernel"
    got = frontends.reference_vision_stem(torch.from_numpy(images),
                                          torch.from_numpy(w))
    assert got.shape == (1, 4, 8)
    _close(got, want)


@pytest.mark.parametrize("hw", [(336, 336), (672, 672), (336, 1008),
                                (1000, 700), (1, 1), (337, 335)])
def test_anyres_tile_count_matches_jax(hw):
    assert frontends.anyres_tile_count(hw) == \
        jfrontends.anyres_tile_count(hw)
    assert frontends.anyres_tile_count(hw, tile=224, patch=16) == \
        jfrontends.anyres_tile_count(hw, tile=224, patch=16)


def test_trim_cnn_config_matches_jax():
    assert trim_cnn.ARCH_ID == jtrim_cnn.ARCH_ID == "trim-cnn"
    for name in ("alexnet_layers", "vgg16_layers"):
        mine = [dataclasses.asdict(l) for l in getattr(trim_cnn, name)()]
        theirs = [dataclasses.asdict(l)
                  for l in getattr(jtrim_cnn, name)()]
        assert mine == theirs
