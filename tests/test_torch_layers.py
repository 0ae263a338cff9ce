"""Whole-network parity of the port with the JAX package on the CPU.

Parameters come from the JAX ``init_params`` and reach the port through
``repro_torch.convert.params_from_jax``, so both packages compute the same
function on the same numpy images.  The serve_conv smoke topology runs on
the JAX Pallas carry kernel (interpret mode; ``guard.events()`` stays
empty); VGG-16 at 1/16 of its channels and its full 224 x 224 input runs
on the JAX ``impl="ref"`` oracle.  Tolerance: 1e-5 * max(1, max|logit|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guard
from repro.core import netplan as jnetplan
from repro.core.model import ConvLayer as JConvLayer
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro_torch.convert import params_from_jax
from repro_torch.core import netplan
from repro_torch.core.model import ConvLayer
from repro_torch.models import layers
from repro_torch.models.base import Param, init_params

TOL = 1e-5
SMOKE = [("s0", 16, 3, 8, 3, 1, 1), ("s1", 16, 8, 8, 3, 2, 1),
         ("s2", 8, 8, 16, 3, 1, 1)]


def _jax_params(topo, n_classes):
    p = jinit(jlayers.cnn_params_from_layers(topo, n_classes=n_classes),
              jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _close(got, want):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def test_smoke_topology_matches_jax_carry_kernel():
    jtopo = [JConvLayer(*a) for a in SMOKE]
    topo = [ConvLayer(*a) for a in SMOKE]
    params = _jax_params(jtopo, 10)
    x = np.random.default_rng(0).standard_normal((3, 16, 16, 3)) \
        .astype(np.float32)
    want = np.asarray(jlayers.cnn_apply_from_layers(
        jax.tree.map(jnp.asarray, params), jtopo, jnp.asarray(x)))
    assert guard.events() == [], "JAX side fell back from the Pallas kernel"
    model = layers.TrimCNN(topo, params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    _close(got, want)


def test_vgg16_scaled_full_spatial_matches_jax_ref():
    jtopo = jnetplan.scale_layers(jnetplan.network_layers("vgg16"), 16)
    topo = netplan.scale_layers(netplan.network_layers("vgg16"), 16)
    assert [t.__dict__ for t in topo] == [t.__dict__ for t in jtopo]
    params = _jax_params(jtopo, 10)
    x = np.random.default_rng(1).standard_normal((1, 224, 224, 3)) \
        .astype(np.float32)
    want = np.asarray(jlayers.cnn_apply_from_layers(
        jax.tree.map(jnp.asarray, params), jtopo, jnp.asarray(x),
        impl="ref"))
    with torch.no_grad():
        got = layers.cnn_apply_from_layers(params_from_jax(params), topo,
                                           torch.from_numpy(x)).numpy()
    _close(got, want)


def test_feature_map_without_head_matches_jax():
    jtopo = [JConvLayer(*a) for a in SMOKE]
    topo = [ConvLayer(*a) for a in SMOKE]
    params = _jax_params(jtopo, None)
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 3)) \
        .astype(np.float32)
    want = np.asarray(jlayers.cnn_apply_from_layers(
        jax.tree.map(jnp.asarray, params), jtopo, jnp.asarray(x),
        impl="ref", activation="gelu"))
    got = layers.cnn_apply_from_layers(
        params_from_jax(params), topo, torch.from_numpy(x),
        activation="gelu", dataflow="halo")
    assert got.shape == (2, 8, 8, 16)
    _close(got, want)


@pytest.mark.parametrize("net", ["vgg16", "alexnet", "mobilenet"])
def test_topologies_and_pools_match_jax(net):
    topo = netplan.network_layers(net)
    jtopo = jnetplan.network_layers(net)
    assert [t.__dict__ for t in topo] == [t.__dict__ for t in jtopo]
    assert netplan.infer_pools(topo) == jnetplan.infer_pools(jtopo)
    for scale in (1, 8):
        st, jst = netplan.scale_layers(topo, scale), \
            jnetplan.scale_layers(jtopo, scale)
        assert [t.__dict__ for t in st] == [t.__dict__ for t in jst]
    for l, jl in zip(topo, jtopo):
        assert netplan.layer_kernel_problem(l, n=2) == \
            jnetplan.layer_kernel_problem(jl, n=2)


def test_pool_inference_errors_match_jax():
    a = ConvLayer("a", 8, 3, 3, 3, padding=1)
    with pytest.raises(netplan.PoolInferenceError) as e:
        netplan.pool_between(a, ConvLayer("b", 16, 3, 3, 3, padding=1))
    assert e.value.reason == "upsample"
    with pytest.raises(netplan.PoolInferenceError) as e:
        netplan.pool_between(ConvLayer("a", 64, 3, 3, 3, padding=1),
                             ConvLayer("b", 4, 3, 3, 3, padding=1))
    assert e.value.reason == "strided-join"
    with pytest.raises(ValueError):      # padding not 'same'-equivalent
        netplan.layer_kernel_problem(ConvLayer("c", 8, 3, 3, 3, padding=2))


def test_params_from_jax_round_trip():
    jtopo = [JConvLayer(*a) for a in SMOKE]
    params = _jax_params(jtopo, 10)
    tree = params_from_jax(params)
    model = layers.TrimCNN([ConvLayer(*a) for a in SMOKE], tree)
    for name, leaf in model.tree().items():
        for k, t in leaf.items():
            assert t.dtype == torch.float32 and not t.requires_grad
            assert np.array_equal(t.numpy(), params[name][k])


def test_random_init_is_seeded_and_scaled():
    topo = [ConvLayer(*a) for a in SMOKE]
    a = layers.TrimCNN.random(topo, n_classes=10, seed=3, device="cpu")
    b = layers.TrimCNN.random(topo, n_classes=10, seed=3, device="cpu")
    c = layers.TrimCNN.random(topo, n_classes=10, seed=4, device="cpu")
    ta, tb, tc = a.tree(), b.tree(), c.tree()
    assert all(torch.equal(ta[k][n], tb[k][n]) for k in ta for n in ta[k])
    assert not torch.equal(ta["conv0"]["w"], tc["conv0"]["w"])
    assert torch.count_nonzero(ta["conv0"]["b"]) == 0
    # init_params' std: scale / sqrt(shape[-2]) (conv: scale 1/K)
    w = init_params(Param((3, 3, 400, 300), scale=1 / 3),
                    torch.Generator().manual_seed(0))
    assert abs(w.std().item() - 1 / 3 / 20) < 1e-3


def test_fused_is_not_ported_yet():
    topo = [ConvLayer(*a) for a in SMOKE]
    model = layers.TrimCNN.random(topo, n_classes=10, device="cpu")
    with pytest.raises(NotImplementedError, match="fused"):
        layers.cnn_apply_from_layers(model.tree(), topo,
                                     torch.zeros((1, 16, 16, 3)), fused=True)
