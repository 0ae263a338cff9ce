"""Parity of the port's conv operator with the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``repro.kernels.ops.conv2d``
— the Pallas carry kernel, in interpret mode here — and
``repro_torch.kernels.ops.conv2d``, whose wrapper runs its plain PyTorch
version on CPU tensors.  ``guard.events()`` must stay empty, so the JAX
side really ran the Pallas kernel and not its ``ref`` fallback.  The JAX
halo kernel does not run on this JAX version (``pl.unblocked`` is gone),
so the port's halo dataflow is held against the JAX ``ref.conv2d``.
Tolerance: 1e-5 * max(1, max|jax|), f32 sums taken in another order.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guard
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import trim_conv2d as tc

TOL = 1e-5
CIN = COUT = 8
ACTS = [None, "relu", "gelu", "silu"]
# K x stride x groups x padding; the activation cycles so each of the four
# appears six times
GRID = [(k, s, g, pad, ACTS[i % 4]) for i, (k, s, g, pad) in enumerate(
    itertools.product((1, 3, 5), (1, 2), (1, CIN), ("same", "valid")))]


def _inputs(k, groups, seed, hw=(11, 12)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, CIN)).astype(np.float32)
    w = (rng.standard_normal((k, k, CIN // groups, COUT))
         / np.sqrt(k * k * CIN // groups)).astype(np.float32)
    b = rng.standard_normal(COUT).astype(np.float32)
    return x, w, b


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("k,stride,groups,padding,act", GRID)
def test_conv2d_matches_jax_carry_kernel(k, stride, groups, padding, act):
    x, w, b = _inputs(k, groups, seed=k * 10 + stride + groups)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                       padding=padding, feature_group_count=groups,
                       bias=jnp.asarray(b), activation=act,
                       dataflow="carry", use_autotune_cache=False)
    want = np.asarray(want)
    assert guard.events() == [], "JAX side fell back from the Pallas kernel"
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                     padding=padding, feature_group_count=groups,
                     bias=torch.from_numpy(b), activation=act,
                     dataflow="carry")
    _close(got, want)


@pytest.mark.parametrize("k,stride,groups", [(3, 1, 1), (3, 2, 1),
                                              (5, 2, CIN), (3, 1, 2)])
def test_halo_dataflow_matches_jax_ref(k, stride, groups):
    x, w, b = _inputs(k, groups, seed=7 + k + stride + groups)
    want = jref.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                       padding="same", feature_group_count=groups,
                       bias=jnp.asarray(b), activation="relu")
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                     feature_group_count=groups, bias=torch.from_numpy(b),
                     activation="relu", dataflow="halo")
    _close(got, want)


def test_depthwise_conv2d_matches_jax():
    x, w, b = _inputs(3, CIN, seed=3)
    want = jops.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                                 bias=jnp.asarray(b), activation="relu")
    assert guard.events() == []
    got = ops.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                               stride=2, bias=torch.from_numpy(b),
                               activation="relu")
    _close(got, want)


@pytest.mark.parametrize("tile_h,tile_cout", [(1, 1), (4, 3), (64, 8)])
def test_tile_knobs_keep_the_function(tile_h, tile_cout):
    x, w, b = _inputs(3, 1, seed=11)
    want = np.asarray(jref.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  bias=jnp.asarray(b)))
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     bias=torch.from_numpy(b), tile_h=tile_h,
                     tile_cout=tile_cout)
    _close(got, want)


def test_impl_ref_matches_trim():
    x, w, b = _inputs(3, 2, seed=5)
    args = (torch.from_numpy(x), torch.from_numpy(w))
    kw = dict(stride=2, feature_group_count=2, bias=torch.from_numpy(b),
              activation="gelu")
    _close(ops.conv2d(*args, impl="ref", **kw), ops.conv2d(*args, **kw))


def test_trim_conv2d_symmetric_pad_matches_jax_kernel():
    """The wrapper's int ``pad`` is the JAX ``trim_conv2d`` argument."""
    from repro.kernels.trim_conv2d import trim_conv2d as jtrim
    x, w, b = _inputs(3, 1, seed=9)
    want = jtrim(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad=1,
                 activation="silu")
    got = tc.trim_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), pad=1, activation="silu")
    _close(got, want)


def test_argument_errors():
    x = torch.zeros((1, 8, 8, CIN))
    w = torch.zeros((3, 3, CIN, COUT))
    with pytest.raises(ValueError):
        ops.conv2d(x, w, activation="tanh")
    with pytest.raises(ValueError):
        ops.conv2d(x, w, dataflow="diagonal")
    with pytest.raises(ValueError):
        ops.conv2d(x, w, feature_group_count=3)
    with pytest.raises(ValueError):
        ops.conv2d(x, w, impl="pallas")
    with pytest.raises(ValueError):
        ops.conv2d(x, w, padding="full")
    with pytest.raises(NotImplementedError, match="adder"):
        ops.conv2d(torch.zeros((1, 12, 12, 2)), torch.zeros((9, 9, 2, 2)))


def test_kernel_input_shape_matches_jax():
    for shape, k, s, pad in [((1, 224, 224, 3), 3, 1, "same"),
                             ((2, 56, 56, 8), 3, 2, "same"),
                             ((1, 227, 227, 3), 11, 4, "valid"),
                             ((1, 13, 13, 4), 5, 1, "same")]:
        assert ops.kernel_input_shape(shape, k, s, pad) == \
            jops.kernel_input_shape(shape, k, s, pad)
