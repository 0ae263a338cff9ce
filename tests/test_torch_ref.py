"""The port's oracles (``repro_torch.kernels.ref``) against the JAX
package's: conv, bias + activation epilogue, VALID max pool and the XLA
'same' padding rule.  Same numpy inputs on both sides; tolerance 1e-5 *
max(1, max|jax|) for the f32 conv (sums in another order), 1e-6 for the
elementwise epilogue, exact for the pool and the padding rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.core.conv_plan import same_pads
from repro_torch.kernels import ref


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("k,stride,groups,padding", [
    (3, 1, 1, "same"), (3, 2, 1, "same"), (5, 2, 4, "valid"),
    (1, 1, 1, "valid"), (3, 1, 8, "same"), (4, 3, 2, "same")])
def test_conv2d_oracle_matches_jax(k, stride, groups, padding):
    rng = _rng(k + stride + groups)
    x = rng.standard_normal((2, 10, 9, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8 // groups, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(jref.conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding,
        feature_group_count=groups, bias=jnp.asarray(b), activation="relu"))
    got = ref.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=stride, padding=padding,
                     feature_group_count=groups, bias=torch.from_numpy(b),
                     activation="relu").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
def test_epilogue_matches_jax(act):
    rng = _rng(1)
    y = (rng.standard_normal((3, 5, 7)) * 4).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = np.asarray(jref.epilogue(jnp.asarray(y), jnp.asarray(b), act))
    got = ref.epilogue(torch.from_numpy(y), torch.from_numpy(b), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_epilogue_rejects_unknown_activation():
    with pytest.raises(ValueError):
        ref.epilogue(torch.zeros(2), None, "tanh")


@pytest.mark.parametrize("stride,window,size", [(2, 2, 8), (2, 3, 13),
                                                (1, 3, 5), (2, 2, 7)])
def test_maxpool_matches_jax(stride, window, size):
    x = _rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jlayers._maxpool(jnp.asarray(x), stride, window))
    got = ref.maxpool2d(torch.from_numpy(x), stride, window).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_same_pads_match_jax():
    for size in (1, 7, 14, 56, 224, 227):
        for k in (1, 2, 3, 5, 11):
            for s in (1, 2, 3, 4):
                assert same_pads(size, k, s) == jops._same_pads(size, k, s)


def test_conv_pads_modes():
    assert ref.conv_pads(56, 56, 3, 2, "same") == ((0, 1), (0, 1))
    assert ref.conv_pads(56, 56, 3, 2, "valid") == ((0, 0), (0, 0))
    with pytest.raises(ValueError):
        ref.conv_pads(56, 56, 3, 2, "full")
