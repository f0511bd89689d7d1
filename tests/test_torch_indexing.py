"""``ops.indexing.vindex`` and ``Vindex`` in the port against the JAX
package's, on the same numpy arrays and keys: the values agree exactly (an
index only moves numbers), the shapes too, and the raising cases raise
alike.  The port's index tensors are ``int64``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from numpyro_tpu.ops.indexing import Vindex as JVindex
from numpyro_tpu.ops.indexing import vindex as jvindex
from numpyro_tpu_torch.ops.indexing import Vindex, vindex

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
X = RNG.normal(size=(4, 5, 6)).astype(np.float32)
B = RNG.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)


def _i(*shape, high):
    return RNG.integers(0, high, size=shape)


# (array, keys) with numpy integer arrays as the index tensors
CASES = {
    "int": (X, (1,)),
    "not a tuple": (X, 2),
    "empty": (X, ()),
    "ellipsis alone": (X, (Ellipsis,)),
    "one batched key": (X, (_i(3, high=4),)),
    "two batched keys": (X, (_i(3, 1, high=4), _i(2, high=5))),
    "colon in the middle": (X, (_i(7, high=4), slice(None), _i(7, high=6))),
    "colon first": (X, (slice(None), _i(2, 1, high=5), _i(3, high=6))),
    "leading ellipsis": (B, (Ellipsis, _i(3, high=4), slice(None), _i(3, high=6))),
    "leading ellipsis, two batched keys": (X, (Ellipsis, _i(2, 1, high=5), _i(4, high=6))),
    "enumerated (annotation.py)": (X, (np.arange(4), np.arange(5).reshape(5, 1, 1),
                                       slice(None))),
    "scalar keys": (X, (np.int64(1), np.int64(2), slice(None))),
    "keys then the rest": (B, (_i(4, high=2), _i(4, high=3))),
}


def _pair(keys):
    conv_j = tuple(jnp.asarray(k) if isinstance(k, np.ndarray) else k for k in keys) \
        if isinstance(keys, tuple) else keys
    conv_t = tuple(torch.as_tensor(k) if isinstance(k, np.ndarray) else k for k in keys) \
        if isinstance(keys, tuple) else keys
    return conv_j, conv_t


@pytest.mark.parametrize("name", sorted(CASES))
def test_vindex_matches_jax(name):
    arr, keys = CASES[name]
    keys_j, keys_t = _pair(keys)
    out_j = np.asarray(jvindex(jnp.asarray(arr), keys_j))
    out_t = vindex(torch.as_tensor(arr), keys_t)
    assert tuple(out_t.shape) == out_j.shape
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    np.testing.assert_array_equal(Vindex(torch.as_tensor(arr))[keys_t].numpy(), out_j)
    np.testing.assert_array_equal(np.asarray(JVindex(jnp.asarray(arr))[keys_j]), out_j)


def test_vindex_under_vmap_matches_jax():
    """The array batched over a leading axis of chains under ``vmap``, the
    keys not: the enumerated index of ``examples/annotation.py``."""
    beta = RNG.normal(size=(8, 5, 3, 3)).astype(np.float32)
    positions, c = np.arange(5), np.arange(3).reshape(3, 1, 1)
    out_j = jax.vmap(lambda b: JVindex(b)[jnp.asarray(positions), jnp.asarray(c), :])(
        jnp.asarray(beta))
    out_t = torch.func.vmap(lambda b: Vindex(b)[torch.as_tensor(positions),
                                                torch.as_tensor(c), :])(torch.as_tensor(beta))
    assert tuple(out_t.shape) == out_j.shape == (8, 3, 1, 5, 3)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_vindex_with_batched_keys_under_vmap_matches_jax():
    idx = RNG.integers(0, 4, size=(8, 3))
    out_j = jax.vmap(lambda i: jvindex(jnp.asarray(X), (i, slice(None), 0)))(jnp.asarray(idx))
    out_t = torch.func.vmap(lambda i: vindex(torch.as_tensor(X), (i, slice(None), 0)))(
        torch.as_tensor(idx))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("keys", [
    (np.arange(2), Ellipsis, slice(None)),
    (np.arange(2), slice(1, 3), np.arange(2)),
    (np.arange(2), slice(None, None, 2), np.arange(2)),
])
def test_vindex_raises_as_jax(keys):
    keys_j, keys_t = _pair(keys)
    with pytest.raises(NotImplementedError):
        jvindex(jnp.asarray(X), keys_j)
    with pytest.raises(NotImplementedError):
        vindex(torch.as_tensor(X), keys_t)


def test_slices_become_int64_aranges():
    out = vindex(torch.as_tensor(X), (torch.tensor([0, 1]), slice(None), torch.tensor([2, 3])))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 5)
    np.testing.assert_array_equal(out.numpy(), X[[0, 1]][:, :, [2, 3]].diagonal(0, 0, 2).T)
