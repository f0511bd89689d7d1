"""``handlers.block`` with a hidden sample site, and sampling from an
``ExpandedDistribution`` whose size-1 batch dims grow, against the JAX package.

The two packages draw different numbers from the same seed, so shapes, traces
and ``log_prob`` of numpy-made values are compared exactly and draws by their
distribution.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

import numpyro_tpu as jnpt
import numpyro_tpu.distributions as jdist
import numpyro_tpu.handlers as jhandlers
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers

torch.set_num_threads(1)

N_DRAWS = 4000
# mean of N_DRAWS unit normals: five standard errors
MEAN_TOL = 5.0 / np.sqrt(N_DRAWS)


def _model(lib, d, hide):
    def model():
        with hide():
            a = lib.sample("a", d.Normal(0.0, 1.0).expand((N_DRAWS,)))
        b = lib.sample("b", d.Normal(3.0, 1.0))
        return a, b
    return model


def _traces(seed):
    tr_j = jhandlers.trace(jhandlers.seed(
        _model(jnpt, jdist, lambda: jhandlers.block()), random.PRNGKey(seed)))
    tr_t = handlers.trace(handlers.seed(
        _model(npt, dist, lambda: handlers.block()), seed))
    return tr_j, tr_t


def test_block_hides_the_site_and_still_draws_it():
    tr_j, tr_t = _traces(0)
    assert list(tr_t.get_trace()) == list(tr_j.get_trace()) == ["b"]
    (a_j, _), (a_t, _) = tr_j(), tr_t()
    assert tuple(a_t.shape) == tuple(a_j.shape) == (N_DRAWS,)
    # the hidden site drew from the outer seed, in both packages, from N(0, 1)
    for a in (np.asarray(a_j), a_t.numpy()):
        assert abs(a.mean()) < MEAN_TOL and abs(a.std() - 1.0) < MEAN_TOL


def test_block_hidden_draw_follows_the_seed():
    a0 = _traces(0)[1]()[0]
    a0_again = _traces(0)[1]()[0]
    a1 = _traces(1)[1]()[0]
    assert torch.equal(a0, a0_again) and not torch.equal(a0, a1)


@pytest.mark.parametrize("kwargs", [dict(hide=["a"]), dict(expose=["b"]),
                                    dict(hide_fn=lambda msg: msg["name"] == "a")])
def test_block_selectors_match_jax(kwargs):
    tr_j = jhandlers.trace(jhandlers.seed(
        _model(jnpt, jdist, lambda: jhandlers.block(**kwargs)), random.PRNGKey(2)))
    tr_t = handlers.trace(handlers.seed(
        _model(npt, dist, lambda: handlers.block(**kwargs)), 2))
    assert list(tr_t.get_trace()) == list(tr_j.get_trace()) == ["b"]


def test_block_passes_an_explicit_generator_through():
    gen = torch.Generator().manual_seed(7)
    want = dist.Normal(0.0, 1.0).sample(torch.Generator().manual_seed(7), (3,))

    def model():
        with handlers.block():
            return npt.sample("a", dist.Normal(0.0, 1.0), rng_key=gen, sample_shape=(3,))

    assert torch.equal(handlers.seed(model, 0)(), want)


def test_prng_key_is_the_seed_handlers_generator():
    assert npt.primitives.prng_key() is None
    gen = torch.Generator().manual_seed(3)
    with handlers.seed(rng_seed=gen):
        assert npt.primitives.prng_key() is gen
        with handlers.block():  # prng_key messages pass a block
            assert npt.primitives.prng_key() is gen


# (base batch shape, expanded batch shape, sample shape)
EXPAND_CASES = [
    ((1,), (5,), ()),
    ((1,), (5,), (7,)),
    ((2, 1), (2, 6), (3,)),
    ((1, 3), (4, 3), ()),
    ((1, 1), (4, 5), (2,)),
    ((2, 1), (3, 2, 6), (2,)),
    ((3,), (4, 3), (2,)),
    ((), (4,), ()),
]


@pytest.mark.parametrize("base,target,sample_shape", EXPAND_CASES)
def test_expanded_sample_shapes_and_log_prob_match_jax(base, target, sample_shape):
    rng = np.random.default_rng(0)
    loc = rng.standard_normal(base).astype(np.float32)
    d_j = jdist.Normal(jnp.asarray(loc), 1.5).expand(target)
    d_t = dist.Normal(torch.from_numpy(loc), 1.5).expand(target)
    x_j = d_j.sample(random.PRNGKey(0), sample_shape)
    x_t = d_t.sample(torch.Generator().manual_seed(0), sample_shape)
    assert tuple(x_t.shape) == tuple(x_j.shape) == sample_shape + target
    value = rng.standard_normal(sample_shape + target).astype(np.float32)
    np.testing.assert_allclose(
        d_t.log_prob(torch.from_numpy(value)).numpy(),
        np.asarray(d_j.log_prob(jnp.asarray(value))), rtol=1e-6, atol=1e-6)


def test_expanded_sample_draws_each_grown_entry_afresh():
    loc = np.array([[0.0], [50.0]], np.float32)  # (2, 1) grows to (2, N_DRAWS)
    d_j = jdist.Normal(jnp.asarray(loc), 1.0).expand((2, N_DRAWS))
    d_t = dist.Normal(torch.from_numpy(loc), 1.0).expand((2, N_DRAWS))
    x_j = np.asarray(d_j.sample(random.PRNGKey(1)))
    x_t = d_t.sample(torch.Generator().manual_seed(1)).numpy()
    for x in (x_j, x_t):
        # rows keep their own location; along the grown axis the draws differ
        np.testing.assert_allclose(x.mean(1), loc[:, 0], atol=MEAN_TOL)
        np.testing.assert_allclose(x.std(1), 1.0, atol=MEAN_TOL)
        assert len(np.unique(x[0])) > N_DRAWS // 2


def test_expanded_event_distribution_grows_its_batch():
    loc = np.zeros((1, 3), np.float32)
    d_j = jdist.Normal(jnp.asarray(loc), 1.0).to_event(1).expand((4,))
    d_t = dist.Normal(torch.from_numpy(loc), 1.0).to_event(1).expand((4,))
    x_j = d_j.sample(random.PRNGKey(0), (2,))
    x_t = d_t.sample(torch.Generator().manual_seed(0), (2,))
    assert tuple(x_t.shape) == tuple(x_j.shape) == (2, 4, 3)
    assert not torch.equal(x_t[:, 0], x_t[:, 1])
    value = np.random.default_rng(1).standard_normal((2, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        d_t.log_prob(torch.from_numpy(value)).numpy(),
        np.asarray(d_j.log_prob(jnp.asarray(value))), rtol=1e-6, atol=1e-6)
