"""The port's Bernoulli and ``mask`` against the JAX package's on the same
numpy inputs (log-probs to rtol 1e-6; sample frequencies against the
probabilities within four standard errors)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions import constraints

torch.set_num_threads(1)
RTOL = 1e-6


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    logits = (4.0 * rng.standard_normal(n)).astype(np.float32)
    logits[:4] = [0.0, 30.0, -30.0, 1e-3]
    value = (rng.random(n) < 0.5).astype(np.float32)
    return logits, value


@pytest.mark.parametrize("int_value", [False, True])
def test_bernoulli_logits_log_prob_matches_jax(int_value):
    logits, value = _inputs()
    v_np = value.astype(np.int32) if int_value else value
    want = jdist.Bernoulli(logits=jnp.asarray(logits)).log_prob(jnp.asarray(v_np))
    got = dist.Bernoulli(logits=torch.from_numpy(logits)).log_prob(torch.from_numpy(v_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-30)


def test_bernoulli_probs_log_prob_and_logits_match_jax():
    logits, value = _inputs(1)
    probs = (1 / (1 + np.exp(-logits))).astype(np.float32)
    probs[:2] = [0.0, 1.0]
    value[:2] = [0.0, 1.0]
    d_j = jdist.Bernoulli(probs=jnp.asarray(probs))
    d_t = dist.Bernoulli(probs=torch.from_numpy(probs))
    assert isinstance(d_t, dist.BernoulliProbs)
    np.testing.assert_allclose(
        d_t.log_prob(torch.from_numpy(value)).numpy(),
        np.asarray(d_j.log_prob(jnp.asarray(value))), rtol=RTOL, atol=1e-30,
    )
    np.testing.assert_allclose(d_t.logits.numpy(), np.asarray(d_j.logits), rtol=1e-5)


def test_bernoulli_factory_and_support():
    with pytest.raises(ValueError):
        dist.Bernoulli()
    with pytest.raises(ValueError):
        dist.Bernoulli(probs=torch.tensor(0.5), logits=torch.tensor(0.0))
    d = dist.Bernoulli(logits=torch.zeros(3))
    assert isinstance(d, dist.BernoulliLogits) and d.batch_shape == (3,)
    assert d.support is constraints.boolean and d.support.is_discrete and d.is_discrete
    assert not dist.Normal(0.0, 1.0).is_discrete
    np.testing.assert_array_equal(
        constraints.boolean(torch.tensor([0.0, 1.0, 2.0, 0.5])).numpy(), [True, True, False, False]
    )
    # the support on a leading axis, as the JAX package lays it out
    want = jdist.Bernoulli(logits=jnp.zeros(3)).enumerate_support(expand=False)
    assert d.has_enumerate_support and jdist.Bernoulli(logits=jnp.zeros(3)).has_enumerate_support
    np.testing.assert_array_equal(d.enumerate_support(expand=False).numpy(), np.asarray(want))
    assert d.enumerate_support().shape == (2, 3)


def test_mask_matches_jax():
    logits, value = _inputs(2)
    keep = np.random.default_rng(3).random(logits.shape) < 0.5
    d_j = jdist.Bernoulli(logits=jnp.asarray(logits))
    d_t = dist.Bernoulli(logits=torch.from_numpy(logits))
    v_j, v_t = jnp.asarray(value), torch.from_numpy(value)
    assert d_t.mask(True) is d_t
    off = d_t.mask(False)
    assert isinstance(off, dist.MaskedDistribution) and off.batch_shape == d_t.batch_shape
    np.testing.assert_array_equal(off.log_prob(v_t).numpy(), np.asarray(d_j.mask(False).log_prob(v_j)))
    assert off.log_prob(v_t).dtype == torch.float32 and not off.log_prob(v_t).any()
    np.testing.assert_allclose(
        d_t.mask(torch.from_numpy(keep)).log_prob(v_t).numpy(),
        np.asarray(d_j.mask(jnp.asarray(keep)).log_prob(v_j)), rtol=RTOL,
    )
    # an event-shaped base: the mask covers batch dims only
    n_j = jdist.Normal(jnp.asarray(logits.reshape(8, 8)), 1.0).to_event(1)
    n_t = dist.Normal(torch.from_numpy(logits.reshape(8, 8)), 1.0).to_event(1)
    k = keep[:8]
    np.testing.assert_allclose(
        n_t.mask(torch.from_numpy(k)).log_prob(torch.from_numpy(value.reshape(8, 8))).numpy(),
        np.asarray(n_j.mask(jnp.asarray(k)).log_prob(jnp.asarray(value.reshape(8, 8)))),
        rtol=RTOL,
    )


def test_masked_log_prob_keeps_nan_out_of_the_gradient():
    """A masked-out entry outside the support must not reach the gradient."""
    loc = torch.zeros(3, requires_grad=True)
    value = torch.tensor([0.5, float("nan"), 1.5])
    lp = dist.Normal(loc, 1.0).mask(torch.tensor([True, False, True])).log_prob(value).sum()
    (grad,) = torch.autograd.grad(lp, loc)
    np.testing.assert_allclose(grad.numpy(), [0.5, 0.0, 1.5], rtol=RTOL)


def test_bernoulli_sample_frequencies():
    probs = np.array([0.05, 0.3, 0.5, 0.9], np.float32)
    n = 20000
    gen = torch.Generator().manual_seed(0)
    for d in (dist.Bernoulli(probs=torch.from_numpy(probs)),
              dist.Bernoulli(logits=torch.from_numpy(np.log(probs / (1 - probs))))):
        draws = d.sample(gen, (n,))
        assert draws.shape == (n, 4) and draws.dtype == torch.int64
        assert set(draws.unique().tolist()) == {0, 1}
        se = np.sqrt(probs * (1 - probs) / n)
        assert (np.abs(draws.float().mean(0).numpy() - probs) < 4 * se).all()


@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 3)])
def test_bernoulli_enumerate_support_matches_jax(batch_shape):
    """The support on a new leading axis, expanded over the batch or not,
    also through ``expand`` and ``mask`` as a plate and a mask wrap it."""
    logits = np.linspace(-2, 2, int(np.prod(batch_shape))).reshape(batch_shape).astype(np.float32)
    t = dist.Bernoulli(logits=torch.from_numpy(logits))
    j = jdist.Bernoulli(logits=jnp.asarray(logits))
    for expand in (False, True):
        np.testing.assert_array_equal(t.enumerate_support(expand).numpy(),
                                      np.asarray(j.enumerate_support(expand)))
    te = t.expand((4,) + batch_shape).mask(False)
    je = j.expand((4,) + batch_shape).mask(False)
    assert te.has_enumerate_support and je.has_enumerate_support
    np.testing.assert_array_equal(te.enumerate_support(False).numpy(),
                                  np.asarray(je.enumerate_support(False)))
    assert not dist.Normal(0.0, 1.0).has_enumerate_support
    with pytest.raises(NotImplementedError):
        dist.Normal(0.0, 1.0).enumerate_support()
