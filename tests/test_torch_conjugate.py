"""The port's conjugate families (``BetaBinomial``, ``DirichletMultinomial``,
``GammaPoisson``, ``NegativeBinomialProbs``/``Logits`` and the
``NegativeBinomial`` factory) against the JAX package's, on the same numpy
inputs: ``log_prob``, ``mean``, ``variance``, ``cdf``, ``entropy`` and
``enumerate_support`` where the JAX class has them (a raise where it has
not), ``sample`` on JAX's own draws (the mixing draw's gammas and the
counts, through ``tests/torch_draws.py``), the port's own draws against the
moments (4 standard errors) and the pmf, and the reparameterised gradient
of the mixing draw.  Parameters from ``tests/test_distributions.py``
(``SCIPY_CASES``) and ``tests/test_distributions_sweep.py`` (``SPECS``),
each widened to a batch of 3.  Tolerances: rtol 1e-5 and atol 1e-6 on
float32 values unless a case says why not."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.util import soft_vmap

from test_torch_discrete_families import _close, _moments_hold, _pmf_fit, _t
from test_torch_discrete_families import TEST_FAILURE_RATE
from torch_draws import FedDraws

torch.set_num_threads(1)


def _beta_binomial_draws(key, sample_shape, d):
    k_mix, k_obs = random.split(key)
    shape = sample_shape + d.batch_shape
    k1, k0 = random.split(k_mix)
    p = jdist.Beta(d.concentration1, d.concentration0).sample(k_mix, sample_shape)
    return [("gammas", jnp.exp(random.loggamma(k1, jnp.broadcast_to(d.concentration1, shape)))),
            ("gammas", jnp.exp(random.loggamma(k0, jnp.broadcast_to(d.concentration0, shape)))),
            ("binomials", jdist.BinomialProbs(p, total_count=d.total_count).sample(k_obs))]


def _gamma_poisson_draws(key, sample_shape, d):
    k_mix, k_obs = random.split(key)
    shape = sample_shape + d.batch_shape
    lam = jdist.Gamma(d.concentration, d.rate).sample(k_mix, sample_shape)
    return [("gammas", random.gamma(k_mix, jnp.broadcast_to(d.concentration, shape), shape)),
            ("poissons", random.poisson(k_obs, lam))]


def _dirichlet_multinomial_draws(key, sample_shape, d):
    k_mix, k_obs = random.split(key)
    shape = sample_shape + d.batch_shape
    n_max = int(np.max(np.asarray(d.total_count)))
    return [("gammas", random.gamma(k_mix, jnp.broadcast_to(d.concentration,
                                                             shape + d.event_shape))),
            ("uniforms", random.uniform(k_obs, (n_max,) + shape + (1,)))]


# name -> (params, draws fed to sample)
CASES = {
    "BetaBinomial": (dict(concentration1=2.0, concentration0=3.0, total_count=10.0),
                     _beta_binomial_draws),
    "GammaPoisson": (dict(concentration=2.0, rate=0.5), _gamma_poisson_draws),
    "NegativeBinomialProbs": (dict(total_count=4.0, probs=0.4), _gamma_poisson_draws),
    "NegativeBinomialLogits": (dict(total_count=4.0, logits=-0.4), _gamma_poisson_draws),
    "DirichletMultinomial": (dict(concentration=[1.0, 2.0, 3.0], total_count=8.0),
                             _dirichlet_multinomial_draws),
}


def _make(name, seed=0):
    rng = np.random.default_rng(seed)
    params = {}
    for k, v in CASES[name][0].items():
        v = np.asarray(v, np.float32)
        if k == "total_count" and not name.startswith("NegativeBinomial") or v.ndim:
            params[k] = np.broadcast_to(v, (3,) + v.shape).copy()
        elif k == "logits":
            params[k] = (v + rng.uniform(-0.5, 0.5, 3)).astype(np.float32)
        else:
            params[k] = (v * (1.0 + 0.3 * rng.uniform(-1.0, 1.0, 3))).astype(np.float32)
    d_j = getattr(jdist, name)(**{k: jnp.asarray(v) for k, v in params.items()})
    d_t = getattr(dist, name)(**{k: _t(v) for k, v in params.items()})
    return d_j, d_t, params


def _method(d, attr, *args):
    out = getattr(d, attr)
    return out(*args) if callable(out) else out


@pytest.mark.parametrize("name", list(CASES))
def test_methods_match_jax(name):
    d_j, d_t, _ = _make(name)
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape
    x = np.asarray(d_j.sample(random.PRNGKey(7), (4,)))
    _close(d_t.log_prob(torch.from_numpy(x.astype(np.int64))), d_j.log_prob(x), what="log_prob")
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x), what="log_prob of float counts")
    for attr, args in (("mean", ()), ("variance", ()), ("entropy", ()), ("cdf", (x,)),
                       ("icdf", (np.full((4, 3), 0.3, np.float32),))):
        try:
            want = np.asarray(_method(d_j, attr, *args))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                _method(d_t, attr, *(_t(a) for a in args))
            continue
        _close(_method(d_t, attr, *(_t(a) for a in args)), want, what=attr)
    assert d_t.has_enumerate_support == d_j.has_enumerate_support
    if d_j.has_enumerate_support:
        for expand in (False, True):
            np.testing.assert_array_equal(d_t.enumerate_support(expand).numpy(),
                                          np.asarray(d_j.enumerate_support(expand)))
    assert d_t.support.is_discrete and bool(d_t.support(torch.from_numpy(x)).all())
    assert set(d_t.arg_constraints) == set(d_j.arg_constraints)


@pytest.mark.parametrize("name", list(CASES))
def test_sample_on_jax_draws_equals_jax(name):
    d_j, d_t, _ = _make(name)
    key = random.PRNGKey(11)
    want = np.asarray(d_j.sample(key, (5,)))
    source = FedDraws(CASES[name][1](key, (5,), d_j))
    got = d_t.sample(source, (5,))
    assert not source.items and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", [n for n in CASES if n != "DirichletMultinomial"])
def test_own_draws_match_the_moments_and_the_pmf(name):
    _, d_t, _ = _make(name)
    x = d_t.sample(torch.Generator().manual_seed(5), (20_000,))
    assert x.dtype == torch.int64
    _moments_hold(x, d_t.mean, d_t.variance)
    assert _pmf_fit(d_t, x) > TEST_FAILURE_RATE


@pytest.mark.parametrize("name", list(CASES))
def test_draws_under_soft_vmap_differ_and_match_the_moments(name):
    """Each mapped element draws its own mixing value and counts from the
    shared generator."""
    _, d_t, _ = _make(name)
    gen = torch.Generator().manual_seed(6)
    x = soft_vmap(lambda _: d_t.sample(gen), torch.arange(8000), chunk_size=4000)
    assert x.shape == (8000,) + d_t.batch_shape + d_t.event_shape
    assert len(torch.unique(x.reshape(8000, -1), dim=0)) > 8
    _moments_hold(x, d_t.mean.expand(x.shape[1:]), d_t.variance.expand(x.shape[1:]))


def test_dirichlet_multinomial_draws_match_the_moments():
    _, d_t, _ = _make("DirichletMultinomial")
    x = d_t.sample(torch.Generator().manual_seed(5), (20_000,))
    assert bool((x.sum(-1) == 8).all())
    _moments_hold(x, d_t.mean, d_t.variance)


def test_negative_binomial_factory_and_mixing_gradient():
    x = np.array([0.0, 3.0, 9.0], np.float32)
    for kw in (dict(probs=0.4), dict(logits=-0.4)):
        d_t = dist.NegativeBinomial(_t(4.0), **{k: _t(v) for k, v in kw.items()})
        d_j = jdist.NegativeBinomial(4.0, **kw)
        assert type(d_t).__name__ == type(d_j).__name__
        _close(d_t.log_prob(_t(x)), d_j.log_prob(x))
    with pytest.raises(ValueError):
        dist.NegativeBinomial(4.0)
    # the Beta mixing draw of a BetaBinomial is reparameterised in its
    # concentrations through the gamma draws' exact derivative
    c1 = _t([2.0, 0.7]).requires_grad_()
    p = dist.Beta(c1, 3.0).sample(torch.Generator().manual_seed(0), (64,))
    p.sum().backward()
    assert torch.isfinite(c1.grad).all() and (c1.grad > 0).all()
