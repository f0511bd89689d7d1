"""The port's truncated family against the JAX package's: ``log_prob``,
``sample`` on JAX's draws, ``mean`` and ``variance`` where the JAX class has
them, ``cdf``/``icdf`` of the power laws, on the JAX package's cases
(``tests/test_distributions_sweep.py::SPECS`` and
``tests/test_truncated*``), ``TruncatedNormal``'s far tails, and
``DoublyTruncatedPowerLaw`` at ``alpha = -1`` with a finite gradient.
Tolerance: rtol 1e-5, atol 1e-6, unless a test says why not."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch.distributions as dist

from torch_draws import FedDraws

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny)
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


LOC = np.array([0.5, -0.3, 1.2], np.float32)
SCALE = np.array([1.0, 0.7, 2.0], np.float32)

# name, base, kwargs of the factory
CASES = [
    ("normal_two_sided", "Normal", dict(low=-1.0, high=2.0)),
    ("normal_left", "Normal", dict(low=0.1)),
    ("normal_right", "Normal", dict(high=0.4)),
    ("cauchy_left", "Cauchy", dict(low=-2.0)),
    ("cauchy_two_sided", "Cauchy", dict(low=-1.0, high=3.0)),
    ("laplace_left", "Laplace", dict(low=0.9)),
    ("logistic_right", "Logistic", dict(high=-0.2)),
]


def _make(base, kw):
    d_j = jdist.TruncatedDistribution(getattr(jdist, base)(LOC, SCALE), **kw)
    d_t = dist.TruncatedDistribution(getattr(dist, base)(_t(LOC), _t(SCALE)), **kw)
    return d_j, d_t


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_truncated_matches_jax(case):
    _, base, kw = case
    d_j, d_t = _make(base, kw)
    assert type(d_t).__name__ == type(d_j).__name__ and d_t.batch_shape == d_j.batch_shape
    key = random.PRNGKey(3)
    want = np.asarray(d_j.sample(key, (6,)))
    draws = FedDraws([("uniforms", random.uniform(key, (6, 3), minval=TINY))])
    got = d_t.sample(draws, (6,))
    # the inverse cdf of a Cauchy (tan) and a Logistic amplify the f32
    # rounding of the window near its ends to 1e-5
    _close(got, want, rtol=3e-5, atol=1e-5)
    assert bool(d_t.support(got).all())
    _close(d_t.log_prob(_t(want)), d_j.log_prob(want))
    for attr in ("mean", "variance"):
        try:
            expect = np.asarray(getattr(d_j, attr))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                getattr(d_t, attr)
            continue
        _close(getattr(d_t, attr), expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("side", ["low", "high"])
def test_truncated_normal_far_tails(side):
    """``low = 5`` and ``high = -5`` on a standard normal: the left frame
    flip keeps the mass finite, and the right truncation reads ndtr's left
    tail."""
    kw = {"low": 5.0} if side == "low" else {"high": -5.0}
    d_j = jdist.TruncatedNormal(0.0, 1.0, **kw)
    d_t = dist.TruncatedNormal(torch.tensor(0.0), torch.tensor(1.0), **kw)
    x = np.array([5.0, 5.3, 6.0, 8.0], np.float32) * (1 if side == "low" else -1)
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x))
    assert torch.isfinite(d_t.log_prob(_t(x))).all()
    _close(d_t.mean, d_j.mean)
    _close(d_t.variance, d_j.variance, rtol=1e-4)  # a difference of near-equal terms
    key = random.PRNGKey(0)
    want = np.asarray(d_j.sample(key, (8,)))
    got = d_t.sample(FedDraws([("uniforms", random.uniform(key, (8,), minval=TINY))]), (8,))
    _close(got, want, rtol=1e-5)
    assert torch.isfinite(got).all() and bool(d_t.support(got).all())


def test_base_narrower_than_the_bounds():
    """A departure: the JAX package fails to read an expanded base's ``loc``
    here; the port broadcasts the base against the bounds."""
    low = np.array([0.0, 1.0], np.float32)
    d_t = dist.TruncatedNormal(0.0, 1.0, low=_t(low))
    assert d_t.batch_shape == (2,)
    for lo in low:
        one = jdist.TruncatedNormal(0.0, 1.0, low=float(lo))
        _close(d_t.log_prob(_t([1.5, 1.5]))[int(lo)], one.log_prob(1.5))
    with pytest.raises(AttributeError):
        jdist.TruncatedNormal(0.0, 1.0, low=jnp.asarray(low)).log_prob(jnp.array([1.5, 1.5]))


def test_truncated_polya_gamma_matches_jax():
    d_j, d_t = jdist.TruncatedPolyaGamma(batch_shape=(3,)), dist.TruncatedPolyaGamma(
        batch_shape=(3,))
    x = np.array([0.05, 0.4, 1.2, 2.4], np.float32)[:, None] * np.ones(3, np.float32)
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x), rtol=2e-5)
    key = random.PRNGKey(5)
    want = np.asarray(d_j.sample(key, (4,)))
    # the JAX class draws its gammas with the batch dims first
    ones = jnp.ones((3, 4, 8))
    got = d_t.sample(FedDraws([("gammas", random.gamma(key, ones))]), (4,))
    _close(got, want)


POWER_LAWS = [
    ("LowerTruncatedPowerLaw", dict(alpha=[-2.5, -1.5, -4.0], low=[0.5, 1.0, 2.0])),
    ("DoublyTruncatedPowerLaw", dict(alpha=[-2.0, 0.5, -1.0], low=[0.5, 0.1, 1.0],
                                     high=[3.0, 2.0, 10.0])),
]


@pytest.mark.parametrize("name,params", POWER_LAWS, ids=[p[0] for p in POWER_LAWS])
def test_power_laws_match_jax(name, params):
    d_j = getattr(jdist, name)(**{k: jnp.asarray(v, jnp.float32) for k, v in params.items()})
    d_t = getattr(dist, name)(**{k: _t(v) for k, v in params.items()})
    key = random.PRNGKey(2)
    want = np.asarray(d_j.sample(key, (5,)))
    got = d_t.sample(FedDraws([("uniforms", random.uniform(key, (5, 3)))]), (5,))
    _close(got, want, rtol=2e-5)
    _close(d_t.log_prob(_t(want)), d_j.log_prob(want))
    _close(d_t.cdf(_t(want)), d_j.cdf(want), atol=2e-6)
    q = np.linspace(0.05, 0.95, 15, dtype=np.float32).reshape(5, 3)
    _close(d_t.icdf(_t(q)), d_j.icdf(q), rtol=2e-5)
    _close(d_t.icdf(d_t.cdf(_t(want))), want, rtol=1e-4)
    if name == "LowerTruncatedPowerLaw":
        _close(d_t.mean, d_j.mean)
        _close(d_t.variance, d_j.variance)


def test_doubly_truncated_power_law_at_alpha_minus_one_has_a_finite_gradient():
    """The masked branch: at alpha == -1 the log normalizer is log(high /
    low), and the gradient in every parameter is finite and matches JAX's."""
    x = np.array([1.5, 2.5], np.float32)

    def lp_j(alpha, low, high):
        return jdist.DoublyTruncatedPowerLaw(alpha, low, high).log_prob(x).sum()

    want = jax.grad(lp_j, argnums=(0, 1, 2))(-1.0, 1.0, 4.0)
    params = [torch.tensor(v, requires_grad=True) for v in (-1.0, 1.0, 4.0)]
    lp = dist.DoublyTruncatedPowerLaw(*params).log_prob(_t(x)).sum()
    _close(lp, lp_j(-1.0, 1.0, 4.0))
    lp.backward()
    for p, w in zip(params, want):
        assert torch.isfinite(p.grad)
        _close(p.grad, w, rtol=1e-5, atol=1e-6)
