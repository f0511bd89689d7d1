"""The port's mixtures, Gaussian copulas and ``FoldedDistribution`` against
the JAX package's, on the same numpy inputs: ``MixtureSameFamily`` (over a
univariate, a ``MultivariateNormal`` and an ``Independent`` component, with a
batch), ``MixtureGeneral``, the ``Mixture`` factory, ``GaussianCopula``,
``GaussianCopulaBeta`` and ``FoldedDistribution``.  Their methods,
``sample`` on JAX's own draws (``tests/torch_draws.py``; the mixing draw is
``CategoricalLogits``' Gumbel draws), the port's own draws through its
``gof`` (``MixtureSameFamily``'s in ``tests/test_torch_structured.py``),
and the copulas' densities in the tails against a float64 reference.

Parameters follow ``tests/test_distributions_sweep.py``,
``tests/test_distributions.py``, ``tests/test_distributions_extra.py`` and
``tests/test_distributions_structured.py``.

Tolerances: rtol 1e-5 and atol 1e-6 on float32 values, unless a case says
why not.
"""

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions.gof import auto_goodness_of_fit

from torch_draws import FedDraws

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TEST_FAILURE_RATE = 5e-3
CORR = np.array([[1.0, 0.4], [0.4, 1.0]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _pair(make):
    return make(jdist, jnp.asarray), make(dist, _t)


def _msf(m, a):
    return m.MixtureSameFamily(m.CategoricalLogits(a([-0.4, 0.4])),
                               m.Normal(a([-1.0, 1.0]), a([0.5, 1.5])))


def _msf_probs(m, a):
    return m.MixtureSameFamily(m.CategoricalProbs(a([0.3, 0.7])),
                               m.Normal(a([-1.0, 2.0]), a([1.0, 0.5])))


def _msf_batched(m, a):
    rng = np.random.default_rng(0)
    return m.MixtureSameFamily(m.CategoricalLogits(a(rng.normal(size=(3, 4)))),
                               m.Normal(a(rng.normal(size=(3, 4))), a(rng.uniform(0.5, 2, (3, 4)))))


def _msf_mvn(m, a):
    rng = np.random.default_rng(1)
    return m.MixtureSameFamily(m.CategoricalLogits(a([0.2, -0.3, 0.5])),
                               m.MultivariateNormal(a(rng.normal(size=(3, 2))),
                                                    covariance_matrix=a(np.stack([
                                                        np.eye(2), [[2.0, 0.5], [0.5, 1.0]],
                                                        0.5 * np.eye(2)]))))


def _msf_independent(m, a):
    rng = np.random.default_rng(2)
    comp = m.Normal(a(rng.normal(size=(2, 3))), a(rng.uniform(0.5, 1.5, (2, 3)))).to_event(1)
    return m.MixtureSameFamily(m.CategoricalLogits(a([0.1, -0.1])), comp)


def _mg(m, a):
    return m.MixtureGeneral(m.CategoricalLogits(a([0.3, -0.2])),
                            [m.Normal(a(-1.0), a(0.7)), m.StudentT(a(4.0), a(1.0), a(1.0))])


def _mg_mvn(m, a):
    return m.MixtureGeneral(m.CategoricalLogits(a([0.3, -0.2])),
                            [m.MultivariateNormal(a([0.0, 1.0]), scale_tril=a(np.eye(2))),
                             m.MultivariateNormal(a([1.0, -1.0]),
                                                  covariance_matrix=a([[2.0, 0.5], [0.5, 1.0]]))])


def _folded(m, a):
    return m.FoldedDistribution(m.Normal(a([0.5, -1.0, 2.0]), a([1.0, 0.5, 2.0])))


def _copula_normal(m, a):
    return m.GaussianCopula(m.Normal(a([0.5, -1.0]), a([1.0, 2.0])), correlation_matrix=a(CORR))


def _copula(m, a):
    return m.GaussianCopula(m.Beta(a(2.0), a(3.0)), correlation_matrix=a(CORR))


def _copula_beta(m, a):
    return m.GaussianCopulaBeta(a([2.0, 3.0]), a([3.0, 2.0]),
                                correlation_cholesky=a(np.linalg.cholesky(CORR)))


def _gumbels(key, shape, k):
    return [("gumbels", random.gumbel(key, shape + (k,)))]


def _msf_draws(key, shape, d):
    k_comp, k_pick = random.split(key)
    comp = d.component_distribution
    comp_shape = shape + (d.mixture_size,)
    if isinstance(comp, jdist.MultivariateNormal) or hasattr(comp, "base_dist"):
        draws = [("normals", random.normal(k_comp, comp_shape + d.event_shape))]
    else:
        draws = [("normals", random.normal(k_comp, comp_shape))]
    return draws + _gumbels(k_pick, shape, d.mixture_size)


def _mg_draws(key, shape, d):
    k_comp, k_pick = random.split(key)
    draws = []
    for k, comp in zip(random.split(k_comp, d.mixture_size), d.component_distributions):
        if isinstance(comp, jdist.StudentT):
            k_eps, k_mix = random.split(k)
            draws += [("normals", random.normal(k_eps, shape)),
                      ("gammas", jnp.exp(random.loggamma(k_mix, jnp.broadcast_to(
                          comp.df / 2.0, shape), shape)))]
        else:
            draws.append(("normals", random.normal(k, shape + comp.event_shape)))
    return draws + _gumbels(k_pick, shape, d.mixture_size)


def _normals(key, shape, d):
    return [("normals", random.normal(key, shape + d.event_shape))]


# name -> (the pair, the JAX draws of a sample; None where the JAX sampler
# draws otherwise than the port's: CategoricalProbs inverts its cdf)
CASES = {
    "MixtureSameFamily": (_msf, _msf_draws),
    "MixtureSameFamily probs": (_msf_probs, None),
    "MixtureSameFamily batched": (_msf_batched, _msf_draws),
    "MixtureSameFamily MultivariateNormal": (_msf_mvn, _msf_draws),
    "MixtureSameFamily Independent": (_msf_independent, _msf_draws),
    "MixtureGeneral": (_mg, _mg_draws),
    "MixtureGeneral MultivariateNormal": (_mg_mvn, _mg_draws),
    "FoldedDistribution": (_folded, _normals),
    "GaussianCopula Normal": (_copula_normal, _normals),
    "GaussianCopula": (_copula, _normals),
    "GaussianCopulaBeta": (_copula_beta, _normals),
}


def _method(d, attr, *args):
    out = getattr(d, attr)
    return out(*args) if callable(out) else out


@pytest.mark.parametrize("name", list(CASES))
def test_methods_match_jax(name):
    d_j, d_t = _pair(CASES[name][0])
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape
    x = np.asarray(d_j.sample(random.PRNGKey(7), (4,)))
    # the copulas' densities go through a float64 betainc in the port and a
    # float32 one in JAX (1e-5 relative off scipy, test_torch_special.py):
    # atol 1e-4 there
    atol = 1e-4 if "Copula" in name else 1e-5
    _close(d_t.log_prob(_t(x)), d_j.log_prob(jnp.asarray(x)), rtol=RTOL, atol=atol,
           what="log_prob")
    for attr, args in (("mean", ()), ("variance", ()), ("entropy", ()), ("cdf", (x,)),
                       ("icdf", (x,))):
        try:
            want = np.asarray(_method(d_j, attr, *args))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                _method(d_t, attr, *(_t(a) for a in args))
            continue
        _close(_method(d_t, attr, *(_t(a) for a in args)), want, atol=1e-5, what=attr)
    if "Mixture" in name:
        _close(d_t.component_log_probs(_t(x)), d_j.component_log_probs(jnp.asarray(x)),
               atol=1e-5)
        assert d_t.mixture_size == d_j.mixture_size and d_t.mixture_dim == d_j.mixture_dim
    if "Copula" in name:
        _close(d_t.correlation_matrix, d_j.correlation_matrix, atol=1e-6)
        _close(d_t.correlation_cholesky, d_j.correlation_cholesky, atol=1e-6)
    assert d_t.has_rsample == d_j.has_rsample
    assert type(d_t.support).__name__ == type(d_j.support).__name__
    assert d_t.support.event_dim == d_j.support.event_dim
    assert d_t.is_discrete == d_j.is_discrete


SAMPLED = [n for n in CASES if CASES[n][1] is not None]


@pytest.mark.parametrize("name", SAMPLED)
def test_sample_on_jax_draws_equals_jax(name):
    d_j, d_t = _pair(CASES[name][0])
    key = random.PRNGKey(11)
    want = np.asarray(d_j.sample(key, (5,)))
    source = FedDraws(CASES[name][1](key, (5,) + d_j.batch_shape, d_j))
    got, picks = d_t.sample_with_intermediates(source, (5,))
    assert not source.items
    # the Beta marginal's icdf bisects, 60 halvings in both packages, on a
    # float64 cdf in the port and a float32 one in JAX: atol 1e-5 there
    _close(got, want, atol=1e-5 if "Copula" in name else ATOL)
    if "Mixture" in name:
        _, picks_j = d_j.sample_with_intermediates(key, (5,))
        np.testing.assert_array_equal(picks[0].numpy(), np.asarray(picks_j[0]))


def test_mixture_factory_and_its_checks_match_jax():
    comps = [dist.Normal(_t(0.0), _t(1.0)), dist.Normal(_t(2.0), _t(0.5))]
    mixing = dist.Categorical(logits=_t([0.1, -0.1]))
    assert type(dist.Mixture(mixing, comps)) is dist.MixtureGeneral
    assert type(dist.Mixture(mixing, dist.Normal(_t([0.0, 2.0]), _t(1.0)))) \
        is dist.MixtureSameFamily
    with pytest.raises(ValueError):
        dist.MixtureSameFamily(dist.Normal(_t(0.0), _t(1.0)), dist.Normal(_t([0.0, 1.0]), 1.0))
    with pytest.raises(ValueError):
        dist.MixtureSameFamily(mixing, dist.Normal(_t([0.0, 1.0, 2.0]), 1.0))
    with pytest.raises(ValueError):
        dist.MixtureGeneral(mixing, comps[:1])
    with pytest.raises(ValueError):
        dist.MixtureGeneral(mixing, [comps[0], dist.Exponential(_t(1.0))])
    mixed = dist.MixtureGeneral(mixing, [comps[0], dist.Exponential(_t(1.0))],
                                support=dist.constraints.real)
    assert mixed.support is dist.constraints.real


def test_folded_normal_is_scipys_and_its_draws_pass_gof():
    _, d_t = _pair(_folded)
    x = np.linspace(0.05, 4.0, 7)[:, None] * np.ones(3)
    want = np.stack([st.foldnorm(abs(m) / s, scale=s).logpdf(x[:, i])
                     for i, (m, s) in enumerate([(0.5, 1.0), (-1.0, 0.5), (2.0, 2.0)])], -1)
    _close(d_t.log_prob(_t(x)), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        dist.FoldedDistribution(dist.Normal(torch.zeros(2), 1.0).to_event(1))
    d = dist.FoldedDistribution(dist.Normal(_t(0.5), _t(1.0)))
    y = d.sample(torch.Generator().manual_seed(4), (20_000,))
    assert bool((y >= 0).all())
    assert auto_goodness_of_fit(y.double(), d.log_prob(y).exp().double()) > TEST_FAILURE_RATE


def _copula_reference(a, b, corr, x):
    """The Gaussian copula density of Beta(a, b) marginals, float64 scipy."""
    q = st.norm.ppf(st.beta(a, b).cdf(x))
    return (st.beta(a, b).logpdf(x).sum(-1) + st.multivariate_normal(
        np.zeros(x.shape[-1]), corr).logpdf(q) - st.norm.logpdf(q).sum(-1))


def test_copula_beta_tails_against_float64():
    """At the draws of the JAX package's tests (keys 7 and 8) and at points
    in both tails, against a float64 reference.  Where every marginal cdf
    is below 0.99 the port's density is within 1e-5 relative (atol 1e-5)
    of it, and its largest error there is below the JAX package's, whose
    float32 ``betainc`` and ``ndtri`` are up to 6e-6 off on the draws (the
    port 8e-7) and 2e-5 in the lower tails (the port 9e-6).  Where a
    marginal cdf passes 0.99 it rounds towards 1 in float32 and is clipped
    at ``1 - eps`` in both packages, which compute the same there (atol
    1e-4): 4.3 nats off the reference at (0.999, 0.3) (ROADMAP.md, Queue
    3)."""
    a, b = np.array([2.0, 3.0]), np.array([3.0, 2.0])
    corr = np.array([[1.0, 0.7], [0.7, 1.0]])
    d_j = jdist.GaussianCopulaBeta(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                                   correlation_matrix=jnp.asarray(corr, jnp.float32))
    d_t = dist.GaussianCopulaBeta(_t(a), _t(b), correlation_matrix=_t(corr))
    draws = np.asarray(d_j.sample(random.PRNGKey(7), (50,)), np.float64)
    tails = np.array([[1e-4, 0.5], [0.999, 0.3], [0.02, 0.995], [0.9999, 0.9999],
                      [1e-3, 1e-3], [0.5, 5e-4], [0.99, 0.98], [1e-5, 0.4]])
    x = np.concatenate([draws, tails]).astype(np.float32)
    x64 = x.astype(np.float64)
    want = _copula_reference(a, b, corr, x64)
    got = d_t.log_prob(_t(x)).double().numpy()
    jax_lp = np.asarray(d_j.log_prob(jnp.asarray(x)), np.float64)
    upper = (st.beta(a, b).cdf(x64) > 0.99).any(-1)
    assert upper.sum() == 4
    np.testing.assert_allclose(got[~upper], want[~upper], rtol=1e-5, atol=1e-5)
    err_t, err_j = np.abs(got - want), np.abs(jax_lp - want)
    assert err_t[~upper].max() < err_j[~upper].max()
    np.testing.assert_allclose(got[upper], jax_lp[upper], rtol=1e-5, atol=1e-4)
    assert err_t[upper].max() > 1.0
    # the independent case of test_distributions_extra.py is a product of
    # Beta densities
    ind = dist.GaussianCopulaBeta(_t(np.full(3, 2.0)), _t(np.full(3, 2.0)),
                                  correlation_matrix=torch.eye(3))
    y = np.asarray(jdist.GaussianCopulaBeta(jnp.full(3, 2.0), jnp.full(3, 2.0),
                                            correlation_matrix=jnp.eye(3)).sample(
        random.PRNGKey(8), (50,)), np.float64)
    _close(ind.log_prob(_t(y)), st.beta(2, 2).logpdf(y).sum(-1), rtol=1e-5, atol=1e-5)


def test_copula_marginals_of_own_draws_pass_gof():
    _, d_t = _pair(_copula_beta)
    x = d_t.sample(torch.Generator().manual_seed(9), (8000,)).double()
    for i, (a, b) in enumerate([(2.0, 3.0), (3.0, 2.0)]):
        assert auto_goodness_of_fit(x[:, i], st.beta(a, b).pdf(x[:, i].numpy())) \
            > TEST_FAILURE_RATE
    assert np.corrcoef(x.numpy().T)[0, 1] > 0.3


def test_copula_reparameterised_gradient_matches_jax():
    """``GaussianCopula`` with normal marginals: the gradient of a weighted
    sum of draws in the correlation factor and the marginals' parameters,
    on JAX's normals (rtol 1e-5, atol 1e-5)."""
    key = random.PRNGKey(13)
    tril = np.linalg.cholesky(CORR).astype(np.float32)
    params = {"loc": np.array([0.5, -1.0], np.float32), "scale": np.array([1.0, 2.0], np.float32),
              "tril": tril}
    weights = np.random.default_rng(1).uniform(0.5, 1.5, (6, 2)).astype(np.float32)

    def loss_j(p):
        d = jdist.GaussianCopula(jdist.Normal(p["loc"], p["scale"]),
                                 correlation_cholesky=p["tril"])
        return (d.sample(key, (6,)) * weights).sum()

    grads_j = jax.grad(loss_j)({k: jnp.asarray(v) for k, v in params.items()})
    leaves = {k: _t(v).requires_grad_() for k, v in params.items()}
    d_t = dist.GaussianCopula(dist.Normal(leaves["loc"], leaves["scale"]),
                              correlation_cholesky=leaves["tril"])
    (d_t.sample(FedDraws([("normals", random.normal(key, (6, 2)))]), (6,))
     * _t(weights)).sum().backward()
    for k in params:
        _close(leaves[k].grad, grads_j[k], rtol=1e-5, atol=1e-5, what=k)
