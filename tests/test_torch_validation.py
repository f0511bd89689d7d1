"""Distribution validation in the port against the JAX package:
``enable_validation``, ``validation_enabled``, ``validate_args``,
``Distribution.set_default_validate_args``, the parameter check and the
``@validate_sample`` decorator.

With validation on, every ``log_prob`` that carries ``@validate_sample`` in
the JAX package (53 methods, one case of each below) gives ``-inf`` at a
value outside the support and JAX's value inside it (rtol 1e-5), and both
packages warn; a bad parameter raises ``ValueError`` in both.  Under
``torch.func.vmap`` nothing is read on the host: a read of a batched tensor
raises there, so these runs also show that none is made.
"""

import inspect
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.distributions import constraints as jconstraints
from numpyro_tpu_torch.distributions import constraints as tconstraints

torch.set_num_threads(1)

RTOL = 1e-5
RING3 = [[0.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]]
CORR2 = [[1.0, 0.4], [0.4, 1.0]]


def _t(x):
    x = np.asarray(x)
    return torch.as_tensor(x if x.dtype.kind in "bi" else x.astype(np.float32))


def _j(x):
    x = np.asarray(x)
    return jnp.asarray(x if x.dtype.kind in "bi" else x.astype(np.float32))


def _ou(x, t):
    return -x, 0.5


# the owner of each decorated log_prob -> (a distribution whose log_prob it
# is, from the modules and array converter given, an in-support value and
# an out-of-support one)
CASES = {
    "BetaBinomial": (lambda m, a: m.BetaBinomial(a(2.0), a(3.0), 5), 2.0, 7.0),
    "DirichletMultinomial": (lambda m, a: m.DirichletMultinomial(a([1.0, 2.0, 3.0]), 4),
                             [1.0, 1.0, 2.0], [1.0, 1.0, 1.0]),
    "GammaPoisson": (lambda m, a: m.GammaPoisson(a(3.0), a(2.0)), 4.0, 1.5),
    "NegativeBinomialLogits": (lambda m, a: m.NegativeBinomialLogits(a(3.0), a(0.5)), 2.0, -1.0),
    "_LocScale": (lambda m, a: m.Normal(a(0.0), a(1.0)), 0.3, np.inf),
    "_FoldedAtZero": (lambda m, a: m.HalfNormal(a(1.0)), 0.3, -1.0),
    "Uniform": (lambda m, a: m.Uniform(a(0.0), a(2.0)), 1.0, 3.0),
    "Exponential": (lambda m, a: m.Exponential(a(1.5)), 0.3, -1.0),
    "Gamma": (lambda m, a: m.Gamma(a(2.0), a(1.0)), 0.3, -1.0),
    "Beta": (lambda m, a: m.Beta(a(2.0), a(3.0)), 0.3, 1.5),
    "Dirichlet": (lambda m, a: m.Dirichlet(a([1.0, 2.0, 3.0])), [0.2, 0.3, 0.5],
                  [0.5, 0.6, -0.1]),
    "Weibull": (lambda m, a: m.Weibull(a(1.0), a(2.0)), 0.3, -1.0),
    "Kumaraswamy": (lambda m, a: m.Kumaraswamy(a(2.0), a(3.0)), 0.3, 1.5),
    "MultivariateNormal": (lambda m, a: m.MultivariateNormal(a([0.0, 1.0]),
                                                             covariance_matrix=a(CORR2)),
                           [0.5, 0.5], [np.inf, 0.0]),
    "MultivariateStudentT": (lambda m, a: m.MultivariateStudentT(a(4.0), a([0.0, 1.0]),
                                                                 a(np.eye(2))),
                             [0.5, 0.5], [np.inf, 0.0]),
    "LowRankMultivariateNormal": (lambda m, a: m.LowRankMultivariateNormal(
        a([0.0, 1.0]), a([[1.0], [0.5]]), a([1.0, 2.0])), [0.5, 0.5], [np.inf, 0.0]),
    "GaussianRandomWalk": (lambda m, a: m.GaussianRandomWalk(a(1.0), 3), [0.1, 0.4, 0.2],
                           [0.1, np.inf, 0.2]),
    "LKJCholesky": (lambda m, a: m.LKJCholesky(2, a(1.5)), [[1.0, 0.0], [0.6, 0.8]],
                    [[1.0, 0.0], [0.6, 0.9]]),
    "WishartCholesky": (lambda m, a: m.WishartCholesky(a(4.0), scale_matrix=a(np.eye(2))),
                        [[1.0, 0.0], [0.5, 1.0]], [[1.0, 0.0], [0.5, -1.0]]),
    "Gompertz": (lambda m, a: m.Gompertz(a(2.0), a(1.0)), 0.3, -1.0),
    "Levy": (lambda m, a: m.Levy(a(0.5), a(1.0)), 1.3, 0.2),
    "MatrixNormal": (lambda m, a: m.MatrixNormal(a(np.zeros((2, 2))), a(np.eye(2)),
                                                 a([[1.0, 0.0], [0.3, 0.8]])),
                     [[0.1, 0.2], [0.3, 0.4]], [[0.1, np.inf], [0.3, 0.4]]),
    "CAR": (lambda m, a: m.CAR(a(np.zeros(3)), a(0.5), a(2.0), a(RING3)), [0.1, 0.2, 0.3],
            [0.1, np.inf, 0.3]),
    "EulerMaruyama": (lambda m, a: m.EulerMaruyama(a(np.linspace(0.0, 1.0, 4)), _ou,
                                                   m.Normal(a(0.0), a(1.0))),
                      [0.1, 0.2, 0.3, 0.4], [0.1, 0.2, 0.3, np.inf]),
    "GaussianStateSpace": (lambda m, a: m.GaussianStateSpace(3, a([[0.9, 0.1], [0.0, 0.8]]),
                                                             covariance_matrix=a(CORR2)),
                           [[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]],
                           [[0.1, 0.2], [0.3, np.inf], [0.5, 0.6]]),
    "CirculantNormal": (lambda m, a: m.CirculantNormal(a(np.zeros(4)),
                                                       covariance_row=a([2.0, 0.5, 0.2, 0.5])),
                        [0.1, 0.2, 0.3, 0.4], [0.1, 0.2, np.inf, 0.4]),
    "GaussianCopula": (lambda m, a: m.GaussianCopula(m.Normal(a([0.5, -1.0]), a([1.0, 2.0])),
                                                     correlation_matrix=a(CORR2)),
                       [0.5, 0.5], [np.inf, 0.5]),
    "VonMises": (lambda m, a: m.VonMises(a(0.0), a(2.0)), 0.3, 4.0),
    "ProjectedNormal": (lambda m, a: m.ProjectedNormal(a([1.0, 2.0, 0.5])), [0.6, 0.8, 0.0],
                        [1.0, 1.0, 1.0]),
    "SineBivariateVonMises": (lambda m, a: m.SineBivariateVonMises(
        a(0.0), a(0.5), a(2.0), a(3.0), a(0.5)), [0.3, 0.2], [4.0, 0.2]),
    "BernoulliProbs": (lambda m, a: m.BernoulliProbs(a(0.3)), 1.0, 0.5),
    "BernoulliLogits": (lambda m, a: m.BernoulliLogits(a(0.3)), 0.0, 2.0),
    "BinomialProbs": (lambda m, a: m.BinomialProbs(a(0.3), 5), 2.0, 6.0),
    "BinomialLogits": (lambda m, a: m.BinomialLogits(a(0.3), 5), 2.0, -1.0),
    "_CategoricalBase": (lambda m, a: m.CategoricalProbs(a([0.2, 0.3, 0.5])), 2, 3),
    "DiscreteUniform": (lambda m, a: m.DiscreteUniform(a(0.0), a(3.0)), 2.0, 4.0),
    "_MultinomialBase": (lambda m, a: m.MultinomialProbs(a([0.2, 0.3, 0.5]), 4),
                         [1.0, 1.0, 2.0], [1.0, 1.0, 1.0]),
    "Poisson": (lambda m, a: m.Poisson(a(2.0)), 3.0, 1.5),
    "GeometricProbs": (lambda m, a: m.GeometricProbs(a(0.3)), 2.0, -1.0),
    "GeometricLogits": (lambda m, a: m.GeometricLogits(a(0.3)), 2.0, 0.5),
    "NegativeBinomial2": (lambda m, a: m.NegativeBinomial2(a(2.0), a(3.0)), 2.0, 1.5),
    "ZeroInflatedPoisson": (lambda m, a: m.ZeroInflatedPoisson(a(0.2), a(2.0)), 2.0, 1.5),
    "ZeroInflatedProbs": (lambda m, a: m.ZeroInflatedProbs(m.Poisson(a(2.0)), a(0.3)), 2.0,
                          -1.0),
    "ZeroInflatedLogits": (lambda m, a: m.ZeroInflatedLogits(m.Poisson(a(2.0)), a(0.3)), 2.0,
                           1.5),
    "TransformedDistribution": (lambda m, a: m.LogNormal(a(0.0), a(1.0)), 0.3, -1.0),
    "FoldedDistribution": (lambda m, a: m.FoldedDistribution(m.Normal(a(0.5), a(1.0))), 0.3,
                           -1.0),
    "Delta": (lambda m, a: m.Delta(a(1.0)), 1.0, np.inf),
    "ImproperUniform": (lambda m, a: m.ImproperUniform(m.constraints.positive, (), ()), 0.3,
                        -1.0),
    "_MixtureBase": (lambda m, a: m.MixtureSameFamily(m.Categorical(logits=a([-0.4, 0.4])),
                                                      m.Normal(a([-1.0, 1.0]), a([0.5, 1.5]))),
                     0.3, np.inf),
    "_WindowTruncated": (lambda m, a: m.LeftTruncatedDistribution(m.Normal(a(0.0), a(1.0)),
                                                                  low=a(0.5)), 0.7, 0.2),
    "TruncatedPolyaGamma": (lambda m, a: m.TruncatedPolyaGamma(batch_shape=()), 0.5, -1.0),
    "LowerTruncatedPowerLaw": (lambda m, a: m.LowerTruncatedPowerLaw(a(-2.0), a(1.0)), 2.0,
                               0.5),
    "DoublyTruncatedPowerLaw": (lambda m, a: m.DoublyTruncatedPowerLaw(a(-2.0), a(1.0),
                                                                       a(5.0)), 2.0, 6.0),
}


def _jax_decorated_owners():
    """The classes whose own ``log_prob`` carries ``@validate_sample`` in
    the JAX package."""
    owners = set()
    for module in (jdist.conjugate, jdist.continuous, jdist.copula, jdist.directional,
                   jdist.discrete, jdist.distribution, jdist.mixtures, jdist.truncated):
        for name, cls in vars(module).items():
            if inspect.isclass(cls) and cls.__module__ == module.__name__:
                if hasattr(cls.__dict__.get("log_prob"), "__wrapped__"):
                    owners.add(name)
    return owners


def test_the_cases_cover_every_decorated_log_prob():
    owners = _jax_decorated_owners()
    assert len(owners) == 53
    assert owners == set(CASES)


# classes whose validation fails in the JAX package: its parameter check reads
# a parametrization the instance does not hold (AttributeError); the port
# checks the parameters the instance holds
JAX_CHECK_FAILS = {"GaussianStateSpace": "precision_matrix", "WishartCholesky": "scale_matrix"}


def _port_owner(d):
    return next(c for c in type(d).__mro__ if "log_prob" in c.__dict__)


def _values(good, bad, a):
    return a(np.stack([np.asarray(good), np.asarray(bad)]))


@pytest.mark.parametrize("owner", sorted(CASES))
def test_out_of_support_log_prob_is_minus_inf_as_in_jax(owner):
    make, good, bad = CASES[owner]
    if owner in JAX_CHECK_FAILS:
        with jdist.validation_enabled(), pytest.raises(AttributeError,
                                                       match=JAX_CHECK_FAILS[owner]):
            make(jdist, _j)
        with dist.validation_enabled():
            d_t = make(dist, _t)
            with pytest.warns(UserWarning, match="Out-of-support"):
                lp_t = d_t.log_prob(_values(good, bad, _t)).numpy()
        lp_j = np.asarray(make(jdist, _j).log_prob(_values(good, bad, _j)))
        np.testing.assert_allclose(lp_t[0], lp_j[0], rtol=RTOL)
        assert lp_t[1] == -np.inf
        return
    with jdist.validation_enabled(), dist.validation_enabled():
        d_j, d_t = make(jdist, _j), make(dist, _t)
        assert _port_owner(d_t).__name__ == owner
        assert hasattr(_port_owner(d_t).__dict__["log_prob"], "__wrapped__")
        with pytest.warns(UserWarning, match="Out-of-support"):
            lp_j = np.asarray(d_j.log_prob(_values(good, bad, _j)))
        with pytest.warns(UserWarning, match="Out-of-support"):
            lp_t = d_t.log_prob(_values(good, bad, _t)).numpy()
    assert np.isfinite(lp_j[0]) or owner == "Delta"
    np.testing.assert_array_equal(lp_t[1], lp_j[1])
    assert lp_t[1] == -np.inf
    np.testing.assert_allclose(lp_t[0], lp_j[0], rtol=RTOL)


@pytest.mark.parametrize("owner", ["_LocScale", "Gamma", "Dirichlet", "BinomialProbs",
                                   "LKJCholesky", "_WindowTruncated"])
def test_validation_off_leaves_the_log_prob_alone(owner):
    make, good, bad = CASES[owner]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lp_j = np.asarray(make(jdist, _j).log_prob(_values(good, bad, _j)))
        lp_t = make(dist, _t).log_prob(_values(good, bad, _t)).numpy()
    np.testing.assert_allclose(lp_t, lp_j, rtol=RTOL)


@pytest.mark.parametrize("owner", ["_LocScale", "Gamma", "Dirichlet", "_CategoricalBase",
                                   "MultivariateNormal", "VonMises", "EulerMaruyama"])
def test_under_vmap_nothing_is_read_and_no_warning_is_given(owner):
    make, good, bad = CASES[owner]
    with dist.validation_enabled(), warnings.catch_warnings():
        warnings.simplefilter("error")
        d_t = make(dist, _t)
        lp = torch.func.vmap(d_t.log_prob)(_values(good, bad, _t))
    assert np.isfinite(lp[0].item()) and lp[1].item() == -np.inf


BAD_PARAMS = {
    "Normal": (lambda m, a: m.Normal(a(0.0), a(-1.0))),
    "Gamma": (lambda m, a: m.Gamma(a(-1.0), a(1.0))),
    "Beta": (lambda m, a: m.Beta(a(2.0), a([3.0, -3.0]))),
    "Dirichlet": (lambda m, a: m.Dirichlet(a([1.0, -1.0]))),
    "BernoulliProbs": (lambda m, a: m.BernoulliProbs(a(1.5))),
    "CategoricalProbs": (lambda m, a: m.CategoricalProbs(a([0.5, 0.6]))),
    "Poisson": (lambda m, a: m.Poisson(a(-1.0))),
    "BinomialProbs": (lambda m, a: m.BinomialProbs(a(0.3), -2)),
    "MultivariateNormal": (lambda m, a: m.MultivariateNormal(
        a([0.0, 0.0]), covariance_matrix=a([[1.0, 2.0], [2.0, 1.0]]))),
    "VonMises": (lambda m, a: m.VonMises(a(0.0), a(-2.0))),
    "LKJCholesky": (lambda m, a: m.LKJCholesky(2, a(-1.0))),
    "StudentT": (lambda m, a: m.StudentT(a(-3.0))),
    "LowerTruncatedPowerLaw": (lambda m, a: m.LowerTruncatedPowerLaw(a(-0.5), a(1.0))),
}


@pytest.mark.parametrize("name", sorted(BAD_PARAMS))
def test_a_bad_parameter_raises_value_error_as_in_jax(name):
    make = BAD_PARAMS[name]
    with jdist.validation_enabled(), pytest.raises(ValueError, match="invalid"):
        make(jdist, _j)
    with dist.validation_enabled(), pytest.raises(ValueError, match="invalid"):
        make(dist, _t)
    # and without validation nothing is checked
    make(jdist, _j)
    make(dist, _t)


def test_validate_args_per_instance_and_the_default():
    with pytest.raises(ValueError):
        dist.Normal(_t(0.0), _t(-1.0), validate_args=True)
    assert dist.Normal(_t(0.0), _t(-1.0), validate_args=False)._validate_args is False
    assert dist.Distribution._validate_args is False
    with npt.validation_enabled():
        assert dist.Distribution._validate_args is True
        assert dist.Normal(_t(0.0), _t(1.0))._validate_args is True
        with npt.validation_enabled(False):
            assert dist.Distribution._validate_args is False
        assert dist.Distribution._validate_args is True
    assert dist.Distribution._validate_args is False
    npt.enable_validation()
    try:
        assert dist.Normal(_t(0.0), _t(1.0))._validate_args is True
    finally:
        npt.enable_validation(False)
    dist.Distribution.set_default_validate_args(True)
    try:
        with pytest.raises(ValueError):
            dist.Exponential(_t(-1.0))
    finally:
        dist.Distribution.set_default_validate_args(False)


def test_a_batched_bad_parameter_is_not_read_under_vmap():
    """A parameter batched under ``vmap`` is JAX's traced one: not checked."""
    with dist.validation_enabled():
        lp = torch.func.vmap(lambda s: dist.Normal(_t(0.0), s).log_prob(_t(0.5)))(
            _t([-1.0, 1.0]))
    assert np.isnan(lp[0].item()) and np.isfinite(lp[1].item())


def test_nothing_is_read_inside_a_transform_as_under_jit():
    """Inside ``torch.func.vmap`` or ``grad`` even a constant's check is not
    read, as the JAX package reads none under ``jit``, which stages every
    operation; outside, both read it."""
    import jax

    def lp_t(x):
        return dist.Normal(_t(0.0), _t(-1.0)).log_prob(x)

    def lp_j(x):
        return jdist.Normal(_j(0.0), _j(-1.0)).log_prob(x)

    with jdist.validation_enabled(), dist.validation_enabled(), warnings.catch_warnings():
        warnings.simplefilter("error")
        out_j = np.asarray(jax.jit(jax.vmap(lp_j))(_j([0.5, 1.0])))
        out_t = torch.func.vmap(lp_t)(_t([0.5, 1.0])).numpy()
        g_j = float(jax.jit(jax.grad(lp_j))(_j(0.5)))
        g_t = float(torch.func.grad(lp_t)(_t(0.5)))
        with pytest.raises(ValueError, match="invalid scale"):
            lp_j(_j(0.5))
        with pytest.raises(ValueError, match="invalid scale"):
            lp_t(_t(0.5))
    np.testing.assert_array_equal(np.isnan(out_t), np.isnan(out_j))
    np.testing.assert_array_equal(np.isnan(g_t), np.isnan(g_j))


def test_collapse_under_the_nuts_potential_with_validation_on():
    """The collapse placeholder is NaN: read eagerly, its likelihood's check
    raises in both packages; under the chain-batched potential (JAX's
    ``jit``, the port's ``vmap``) it is not read, and the potential is JAX's."""
    from functools import partial

    import jax

    import numpyro_tpu as jnpt
    from numpyro_tpu.infer import util as jutil
    from numpyro_tpu_torch.infer import util

    def model(m, handlers, y):
        s = m.sample("s", m.distributions.HalfNormal(1.0))
        with handlers.collapse():
            mu = m.sample("mu", m.distributions.Normal(1.0, 2.0))
            m.sample("obs", m.distributions.Normal(mu, s), obs=y)

    z = np.array([-0.5, 0.0, 0.7], np.float32)
    with jdist.validation_enabled(), dist.validation_enabled():
        pe_j = jax.jit(jax.vmap(lambda p: jutil.potential_energy(
            partial(model, jnpt, jnpt.handlers), (_j(0.3),), {}, p)))({"s": _j(z)})
        pe_t, _ = util.batched_value_and_grad(partial(
            util.potential_energy, partial(model, npt, npt.handlers), (_t(0.3),), {}))(
            {"s": _t(z)})
        with pytest.raises(ValueError, match="invalid loc"):
            jutil.log_density(jnpt.handlers.seed(partial(model, jnpt, jnpt.handlers), 0),
                              (_j(0.3),), {}, {"s": _j(1.0)})
        with pytest.raises(ValueError, match="invalid loc"):
            util.log_density(npt.handlers.seed(partial(model, npt, npt.handlers), 0),
                             (_t(0.3),), {}, {"s": _t(1.0)})
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=RTOL)


def test_the_potential_under_vmap_with_validation_on():
    """The chain-batched NUTS potential reads nothing with validation on: a
    point outside a support gives an infinite potential, as in JAX."""
    from functools import partial

    import jax

    from numpyro_tpu.infer import util as jutil
    from numpyro_tpu_torch.infer import util

    def model(m, y):
        mu = m.sample("mu", m.distributions.Normal(0.0, 2.0))
        s = m.sample("s", m.distributions.HalfNormal(1.0))
        with m.plate("N", y.shape[0]):
            m.sample("y", m.distributions.Normal(mu, s), obs=y)

    import numpyro_tpu as jnpt

    y = np.array([0.3, -1.2, 2.0], np.float32)
    z = {"mu": np.array([0.1, -0.5, 1.0], np.float32), "s": np.array([0.0, 1.0, -2.0],
                                                                     np.float32)}
    with jdist.validation_enabled(), dist.validation_enabled(), warnings.catch_warnings():
        warnings.simplefilter("error")
        pe_j, g_j = jax.vmap(jax.value_and_grad(
            lambda p: jutil.potential_energy(partial(model, jnpt), (jnp.asarray(y),), {}, p)))(
            {k: jnp.asarray(v) for k, v in z.items()})
        pe_t, g_t = util.batched_value_and_grad(
            partial(util.potential_energy, partial(model, npt), (_t(y),), {}))(
            {k: _t(v) for k, v in z.items()})
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=RTOL)
    for k in z:
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("name", ["AsymmetricLaplace", "AsymmetricLaplaceQuantile",
                                  "SineSkewed"])
def test_explicit_checks_warn_as_in_jax(name):
    def make(m, a):
        if name == "AsymmetricLaplace":
            return m.AsymmetricLaplace(a(0.0), a(1.0), a(2.0))
        if name == "AsymmetricLaplaceQuantile":
            return m.AsymmetricLaplaceQuantile(a(0.0), a(1.0), a(0.3))
        return m.SineSkewed(m.VonMises(a(0.0), a(2.0)).to_event(0).expand([2]).to_event(1),
                            a([0.2, -0.3]))

    bad = np.inf if name != "SineSkewed" else [4.0, 0.1]
    with jdist.validation_enabled(), dist.validation_enabled():
        with pytest.warns(UserWarning, match="Out-of-support"):
            lp_j = np.asarray(make(jdist, _j).log_prob(_j(bad)))
        with pytest.warns(UserWarning, match="Out-of-support"):
            lp_t = make(dist, _t).log_prob(_t(bad)).numpy()
    np.testing.assert_allclose(lp_t, lp_j, rtol=RTOL)


def test_projected_normal_checks_the_event_shape():
    with jdist.validation_enabled(), pytest.raises(ValueError, match="event shape"):
        jdist.ProjectedNormal(_j([1.0, 2.0, 0.5])).log_prob(_j([0.6, 0.8]))
    with dist.validation_enabled(), pytest.raises(ValueError, match="event shape"):
        dist.ProjectedNormal(_t([1.0, 2.0, 0.5])).log_prob(_t([0.6, 0.8]))


def test_distribution_like_matches_jax():
    assert isinstance(dist.Normal(_t(0.0), _t(1.0)), dist.DistributionLike)
    assert not isinstance(object(), dist.DistributionLike)
    members = {n for n in dir(jdist.DistributionLike) if not n.startswith("_")}
    assert members == {n for n in dir(dist.DistributionLike) if not n.startswith("_")}


def test_arg_constraints_are_the_jax_package_s():
    for name in jdist.__all__:
        cls_j = getattr(jdist, name)
        if not (inspect.isclass(cls_j) and issubclass(cls_j, jdist.Distribution)):
            continue
        cls_t = getattr(dist, name)
        ac_j = {k: type(v).__name__ for k, v in cls_j.arg_constraints.items()}
        ac_t = {k: type(v).__name__ for k, v in cls_t.arg_constraints.items()}
        assert ac_t == ac_j, name
    assert jconstraints.positive(2.0) and tconstraints.positive(_t(2.0))
