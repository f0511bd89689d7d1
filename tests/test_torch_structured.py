"""The port's matrix and correlation families against the JAX package's, on
the same numpy inputs: ``MultivariateStudentT``, ``MatrixNormal``,
``Wishart``, ``WishartCholesky``, ``LKJ``, ``LKJCholesky`` and
``ZeroSumNormal``.  Their methods (a raise where the JAX class has none),
``sample`` on JAX's own draws (handed over through ``tests/torch_draws.py``),
the port's own draws and draws under ``soft_vmap`` through the port's
``gof`` (on statistics of known law, with ``CirculantNormal`` and
``MixtureSameFamily``), the reparameterised gradients,
the NaN of a matrix that is not positive definite, and two findings about
``LKJCholesky``'s sampler.

Parameters follow ``tests/test_distributions_structured.py``,
``tests/test_distributions_sweep.py`` and ``tests/test_gof_extended.py``.

Tolerances: rtol 1e-5 and atol 1e-6 on float32 values, unless a case says
why not.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions import biject_to
from numpyro_tpu_torch.distributions.gof import auto_goodness_of_fit
from numpyro_tpu_torch.distributions.util import cholesky
from numpyro_tpu_torch.util import soft_vmap

from torch_draws import FedDraws

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TEST_FAILURE_RATE = 5e-3


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _spd(n, seed=0):
    a = np.random.RandomState(seed).randn(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _tril(n, seed):
    r = np.tril(np.random.RandomState(seed).randn(n, n))
    np.fill_diagonal(r, np.abs(r.diagonal()) + 1.0)
    return r.astype(np.float32)


def _loggammas(key, conc, shape):
    return [("gammas", jnp.exp(random.loggamma(key, jnp.broadcast_to(conc, shape), shape)))]


def _mvt_draws(key, shape, d):
    k_gauss, k_mix = random.split(key)
    return ([("normals", random.normal(k_gauss, shape + d.event_shape))]
            + _loggammas(k_mix, d.df / 2.0, shape))


def _normal_draws(key, shape, d):
    return [("normals", random.normal(key, shape + d.event_shape))]


def _wishart_draws(key, shape, d):
    base = d.base_dist if hasattr(d, "base_dist") else d
    k = base.event_shape[-1]
    k_off, k_diag = random.split(key)
    dof = jnp.expand_dims(base.concentration, -1) - jnp.arange(k)
    return ([("normals", random.normal(k_off, shape + (k * (k - 1) // 2,)))]
            + _loggammas(k_diag, dof / 2.0, shape + (k,)))


def _lkj_draws(key, shape, d):
    base = d.base_dist if hasattr(d, "base_dist") else d
    k_radius, k_dir = random.split(key)
    k_a, k_b = random.split(k_radius)
    rows = base.dimension - 1
    return (_loggammas(k_a, base._beta_concentration1, shape + (rows,))
            + _loggammas(k_b, base._beta_concentration0, shape + (rows,))
            + [("normals", random.normal(k_dir, shape + (rows * (rows + 1) // 2,)))])


def _zero_sum_draws(key, shape, d):
    return [("normals", random.normal(key, shape + tuple(s - 1 for s in d.event_shape)))]


_COV = _spd(4)
_LOC = np.random.RandomState(0).randn(4).astype(np.float32)

# name -> (params, the JAX draws of a sample)
CASES = {
    "MultivariateStudentT": (dict(df=np.array([4.0, 5.5, 9.0], np.float32),
                                  loc=np.stack([_LOC, -_LOC, 0.5 * _LOC]),
                                  scale_tril=np.linalg.cholesky(_COV)), _mvt_draws),
    "MatrixNormal": (dict(loc=np.random.RandomState(2).randn(2, 3, 2).astype(np.float32),
                          scale_tril_row=_tril(3, 3), scale_tril_column=_tril(2, 4)),
                     _normal_draws),
    "WishartCholesky": (dict(concentration=np.array([7.0, 5.5], np.float32),
                             scale_matrix=_spd(3, 1)), _wishart_draws),
    "Wishart": (dict(concentration=np.array([7.0, 5.5], np.float32), scale_matrix=_spd(3, 1)),
                _wishart_draws),
    "LKJCholesky": (dict(dimension=4, concentration=np.float32(1.5)), _lkj_draws),
    "LKJ": (dict(dimension=3, concentration=np.float32(2.0)), _lkj_draws),
    "ZeroSumNormal": (dict(scale=np.float32(1.3), event_shape=(4,)), _zero_sum_draws),
    "ZeroSumNormal2": (dict(scale=np.float32(0.7), event_shape=(3, 4)), _zero_sum_draws),
}


def _make(name, params=None):
    params = CASES[name][0] if params is None else params
    cls = "ZeroSumNormal" if name.startswith("ZeroSumNormal") else name

    def conv(v, f):
        return f(v) if isinstance(v, np.ndarray) or isinstance(v, np.floating) else v

    d_j = getattr(jdist, cls)(**{k: conv(v, jnp.asarray) for k, v in params.items()})
    d_t = getattr(dist, cls)(**{k: conv(v, _t) for k, v in params.items()})
    return d_j, d_t


def _jax_call(name, fn, *args, params=None):
    """``fn(the JAX package's distribution, *args)`` under ``jax.jit`` (its
    eager ops compile one by one)."""
    params = CASES[name][0] if params is None else params
    cls = "ZeroSumNormal" if name.startswith("ZeroSumNormal") else name
    arrays = {k: jnp.asarray(v) for k, v in params.items()
              if isinstance(v, (np.ndarray, np.floating))}
    static = {k: v for k, v in params.items() if k not in arrays}
    return jax.jit(lambda a, *rest: fn(getattr(jdist, cls)(**static, **a), *rest))(arrays, *args)


def _method(d, attr, *args):
    out = getattr(d, attr)
    return out(*args) if callable(out) else out


@pytest.mark.parametrize("name", list(CASES))
def test_methods_match_jax(name):
    d_j, d_t = _make(name)
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape
    x = np.asarray(_jax_call(name, lambda d, k: d.sample(k, (4,)), random.PRNGKey(7)))
    # a Cholesky factor's or a matrix's density sums float32 terms of a few
    # units: atol 1e-5
    _close(d_t.log_prob(_t(x)), _jax_call(name, lambda d, v: d.log_prob(v), x), atol=1e-5,
           what="log_prob")
    for attr, args in (("mean", ()), ("variance", ()), ("entropy", ()), ("cdf", (x,)),
                       ("icdf", (x,))):
        try:
            want = np.asarray(_jax_call(name, lambda d, *a: _method(d, attr, *a), *args))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                _method(d_t, attr, *(_t(a) for a in args))
            continue
        _close(_method(d_t, attr, *(_t(a) for a in args)), want, atol=1e-5, what=attr)
    assert d_t.has_rsample == d_j.has_rsample
    assert type(d_t.support).__name__ == type(d_j.support).__name__
    assert d_t.support.event_dim == d_j.support.event_dim


def test_named_parameters_match_jax():
    d_j, d_t = _make("Wishart")
    _close(d_t.concentration, d_j.concentration)
    _close(d_t.scale_tril, d_j.scale_tril, atol=1e-5)
    rate = np.linalg.inv(_spd(3, 1)).astype(np.float32)
    for kw_t, kw_j in (({"rate_matrix": _t(rate)}, {"rate_matrix": jnp.asarray(rate)}),
                       ({"scale_tril": _t(np.linalg.cholesky(_spd(3, 1)))},
                        {"scale_tril": jnp.asarray(np.linalg.cholesky(_spd(3, 1)))})):
        _close(dist.WishartCholesky(_t(6.0), **kw_t).scale_tril,
               jdist.WishartCholesky(jnp.asarray(6.0), **kw_j).scale_tril, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        dist.WishartCholesky(_t(6.0))
    lkj_j, lkj_t = _make("LKJCholesky")
    _close(lkj_t._beta_concentration0, lkj_j._beta_concentration0)
    _close(lkj_t._beta_concentration1, lkj_j._beta_concentration1)
    with pytest.raises(ValueError):
        dist.LKJCholesky(1)
    with pytest.raises(ValueError):
        dist.LKJCholesky(3, sample_method="vine")


@pytest.mark.parametrize("name", list(CASES))
def test_sample_on_jax_draws_equals_jax(name):
    d_j, d_t = _make(name)
    key = random.PRNGKey(11)
    want = np.asarray(_jax_call(name, lambda d, k: d.sample(k, (5,)), key))
    source = FedDraws(CASES[name][1](key, (5,) + d_j.batch_shape, d_j))
    got = d_t.sample(source, (5,))
    assert not source.items
    # LKJ: JAX's Beta draws normalise their two gamma draws in log space,
    # the port's directly (2e-5, as for Beta); the matrix products of
    # Wishart and LKJ round a few units' worth of float32 (atol 1e-5)
    _close(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["generator", "soft_vmap"])
@pytest.mark.parametrize("name", cs.STRUCTURED_GOF)
def test_own_draws_pass_gof(name, mode):
    """The port's draws from its generator, and under ``soft_vmap`` (each
    mapped element its own draw), through the port's
    ``gof.auto_goodness_of_fit`` on scalar statistics of known law
    (``chip_smoke.gof_statistics``, which 17c applies to the card's draws),
    at n = max(4000, 1500 x the unconstrained dimension) as
    ``tests/test_gof_extended.py`` takes.  That file's check in unconstrained
    space (a nearest-neighbour statistic) is not calibrated at these sizes:
    on the JAX package's exact ZeroSumNormal draws it reads p from 0.06 to
    0.24 over five keys, and on the port's from 1e-4 (seeds 5 to 10), so it
    is not the check here."""
    d_t = cs.gof_family(name, torch.device("cpu"))
    u_dim = biject_to(d_t.support).inv(d_t.sample(torch.Generator().manual_seed(0))).numel()
    n = max(4000, 1500 * u_dim)
    gen = torch.Generator().manual_seed(5)
    if mode == "generator":
        x = d_t.sample(gen, (n,))
    else:
        x = soft_vmap(lambda _: d_t.sample(gen), torch.arange(n), chunk_size=n // 2)
        # float32 draws of a univariate mixture may meet by chance
        assert len(torch.unique(x.reshape(n, -1), dim=0)) > 0.99 * n
    assert x.shape == (n,) + d_t.event_shape
    for label, (stat, density) in cs.gof_statistics(name, d_t, x).items():
        p = auto_goodness_of_fit(stat, density)
        assert p > TEST_FAILURE_RATE, f"{name} {label}: p {p}"


def _grad_case(name):
    if name == "MultivariateStudentT":
        return {k: v for k, v in CASES[name][0].items()}
    if name == "MatrixNormal":
        return dict(CASES[name][0])
    if name in ("WishartCholesky", "Wishart"):
        return dict(concentration=np.array([7.0, 5.5], np.float32),
                    scale_tril=np.linalg.cholesky(_spd(3, 1)))
    if name == "LKJCholesky":
        return dict(concentration=np.array(1.5, np.float32))
    return dict(scale=np.array(1.3, np.float32))


@pytest.mark.parametrize("name", ["MultivariateStudentT", "MatrixNormal", "WishartCholesky",
                                  "LKJCholesky", "ZeroSumNormal"])
def test_reparameterised_gradients_match_jax(name):
    """The gradient of a positively weighted sum of a draw in every
    parameter, on the same draws: the chi-square draws of
    ``MultivariateStudentT`` and ``WishartCholesky`` and the Beta draws of
    ``LKJCholesky`` through ``util.standard_gamma``'s exact derivative.
    rtol 1e-5, atol 1e-5 (the JAX package's float32 ``random_gamma_grad``
    against the port's float64 derivative)."""
    params = _grad_case(name)
    fixed = {"LKJCholesky": {"dimension": 4}, "ZeroSumNormal": {"event_shape": (4,)}}.get(name, {})
    key = random.PRNGKey(4)
    d_j = getattr(jdist, name)(**fixed, **{k: jnp.asarray(v) for k, v in params.items()})
    shape = (6,) + d_j.batch_shape
    weights = np.random.default_rng(2).uniform(0.5, 1.5, shape + d_j.event_shape).astype(
        np.float32)

    def loss_j(p):
        return (getattr(jdist, name)(**fixed, **p).sample(key, (6,)) * weights).sum()

    grads_j = jax.jit(jax.grad(loss_j))({k: jnp.asarray(v) for k, v in params.items()})
    leaves = {k: _t(v).requires_grad_() for k, v in params.items()}
    d_t = getattr(dist, name)(**fixed, **leaves)
    source = FedDraws(CASES[name][1](key, shape, d_j))
    (d_t.sample(source, (6,)) * _t(weights)).sum().backward()
    for k in params:
        _close(leaves[k].grad, grads_j[k], rtol=RTOL, atol=1e-5, what=k)


# ---------------------------------------------------------------------------
# a matrix that is not positive definite: NaN, as in the JAX package, and no
# raise


BAD = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


def test_wishart_not_positive_definite_gives_nan():
    good = _spd(3, 1)
    w = np.asarray(jdist.Wishart(jnp.asarray(6.0), scale_matrix=jnp.asarray(good)).sample(
        random.PRNGKey(0)))
    for kind in ("scale_matrix", "rate_matrix"):
        lp_j = np.asarray(jdist.Wishart(jnp.asarray(6.0), **{kind: jnp.asarray(BAD)}).log_prob(w))
        lp_t = dist.Wishart(_t(6.0), **{kind: _t(BAD)}).log_prob(_t(w))
        assert np.isnan(lp_j) and torch.isnan(lp_t), kind
    # under vmap the positive definite matrices stay finite
    stack = _t(np.stack([good, BAD, good]))
    lp = torch.func.vmap(lambda m: dist.Wishart(_t(6.0), scale_matrix=m).log_prob(_t(w)))(stack)
    want = jax.vmap(lambda m: jdist.Wishart(jnp.asarray(6.0), scale_matrix=m).log_prob(
        jnp.asarray(w)))(jnp.asarray(stack.numpy()))
    np.testing.assert_array_equal(torch.isnan(lp).numpy(), np.isnan(np.asarray(want)))
    _close(lp[[0, 2]], np.asarray(want)[[0, 2]], atol=1e-5)


def test_student_t_and_matrix_normal_on_a_nan_factor_give_nan():
    """A factor taken of a matrix that is not positive definite (NaN on and
    below the diagonal, JAX's ``cholesky`` and the port's
    ``util.cholesky`` alike) gives a NaN density in both packages."""
    tril_t, tril_j = cholesky(_t(BAD)), jnp.linalg.cholesky(jnp.asarray(BAD))
    np.testing.assert_array_equal(torch.isnan(tril_t).numpy(), np.isnan(np.asarray(tril_j)))
    x = np.ones(3, np.float32)
    lp_t = dist.MultivariateStudentT(_t(4.0), torch.zeros(3), tril_t).log_prob(_t(x))
    lp_j = jdist.MultivariateStudentT(4.0, jnp.zeros(3), tril_j).log_prob(jnp.asarray(x))
    assert torch.isnan(lp_t) and np.isnan(np.asarray(lp_j))
    m = np.ones((3, 2), np.float32)
    col = np.eye(2, dtype=np.float32)
    lp_t = dist.MatrixNormal(torch.zeros(3, 2), tril_t, _t(col)).log_prob(_t(m))
    lp_j = jdist.MatrixNormal(jnp.zeros((3, 2)), tril_j, jnp.asarray(col)).log_prob(
        jnp.asarray(m))
    assert torch.isnan(lp_t) and np.isnan(np.asarray(lp_j))


# ---------------------------------------------------------------------------
# LKJCholesky's sampler


def test_lkj_cvine_raises_where_jax_fails_and_keeps_its_density():
    """The JAX package's ``sample_method="cvine"`` draws through its onion
    sampler with Beta parameters of the triangular shape, and fails on a
    shape mismatch; the port raises ``NotImplementedError`` naming the
    reason.  The density does not depend on the method, in either package."""
    d_j = jdist.LKJCholesky(4, 1.5, sample_method="cvine")
    d_t = dist.LKJCholesky(4, _t(1.5), sample_method="cvine")
    with pytest.raises(TypeError):
        d_j.sample(random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="cvine"):
        d_t.sample(torch.Generator().manual_seed(0))
    _close(d_t._beta_concentration0, d_j._beta_concentration0)
    x = np.asarray(jdist.LKJCholesky(4, 1.5).sample(random.PRNGKey(1), (3,)))
    _close(d_t.log_prob(_t(x)), d_j.log_prob(jnp.asarray(x)), atol=1e-5)


def test_lkj_batched_concentration_draws_its_own_shape():
    """With a batched concentration the JAX package's draws have the batch
    shape twice (``(2, 2, 3, 3)`` for two concentrations); the port's are
    ``(2, 3, 3)``, each following its own concentration: the off-diagonal
    correlation of LKJ(3, eta) has variance 1 / (2 eta + 2)."""
    conc = np.array([1.0, 4.0], np.float32)
    assert jdist.LKJCholesky(3, jnp.asarray(conc)).sample(random.PRNGKey(0)).shape == (2, 2, 3, 3)
    d_t = dist.LKJCholesky(3, _t(conc))
    x = d_t.sample(torch.Generator().manual_seed(3), (20_000,))
    assert x.shape == (20_000, 2, 3, 3) and bool(dist.constraints.corr_cholesky(x).all())
    r = (x @ x.transpose(-2, -1))[..., 1, 0].double()
    want = 1.0 / (2.0 * torch.tensor(conc, dtype=torch.float64) + 2.0)
    se = want * np.sqrt(2.0 / 20_000) * 2.0
    assert ((r.var(0) - want).abs() < 4 * se).all()
