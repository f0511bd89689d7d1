"""The port's spatial, time-series and circulant families against the JAX
package's, on the same numpy inputs: ``CAR``, ``EulerMaruyama``,
``GaussianStateSpace`` and ``CirculantNormal``, and the KL row of an
independent Normal against a ``CirculantNormal``.  Their methods,
``sample`` on JAX's own draws (``tests/torch_draws.py``), the gradients
through the real FFT, and the NaN of a noise covariance that is not
positive definite (``CirculantNormal``'s own draws go through the port's
``gof`` in ``tests/test_torch_structured.py``).

Parameters follow ``tests/test_distributions_structured.py``,
``tests/test_distributions_extra.py`` and
``tests/test_distributions_sweep.py`` (the ring adjacency, the circulant
row, the OU drift), widened to a batch by numpy draws from a seed.

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

from torch_draws import FedDraws

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

RING4 = np.array([[0, 1, 0, 1], [1, 0, 1, 0], [0, 1, 0, 1], [1, 0, 1, 0]], np.float32)
CIRC_ROW = np.array([2.0, 0.7, 0.3, 0.7], np.float32)
CIRC_ROW5 = np.array([3.0, 1.0, 0.5, 0.5, 1.0], np.float32)
COV = np.array([[2.0, 0.5], [0.5, 1.0]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _pair(make):
    """The same distribution built by ``make`` from each package's modules
    and array converter."""
    return make(jdist, jnp.asarray), make(dist, _t)


def _car(m, a):
    return m.CAR(a(np.random.default_rng(0).normal(size=(3, 4))), a([0.5, 0.8, -0.3]),
                 a([2.0, 1.5, 0.7]), a(RING4))


def _ou(x, t):
    return -x, 0.5


def _em(m, a):
    return m.EulerMaruyama(a(np.linspace(0.0, 1.0, 6)), _ou, m.Normal(a(0.0), a(1.0)))


def _em_vector(m, a):
    def sde(x, t):
        return -0.5 * x + t, 0.3 * (x * 0 + 1)

    init = m.Normal(a(np.zeros(2)), a(1.0)).to_event(1)
    return m.EulerMaruyama(a(np.linspace(0.0, 2.0, 5)), sde, init)


def _gss(m, a):
    return m.GaussianStateSpace(4, a([[0.9, 0.1], [0.0, 0.8]]), covariance_matrix=a(COV))


def _gss_precision(m, a):
    return m.GaussianStateSpace(5, a(0.8 * np.eye(2)), precision_matrix=a(np.linalg.inv(COV)))


def _gss_tril(m, a):
    return m.GaussianStateSpace(6, a([[0.9]]), scale_tril=a([[1.0]]))


def _circ(m, a):
    loc = np.random.default_rng(1).normal(size=(2, 4))
    return m.CirculantNormal(a(loc), covariance_row=a(CIRC_ROW))


def _circ_odd(m, a):
    return m.CirculantNormal(a(np.zeros(5)), covariance_row=a(CIRC_ROW5))


def _circ_rfft(m, a):
    rfft = np.stack([np.fft.rfft(CIRC_ROW).real, np.fft.rfft([1.5, 0.2, 0.1, 0.2]).real])
    return m.CirculantNormal(a(np.zeros(4)), covariance_rfft=a(rfft))


def _normals(key, shape, d):
    return [("normals", random.normal(key, shape + d.event_shape))]


def _em_draws(key, shape, d):
    k_path, k_start = random.split(key)
    n_steps = d.event_shape[0]
    noise = random.normal(k_path, shape + (n_steps - 1,) + d.event_shape[1:])
    start = random.normal(k_start, shape + d.event_shape[1:])
    return [("normals", noise), ("normals", start)]


def _circ_draws(key, shape, d):
    return [("normals", random.normal(key, shape + d.event_shape))]


CASES = {
    "CAR": (_car, _normals),
    "EulerMaruyama": (_em, _em_draws),
    "EulerMaruyama vector": (_em_vector, _em_draws),
    "GaussianStateSpace": (_gss, _normals),
    "GaussianStateSpace precision": (_gss_precision, _normals),
    "GaussianStateSpace scale_tril": (_gss_tril, _normals),
    "CirculantNormal": (_circ, _circ_draws),
    "CirculantNormal odd": (_circ_odd, _circ_draws),
    "CirculantNormal rfft": (_circ_rfft, _circ_draws),
}


def _method(d, attr, *args):
    out = getattr(d, attr)
    return out(*args) if callable(out) else out


@pytest.mark.parametrize("name", list(CASES))
def test_methods_match_jax(name):
    d_j, d_t = _pair(CASES[name][0])
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape
    x = np.asarray(d_j.sample(random.PRNGKey(7), (3,)))
    # densities of a few units summed in float32: atol 1e-5
    _close(d_t.log_prob(_t(x)), d_j.log_prob(jnp.asarray(x)), atol=1e-5, what="log_prob")
    attrs = ["mean", "variance", "entropy", "cdf", "icdf", "covariance_matrix",
             "precision_matrix", "covariance_row", "covariance_rfft"]
    for attr in attrs:
        args = (x,) if attr in ("cdf", "icdf") else ()
        try:
            want = np.asarray(_method(d_j, attr, *args))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                _method(d_t, attr, *(_t(a) for a in args))
            continue
        except AttributeError:
            assert not hasattr(type(d_t), attr) and attr not in d_t.__dict__, attr
            continue
        _close(_method(d_t, attr, *(_t(a) for a in args)), want, atol=1e-5, what=attr)
    assert d_t.has_rsample == d_j.has_rsample
    assert type(d_t.support).__name__ == type(d_j.support).__name__
    assert d_t.support.event_dim == d_j.support.event_dim


@pytest.mark.parametrize("name", list(CASES))
def test_sample_on_jax_draws_equals_jax(name):
    d_j, d_t = _pair(CASES[name][0])
    key = random.PRNGKey(11)
    want = np.asarray(d_j.sample(key, (5,)))
    source = FedDraws(CASES[name][1](key, (5,) + d_j.batch_shape, d_j))
    got = d_t.sample(source, (5,))
    assert not source.items
    # the FFT's and the Cholesky factors' float32 rounding: atol 1e-5
    _close(got, want, atol=1e-5)


def test_car_details_match_jax():
    d_j, d_t = _pair(_car)
    shapes = ((4,), (3,), (3,), (4, 4))
    assert dist.CAR.infer_shapes(*shapes) == jdist.CAR.infer_shapes(*shapes)
    with pytest.raises(NotImplementedError):
        dist.CAR(_t(np.zeros(4)), _t(0.5), _t(2.0), _t(RING4), is_sparse=True)
    with pytest.raises(NotImplementedError):
        jdist.CAR(jnp.zeros(4), 0.5, 2.0, jnp.asarray(RING4), is_sparse=True)
    # the density is the normal of the dense precision (scipy, float64)
    x = np.random.default_rng(3).normal(size=(5, 3, 4))
    prec = d_t.precision_matrix.double().numpy()
    want = np.stack([st.multivariate_normal(np.asarray(d_j.loc[i], np.float64),
                                            np.linalg.inv(prec[i])).logpdf(x[:, i])
                     for i in range(3)], -1)
    _close(d_t.log_prob(_t(x)), want, rtol=1e-5, atol=1e-4)
    # a gradient in the correlation and the precision through eigvalsh
    rho, tau = _t([0.5, 0.8, -0.3]).requires_grad_(), _t([2.0, 1.5, 0.7]).requires_grad_()
    dist.CAR(d_t.loc, rho, tau, _t(RING4)).log_prob(_t(x)).sum().backward()
    g_j = jax.grad(lambda r, c: jdist.CAR(d_j.loc, r, c, jnp.asarray(RING4)).log_prob(
        jnp.asarray(x, jnp.float32)).sum(), (0, 1))(jnp.array([0.5, 0.8, -0.3]),
                                                   jnp.array([2.0, 1.5, 0.7]))
    _close(rho.grad, g_j[0], atol=1e-4)
    _close(tau.grad, g_j[1], atol=1e-4)


def test_euler_maruyama_batched_density_is_the_per_path_one():
    d_j, d_t = _pair(_em)
    x = d_t.sample(torch.Generator().manual_seed(0), (4,))
    per = torch.stack([d_t.log_prob(x[i]) for i in range(4)])
    _close(d_t.log_prob(x), per.numpy(), atol=1e-5)
    t = np.linspace(0.0, 1.0, 6)
    v = x[0].double().numpy()
    dt = np.diff(t)
    want = (st.norm(0, 1).logpdf(v[0])
            + st.norm(v[:-1] - v[:-1] * dt, 0.5 * np.sqrt(dt)).logpdf(v[1:]).sum())
    _close(d_t.log_prob(x[0]), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        dist.EulerMaruyama(_t(t), _ou, "not a distribution")


def test_gaussian_state_space_batched_noise_is_each_elements_density():
    """A batch of noise covariances: the JAX package lines the batch up with
    the time axis in ``log_prob`` and fails; the port's density of each batch
    element is the JAX package's of that element alone."""
    covs = np.stack([COV, 0.5 * np.eye(2, dtype=np.float32), 1.5 * COV])
    a = np.array([[0.9, 0.1], [0.0, 0.8]], np.float32)
    d_j = jdist.GaussianStateSpace(4, jnp.asarray(a), covariance_matrix=jnp.asarray(covs))
    x = np.asarray(d_j.sample(random.PRNGKey(2), (5,)))
    with pytest.raises(ValueError):
        d_j.log_prob(jnp.asarray(x))
    d_t = dist.GaussianStateSpace(4, _t(a), covariance_matrix=_t(covs))
    want = np.stack([np.asarray(jdist.GaussianStateSpace(4, jnp.asarray(a),
                                                         covariance_matrix=jnp.asarray(c))
                                .log_prob(jnp.asarray(x[:, i]))) for i, c in enumerate(covs)], -1)
    _close(d_t.log_prob(_t(x)), want, atol=1e-5)
    _close(d_t.variance, d_j.variance, atol=1e-5)


def test_gaussian_state_space_not_positive_definite_gives_nan():
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    x = np.ones((4, 2), np.float32)
    for kind in ("covariance_matrix", "precision_matrix"):
        lp_t = dist.GaussianStateSpace(4, _t(np.eye(2)), **{kind: _t(bad)}).log_prob(_t(x))
        lp_j = jdist.GaussianStateSpace(4, jnp.eye(2), **{kind: jnp.asarray(bad)}).log_prob(
            jnp.asarray(x))
        assert torch.isnan(lp_t) and np.isnan(np.asarray(lp_j)), kind


def test_circulant_normal_details_match_jax():
    shapes = dict(loc=(3, 4), covariance_row=(4,))
    assert dist.CirculantNormal.infer_shapes(**shapes) == jdist.CirculantNormal.infer_shapes(
        **shapes)
    with pytest.raises(ValueError):
        dist.CirculantNormal(_t(np.zeros(4)))
    # the dense covariance's normal, float64
    d_j, d_t = _pair(_circ_odd)
    x = np.random.default_rng(4).normal(size=(6, 5))
    ref = st.multivariate_normal(np.zeros(5), d_t.covariance_matrix.double().numpy())
    _close(d_t.log_prob(_t(x)), ref.logpdf(x), rtol=1e-5, atol=1e-4)
    _close(d_t.entropy(), ref.entropy(), rtol=1e-5, atol=1e-4)


def test_circulant_gradients_through_the_fft_match_jax():
    """The gradient of the density in ``loc`` and ``covariance_row`` through
    ``rfft``, in reverse and forward mode: PyTorch's complex autograd
    convention differs from JAX's, and the real result agrees."""
    x = np.random.default_rng(5).normal(size=(3, 4)).astype(np.float32)
    loc = np.array([0.3, -0.2, 0.1, 0.5], np.float32)

    def lp_j(loc, row):
        return jdist.CirculantNormal(loc, covariance_row=row).log_prob(jnp.asarray(x)).sum()

    def lp_t(loc, row):
        return dist.CirculantNormal(loc, covariance_row=row).log_prob(_t(x)).sum()

    g_j = jax.grad(lp_j, (0, 1))(jnp.asarray(loc), jnp.asarray(CIRC_ROW))
    g_t = torch.func.grad(lp_t, (0, 1))(_t(loc), _t(CIRC_ROW))
    for a, b in zip(g_t, g_j):
        _close(a, b, rtol=1e-5, atol=1e-5)
    tangent = (np.ones(4, np.float32), np.array([0.1, 0.2, -0.1, 0.2], np.float32))
    _, t_j = jax.jvp(lp_j, (jnp.asarray(loc), jnp.asarray(CIRC_ROW)),
                     tuple(jnp.asarray(v) for v in tangent))
    _, t_t = torch.func.jvp(lp_t, (_t(loc), _t(CIRC_ROW)), tuple(_t(v) for v in tangent))
    _close(t_t, t_j, rtol=1e-5, atol=1e-5)


def test_kl_independent_normal_circulant_matches_jax():
    rng = np.random.default_rng(6)
    mu, sd = rng.normal(size=(2, 4)), rng.uniform(0.5, 1.5, size=(2, 4))
    p_j = jdist.Normal(jnp.asarray(mu, jnp.float32), jnp.asarray(sd, jnp.float32)).to_event(1)
    p_t = dist.Normal(_t(mu), _t(sd)).to_event(1)
    q_j, q_t = _pair(_circ)
    kl_t = dist.kl_divergence(p_t, q_t)
    _close(kl_t, jdist.kl_divergence(p_j, q_j), atol=1e-5)
    # and the dense formula, float64
    cov = q_t.covariance_matrix.double().numpy().reshape(4, 4)
    inv = np.linalg.inv(cov)
    want = [0.5 * (np.trace(inv @ np.diag(sd[i] ** 2)) + (q_t.loc[i].double().numpy() - mu[i])
                   @ inv @ (q_t.loc[i].double().numpy() - mu[i]) - 4
                   + np.linalg.slogdet(cov)[1] - np.log(sd[i] ** 2).sum()) for i in range(2)]
    _close(kl_t, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(NotImplementedError):
        dist.kl_divergence(dist.Laplace(_t(mu), 1.0).to_event(1), q_t)


def test_car_reparameterised_gradient_matches_jax():
    """A draw of ``CAR`` goes through the normal of its precision matrix: the
    gradient of a weighted sum of draws in ``loc``, ``correlation`` and
    ``conditional_precision`` on JAX's normals (rtol 1e-5, atol 1e-5)."""
    key = random.PRNGKey(12)
    params = {"loc": np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32),
              "correlation": np.array([0.5, 0.8, -0.3], np.float32),
              "conditional_precision": np.array([2.0, 1.5, 0.7], np.float32)}
    weights = np.random.default_rng(1).uniform(0.5, 1.5, (6, 3, 4)).astype(np.float32)

    def loss_j(p):
        return (jdist.CAR(adj_matrix=jnp.asarray(RING4), **p).sample(key, (6,)) * weights).sum()

    grads_j = jax.grad(loss_j)({k: jnp.asarray(v) for k, v in params.items()})
    leaves = {k: _t(v).requires_grad_() for k, v in params.items()}
    source = FedDraws([("normals", random.normal(key, (6, 3, 4)))])
    (dist.CAR(adj_matrix=_t(RING4), **leaves).sample(source, (6,)) * _t(weights)).sum().backward()
    for k in params:
        _close(leaves[k].grad, grads_j[k], rtol=1e-5, atol=1e-5, what=k)
