"""The pieces under SVI's guides in the port against the JAX package: the
softplus and lower-Cholesky transforms, ``UnpackTransform``,
``LowerCholeskyAffine`` and the ``biject_to`` rows of their constraints;
``TransformedDistribution``, ``Delta``, ``MultivariateNormal`` and
``icdf``; every registered ``kl_divergence`` pair; ``init_to_median`` and
``init_to_value``; and the guides' ``median``, ``quantiles`` and
``sample_posterior`` at the same params.

Inputs are made from a seed with numpy.  Tolerances: ``rtol=1e-5,
atol=1e-6`` for elementwise float32 maps; ``rtol=1e-4, atol=1e-5`` where a
triangular solve, a norm or a log-determinant of a matrix sums in another
order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
import numpyro_tpu.infer.autoguide as jautoguide
import numpyro_tpu.optim as joptim
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.distributions import constraints as jconstraints
from numpyro_tpu.distributions import kl as jkl
from numpyro_tpu.distributions import transforms as jtransforms
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
import numpyro_tpu_torch.infer.autoguide as autoguide
import numpyro_tpu_torch.optim as optim
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions import constraints, transforms
from numpyro_tpu_torch.distributions.kl import kl_divergence
from numpyro_tpu_torch.infer import SVI, Trace_ELBO, initialization

torch.set_num_threads(1)

EW = {"rtol": 1e-5, "atol": 1e-6}  # elementwise maps
MAT = {"rtol": 1e-4, "atol": 1e-5}  # solves, norms, matrix log-determinants


def _close(t, j, tol=EW):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j), **tol)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# transforms and constraints
# ---------------------------------------------------------------------------


def test_softplus_transform_matches_jax_far_into_both_tails():
    x = np.concatenate([_rng().standard_normal(20) * 3, [-40.0, -20.0, 20.0, 25.0, 40.0]])
    x = x.astype(np.float32)
    t, jt = transforms.SoftplusTransform(), jtransforms.SoftplusTransform()
    y, jy = t(torch.tensor(x)), jt(jnp.asarray(x))
    _close(y, jy)
    # above 20 the JAX formula is not the identity (torch's softplus is)
    assert t(torch.tensor(20.5)).item() == float(jt(jnp.asarray(20.5, jnp.float32)))
    _close(t.log_abs_det_jacobian(torch.tensor(x), y), jt.log_abs_det_jacobian(jnp.asarray(x), jy))
    yp = np.abs(x[:20]) + 0.1
    _close(t.inv(torch.tensor(yp)), jt.inv(jnp.asarray(yp)))


@pytest.mark.parametrize("name", ["LowerCholeskyTransform", "ScaledUnitLowerCholeskyTransform"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_lower_cholesky_transforms_match_jax(name, batch):
    d = 4
    x = _rng(1).standard_normal(batch + (d * (d + 1) // 2,)).astype(np.float32)
    t, jt = getattr(transforms, name)(), getattr(jtransforms, name)()
    y, jy = t(torch.tensor(x)), jt(jnp.asarray(x))
    _close(y, jy, MAT)
    _close(t.inv(y), jt.inv(jy), MAT)
    _close(t.log_abs_det_jacobian(torch.tensor(x), y),
           jt.log_abs_det_jacobian(jnp.asarray(x), jy), MAT)
    assert t.forward_shape(batch + (10,)) == batch + (4, 4)
    assert t.inverse_shape(batch + (4, 4)) == batch + (10,)
    assert bool(constraints.lower_cholesky(y).all())


def test_lower_cholesky_affine_matches_jax():
    rng = _rng(2)
    loc = rng.standard_normal(3).astype(np.float32)
    a = rng.standard_normal((3, 3)).astype(np.float32)
    L = np.tril(a) + 3 * np.eye(3, dtype=np.float32)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    t = transforms.LowerCholeskyAffine(torch.tensor(loc), torch.tensor(L))
    jt = jtransforms.LowerCholeskyAffine(jnp.asarray(loc), jnp.asarray(L))
    y, jy = t(torch.tensor(x)), jt(jnp.asarray(x))
    _close(y, jy, MAT)
    _close(t.inv(y), jt.inv(jy), MAT)
    _close(t.log_abs_det_jacobian(torch.tensor(x), y), jt.log_abs_det_jacobian(jnp.asarray(x), jy))
    assert t.forward_shape((5, 3)) == (5, 3)


def test_unpack_transform_maps_leading_batch_dims():
    def unpack(v):
        return {"a": v[:2], "b": v[2:].reshape(2, 2)}

    t = transforms.UnpackTransform(unpack, pack_fn=lambda d: torch.cat([d["a"], d["b"].reshape(-1)]))
    x = torch.arange(18.0).reshape(3, 6)
    out = t(x)
    assert out["a"].shape == (3, 2) and out["b"].shape == (3, 2, 2)
    torch.testing.assert_close(out["b"][1], x[1, 2:].reshape(2, 2))
    torch.testing.assert_close(t.inv(t(x[0])), x[0])
    assert t.log_abs_det_jacobian(x, out).shape == (3,)
    with pytest.raises(NotImplementedError):
        transforms.UnpackTransform(unpack).inv(out)


def test_biject_to_rows_of_the_new_constraints():
    assert isinstance(transforms.biject_to(constraints.softplus_positive),
                      transforms.SoftplusTransform)
    # softplus_positive subclasses greater_than but keeps its own row; the
    # positive row stays exp then affine, as in the JAX package's table
    assert isinstance(transforms.biject_to(constraints.positive), transforms.ComposeTransform)
    assert type(transforms.biject_to(constraints.lower_cholesky)) is transforms.LowerCholeskyTransform
    assert isinstance(transforms.biject_to(constraints.scaled_unit_lower_cholesky),
                      transforms.ScaledUnitLowerCholeskyTransform)
    for c, jc in ((constraints.softplus_positive, jconstraints.softplus_positive),
                  (constraints.lower_cholesky, jconstraints.lower_cholesky),
                  (constraints.scaled_unit_lower_cholesky,
                   jconstraints.scaled_unit_lower_cholesky)):
        assert type(transforms.biject_to(c)).__name__ == type(jtransforms.biject_to(jc)).__name__


def test_new_constraints_match_jax():
    x = np.array([-1.0, 0.0, 2.0], np.float32)
    _close(constraints.softplus_positive(torch.tensor(x)), jconstraints.softplus_positive(jnp.asarray(x)))
    m = np.stack([np.tril(np.ones((3, 3))), np.ones((3, 3)),
                  np.diag([1.0, -1.0, 2.0])]).astype(np.float32)
    _close(constraints.lower_cholesky(torch.tensor(m)), jconstraints.lower_cholesky(jnp.asarray(m)))
    assert constraints.real_vector.event_dim == 1
    eye = constraints.lower_cholesky.feasible_like(torch.zeros(2, 3, 3))
    torch.testing.assert_close(eye, torch.eye(3).expand(2, 3, 3))


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_intermediates", [False, True])
def test_transformed_distribution_matches_jax(with_intermediates):
    rng = _rng(3)
    loc = rng.standard_normal(4).astype(np.float32)
    scale = (0.5 + rng.random(4)).astype(np.float32)
    base = dist.Normal(torch.tensor(loc), torch.tensor(scale))
    jbase = jdist.Normal(jnp.asarray(loc), jnp.asarray(scale))
    d = dist.TransformedDistribution(base, transforms.biject_to(constraints.positive))
    jd = jdist.TransformedDistribution(jbase, jtransforms.biject_to(jconstraints.positive))
    assert d.batch_shape == jd.batch_shape and d.event_shape == jd.event_shape
    assert d.has_rsample
    value, inter = d.sample_with_intermediates(torch.Generator().manual_seed(0), (2,))
    assert value.shape == (2, 4) and bool((value > 0).all())
    lp = d.log_prob(value, inter if with_intermediates else None)
    _close(lp, jd.log_prob(jnp.asarray(value.numpy())), MAT)


def test_transformed_distribution_of_an_event_transform():
    rng = _rng(4)
    loc = rng.standard_normal(3).astype(np.float32)
    L = (np.tril(rng.standard_normal((3, 3))) + 2 * np.eye(3)).astype(np.float32)
    base = dist.Normal(torch.zeros(3), 1.0).to_event(1)
    d = dist.TransformedDistribution(base, transforms.LowerCholeskyAffine(torch.tensor(loc),
                                                                          torch.tensor(L)))
    jd = jdist.TransformedDistribution(jdist.Normal(jnp.zeros(3), 1.0).to_event(1),
                                       jtransforms.LowerCholeskyAffine(jnp.asarray(loc),
                                                                       jnp.asarray(L)))
    x = rng.standard_normal((5, 3)).astype(np.float32)
    _close(d.log_prob(torch.tensor(x)), jd.log_prob(jnp.asarray(x)), MAT)
    assert d.event_shape == (3,)


@pytest.mark.parametrize("event_dim", [0, 1])
def test_delta_matches_jax(event_dim):
    v = _rng(5).standard_normal((2, 3)).astype(np.float32)
    ld = np.float32(0.25)
    d = dist.Delta(torch.tensor(v), log_density=torch.tensor(ld), event_dim=event_dim)
    jd = jdist.Delta(jnp.asarray(v), log_density=jnp.asarray(ld), event_dim=event_dim)
    assert d.batch_shape == jd.batch_shape and d.event_shape == jd.event_shape
    other = v + np.eye(2, 3, dtype=np.float32)
    for x in (v, other):
        _close(d.log_prob(torch.tensor(x)), jd.log_prob(jnp.asarray(x)))
    s = d.sample(torch.Generator(), (4,))
    assert s.shape == (4, 2, 3) and torch.equal(s[2], torch.tensor(v))
    assert d.support.event_dim == event_dim


def _mvn_params(seed=6, d=4, batch=()):
    rng = _rng(seed)
    loc = rng.standard_normal(batch + (d,)).astype(np.float32)
    a = rng.standard_normal(batch + (d, d)).astype(np.float32)
    cov = (a @ np.swapaxes(a, -1, -2) + d * np.eye(d)).astype(np.float32)
    return loc, cov


@pytest.mark.parametrize("how", ["scale_tril", "covariance_matrix", "precision_matrix"])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_multivariate_normal_matches_jax(how, batch):
    loc, cov = _mvn_params(batch=batch)
    mat = {"scale_tril": np.linalg.cholesky(cov), "covariance_matrix": cov,
           "precision_matrix": np.linalg.inv(cov)}[how].astype(np.float32)
    d = dist.MultivariateNormal(torch.tensor(loc), **{how: torch.tensor(mat)})
    jd = jdist.MultivariateNormal(jnp.asarray(loc), **{how: jnp.asarray(mat)})
    assert d.batch_shape == jd.batch_shape and d.event_shape == jd.event_shape
    x = _rng(7).standard_normal((3,) + batch + (4,)).astype(np.float32)
    _close(d.log_prob(torch.tensor(x)), jd.log_prob(jnp.asarray(x)), MAT)
    _close(d.scale_tril, jd.scale_tril, MAT)
    _close(d.covariance_matrix, jd.covariance_matrix, MAT)
    _close(d.precision_matrix, jd.precision_matrix, MAT)
    _close(d.variance, jd.variance, MAT)


def test_multivariate_normal_rsample_is_loc_plus_scale_tril_noise():
    loc, cov = _mvn_params()
    L = torch.tensor(np.linalg.cholesky(cov).astype(np.float32), requires_grad=True)
    d = dist.MultivariateNormal(torch.tensor(loc), scale_tril=L)
    g = torch.Generator().manual_seed(3)
    x = d.rsample(g, (5,))
    white = torch.randn((5, 4), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(x, torch.tensor(loc) + white @ L.T)
    x.sum().backward()
    assert L.grad is not None


def test_icdf_matches_jax():
    q = np.array([0.01, 0.1, 0.5, 0.9, 0.999], np.float32)
    _close(dist.Normal(1.0, 2.0).icdf(torch.tensor(q)), jdist.Normal(1.0, 2.0).icdf(jnp.asarray(q)),
           MAT)
    _close(dist.Cauchy(1.0, 2.0).icdf(torch.tensor(q)), jdist.Cauchy(1.0, 2.0).icdf(jnp.asarray(q)),
           MAT)


# ---------------------------------------------------------------------------
# kl_divergence, pair by pair
# ---------------------------------------------------------------------------


def _normals(seed, shape):
    rng = _rng(seed)
    loc = rng.standard_normal(shape).astype(np.float32)
    scale = (0.5 + rng.random(shape)).astype(np.float32)
    return (dist.Normal(torch.tensor(loc), torch.tensor(scale)),
            jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)))


def _kl_cases():
    p, jp = _normals(10, (3,))
    q, jq = _normals(11, (3,))
    q0, jq0 = _normals(12, ())
    loc, cov = _mvn_params(13)
    loc2, cov2 = _mvn_params(14)
    mvn = dist.MultivariateNormal(torch.tensor(loc), covariance_matrix=torch.tensor(cov))
    jmvn = jdist.MultivariateNormal(jnp.asarray(loc), covariance_matrix=jnp.asarray(cov))
    mvn2 = dist.MultivariateNormal(torch.tensor(loc2), covariance_matrix=torch.tensor(cov2))
    jmvn2 = jdist.MultivariateNormal(jnp.asarray(loc2), covariance_matrix=jnp.asarray(cov2))
    v = _rng(15).standard_normal(3).astype(np.float32)
    mask = np.array([True, False, True])
    return {
        "normal": ((p, q), (jp, jq)),
        "independent": ((p.to_event(1), q.to_event(1)), (jp.to_event(1), jq.to_event(1))),
        "dist_expanded": ((p, q0.expand((3,))), (jp, jq0.expand((3,)))),
        "expanded_dist": ((q0.expand((3,)), p), (jq0.expand((3,)), jp)),
        "expanded_expanded": ((q0.expand((2, 3)), p.expand((2, 3))),
                              (jq0.expand((2, 3)), jp.expand((2, 3)))),
        "delta": ((dist.Delta(torch.tensor(v), torch.tensor(0.5)), q),
                  (jdist.Delta(jnp.asarray(v), jnp.asarray(0.5)), jq)),
        "delta_expanded": ((dist.Delta(torch.tensor(v), torch.tensor(0.5)), q0.expand((3,))),
                           (jdist.Delta(jnp.asarray(v), jnp.asarray(0.5)), jq0.expand((3,)))),
        "masked": ((p.mask(torch.tensor(mask)), q.mask(torch.tensor(mask))),
                   (jp.mask(jnp.asarray(mask)), jq.mask(jnp.asarray(mask)))),
        "masked_false": ((p.mask(False), q.mask(False)), (jp.mask(False), jq.mask(False))),
        "mvn": ((mvn, mvn2), (jmvn, jmvn2)),
    }


@pytest.mark.parametrize("pair", list(_kl_cases()))
def test_kl_divergence_matches_jax(pair):
    (p, q), (jp, jq) = _kl_cases()[pair]
    _close(kl_divergence(p, q), jkl.kl_divergence(jp, jq), MAT)


def test_kl_divergence_of_an_unregistered_pair_raises():
    p, _ = _normals(1, ())
    with pytest.raises(NotImplementedError):
        kl_divergence(dist.HalfCauchy(1.0), p)


# ---------------------------------------------------------------------------
# init strategies
# ---------------------------------------------------------------------------


def _site(fn, name="x", value=None):
    return {"type": "sample", "name": name, "fn": fn, "value": value, "is_observed": False,
            "kwargs": {"rng_key": torch.Generator().manual_seed(0), "sample_shape": ()}}


@pytest.mark.parametrize("num_samples", [15, 4])
def test_init_to_median_takes_the_middle_of_the_draws(num_samples):
    site = _site(dist.Normal(torch.zeros(3), 1.0))
    got = initialization.init_to_median(site, num_samples=num_samples)
    draws = dist.Normal(torch.zeros(3), 1.0).sample(torch.Generator().manual_seed(0),
                                                    (num_samples,))
    # jnp.median averages the two middle draws of an even count
    _close(got, jnp.median(jnp.asarray(draws.numpy()), axis=0))
    assert got.device == draws.device


def test_init_to_value_and_its_fallback():
    strategy = initialization.init_to_value(values={"x": torch.tensor(0.3)})
    assert strategy(_site(dist.Normal(0.0, 1.0))).item() == pytest.approx(0.3)
    fallback = strategy(_site(dist.HalfCauchy(1.0), name="y"))
    assert fallback.item() > 0  # init_to_uniform's draw, pushed onto the support
    assert strategy({"type": "param", "name": "x", "is_observed": False}) is None


@pytest.mark.parametrize("validate_grad,forward", [(False, False), (True, False), (True, True)])
def test_init_to_median_through_initialize_model_for_one_chain(validate_grad, forward):
    def model():
        npt.sample("s", dist.HalfNormal(torch.ones(2)))

    from numpyro_tpu_torch.infer import util

    info = util.initialize_model(torch.Generator().manual_seed(0), model,
                                 init_strategy=initialization.init_to_median(num_samples=15),
                                 validate_grad=validate_grad,
                                 forward_mode_differentiation=forward)
    z, pe, grad = info.param_info
    assert z["s"].shape == (2,) and torch.isfinite(pe)
    torch.testing.assert_close(pe, info.potential_fn(z))
    if validate_grad:
        torch.testing.assert_close(grad["s"], torch.func.grad(info.potential_fn)(z)["s"])
    else:
        assert grad is None


# ---------------------------------------------------------------------------
# the guides at the same params
# ---------------------------------------------------------------------------


def _horseshoe(n=20, d=3):
    rng = np.random.RandomState(0)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ np.array([1.5, 0.0, -1.0]) + 0.5 * rng.randn(n)).astype(np.float32)
    return X, y


def jax_model(X, y):
    tau = numpyro_tpu.sample("tau", jdist.HalfCauchy(0.1))
    with numpyro_tpu.plate("D", X.shape[1]):
        beta = numpyro_tpu.sample("beta", jdist.Normal(0.0, tau))
    sigma = numpyro_tpu.sample("sigma", jdist.HalfNormal(1.0))
    with numpyro_tpu.plate("N", X.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(X @ beta, sigma), obs=y)


def torch_model(X, y):
    tau = npt.sample("tau", dist.HalfCauchy(0.1))
    with npt.plate("D", X.shape[1]):
        beta = npt.sample("beta", dist.Normal(0.0, tau))
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    with npt.plate("N", X.shape[0]):
        npt.sample("y", dist.Normal(X @ beta, sigma), obs=y)


def _guides(name):
    X, y = _horseshoe()
    jg = getattr(jautoguide, name)(jax_model)
    jsvi = jinfer.SVI(jax_model, jg, joptim.Adam(0.01), jinfer.Trace_ELBO())
    jstate = jsvi.init(random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y))
    tg = getattr(autoguide, name)(torch_model)
    tsvi = SVI(torch_model, tg, optim.Adam(0.01), Trace_ELBO(), device="cpu")
    tstate = tsvi.init(0, torch.tensor(X), torch.tensor(y))
    rng = _rng(20)
    u = {k: (np.asarray(v) + 0.2 * rng.standard_normal(np.shape(v))).astype(np.float32)
         for k, v in jsvi.optim.get_params(jstate[0]).items()}
    jp = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    tp = tsvi.constrain_fn({k: torch.tensor(v) for k, v in u.items()})
    return jg, tg, jp, tp, tsvi, tstate


@pytest.mark.parametrize("name", ["AutoNormal", "AutoDelta", "AutoDiagonalNormal",
                                  "AutoMultivariateNormal"])
def test_guide_params_and_median_match_jax(name):
    jg, tg, jp, tp, _, _ = _guides(name)
    assert {k: tuple(np.shape(v)) for k, v in jp.items()} == {k: tuple(v.shape)
                                                              for k, v in tp.items()}
    for k in jp:
        _close(tp[k], jp[k], MAT)
    jm, tm = jg.median(jp), tg.median(tp)
    assert set(jm) == set(tm) == {"tau", "beta", "sigma"}
    for k in jm:
        _close(tm[k], jm[k], MAT)


@pytest.mark.parametrize("name", ["AutoNormal", "AutoDiagonalNormal", "AutoMultivariateNormal"])
def test_guide_quantiles_match_jax(name):
    jg, tg, jp, tp, _, _ = _guides(name)
    q = [0.1, 0.5, 0.9]
    jq, tq = jg.quantiles(jp, q), tg.quantiles(tp, q)
    for k in jq:
        assert tuple(tq[k].shape) == tuple(np.shape(jq[k]))
        _close(tq[k], jq[k], MAT)


@pytest.mark.parametrize("name", ["AutoNormal", "AutoDelta", "AutoDiagonalNormal",
                                  "AutoMultivariateNormal"])
def test_sample_posterior_shapes_and_supports(name):
    jg, tg, jp, tp, _, _ = _guides(name)
    X, y = _horseshoe()
    draws = tg.sample_posterior(torch.Generator().manual_seed(1), tp, torch.tensor(X),
                                torch.tensor(y), sample_shape=(100, 2))
    jdraws = jg.sample_posterior(random.PRNGKey(1), jp, jnp.asarray(X), jnp.asarray(y),
                                 sample_shape=(100, 2))
    for k in jdraws:
        assert tuple(draws[k].shape) == tuple(np.shape(jdraws[k]))
    assert bool((draws["tau"] > 0).all()) and bool((draws["sigma"] > 0).all())
    if name != "AutoDelta":
        # 200 draws: the medians of the draws sit near the guide's median
        med = tg.median(tp)
        for k in ("tau", "sigma"):
            assert torch.allclose(draws[k].median(), med[k], rtol=0.5)


def test_autonormal_keeps_plates_and_event_dims_as_jax():
    X, y = _horseshoe()
    jg, tg, jp, tp, tsvi, tstate = _guides("AutoNormal")
    tr = handlers.trace(handlers.seed(handlers.substitute(tg, data=tp), 0)).get_trace(
        torch.tensor(X), torch.tensor(y))
    jtr = jhandlers.trace(jhandlers.seed(jhandlers.substitute(jg, data=jp), 0)).get_trace(
        jnp.asarray(X), jnp.asarray(y))
    sites = lambda t: [(k, s["type"]) for k, s in t.items()]  # noqa: E731
    assert sites(tr) == sites(jtr)
    assert [f.name for f in tr["beta"]["cond_indep_stack"]] == ["D"]
    assert type(tr["tau"]["fn"]).__name__ == "TransformedDistribution"
    assert tg._event_dims == jg._event_dims


def test_packed_latent_is_sorted_by_site_name_as_ravel_pytree():
    _, tg, jp, tp, _, _ = _guides("AutoDiagonalNormal")
    unpacked = tg._unpack_latent(torch.arange(5.0))
    assert list(unpacked) == ["beta", "sigma", "tau"]
    torch.testing.assert_close(unpacked["beta"], torch.arange(3.0))


def test_autodelta_on_a_subsampled_model_recreates_the_plate():
    """The HMCECS example's MAP: AutoDelta on a model whose likelihood lives
    in a subsampled plate; the guide's plate carries the subsample size."""
    rng = _rng(21)
    X = torch.tensor(rng.standard_normal((500, 3)).astype(np.float32))
    y = torch.tensor((rng.random(500) < 0.5).astype(np.float32))

    def model(X, y):
        w = npt.sample("w", dist.Normal(torch.zeros(3), 1.0).to_event(1))
        with npt.plate("N", X.shape[0], subsample_size=50):
            xb = npt.subsample(X, event_dim=1)
            yb = npt.subsample(y, event_dim=0)
            npt.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)

    guide = autoguide.AutoDelta(model)
    res = SVI(model, guide, optim.Adam(0.05), Trace_ELBO(), device="cpu").run(0, 50, X, y)
    assert guide._plate_frames["N"].subsample_size == 50
    assert guide._plate_full_sizes["N"] == 500
    tr = handlers.trace(handlers.seed(guide, 3)).get_trace(X, y)
    assert tr["N"]["value"].shape == (50,)
    assert torch.isfinite(res.losses).all() and res.params["auto_w_loc"].shape == (3,)
