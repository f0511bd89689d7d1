"""The DAIS guides and the batched guides in the port against the JAX
package's: the ELBO loss and every parameter's gradient at the same params
on JAX's draws, ``sample_posterior`` and ``median``, the hyperparameter
checks, and whole runs under ``tests/infer/test_autoguide_extra.py``'s
gates.

JAX's draws: a DAIS guide's ``z_0`` and momentum noise are read back from
JAX's own guide trace (``(z_0 - loc) / scale``, or through the Cholesky
factor; momentum / mass); a batched guide's from the key its seed handler
gives the packed latent.  They reach the port through ``test_torch_svi``'s
``torch.randn`` queue, in the order the port draws: ``z_0``, then the
``(K, D)`` momentum; for the low-rank guide the rank noise, then the
diagonal noise.  The DAIS guides keep ``log q`` in both packages (``z_0``
has its full density, the momentum is masked, the log-weight enters through
``factor``); JAX's batched guides leave it out of the packed latent
(ROADMAP.md, Queue 3) and the JAX reference adds it back.

Tolerances: losses to ``rtol=1e-5``; gradients to ``rtol=1e-4, atol=1e-5``
(float32 sums in another order, and for DAIS the second derivatives of K
annealing steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random
from jax.scipy.linalg import solve_triangular

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu import infer as jinfer
from numpyro_tpu import optim as joptim
from numpyro_tpu.infer import autoguide as jautoguide
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import nn, optim
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.infer import SVI, Trace_ELBO, autoguide

from test_torch_flow_guides import (
    POST_MEAN, assert_trees_close, sum_model_j, sum_model_t, torch_value_and_grad,
)
from test_torch_svi import _guide_seeds

torch.set_num_threads(1)

LOSS_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-4, 1e-5


def surrogate_j():
    x = numpyro_tpu.sample("x", jdist.Normal(jnp.zeros(2), 1.0).to_event(1))
    s = numpyro_tpu.param("surrogate_scale", 0.7, constraint=jdist.constraints.positive)
    numpyro_tpu.sample("y", jdist.Normal(x.sum(), s), obs=2.0)


def surrogate_t():
    x = npt.sample("x", dist.Normal(torch.zeros(2), 1.0).to_event(1))
    s = npt.param("surrogate_scale", torch.tensor(0.7), constraint=constraints.positive)
    npt.sample("y", dist.Normal(x.sum(), s), obs=torch.tensor(2.0))


def batched_model_j(y):
    with numpyro_tpu.plate("B", 3):
        x = numpyro_tpu.sample("x", jdist.Normal(jnp.zeros(2), 1.0).to_event(1))
        numpyro_tpu.sample("y", jdist.Normal(x.sum(-1), 0.5), obs=y)


def batched_model_t(y):
    with npt.plate("B", 3):
        x = npt.sample("x", dist.Normal(torch.zeros(2), 1.0).to_event(1))
        npt.sample("y", dist.Normal(x.sum(-1), 0.5), obs=y)


BATCHED_Y = np.array([1.0, 2.0, -1.0], np.float32)


def _svis(jguide, tguide, jmodel, tmodel, jargs, targs, num_particles, seed=7,
          keep=("auto_eta_coeff",)):
    """Both guides set up by ``init``; JAX's init moved by a seeded step
    (the params named in ``keep`` stay at their initial values: a DAIS
    guide's ``eta_coeff`` at 0, so that the step size ``eta0 + eta_coeff *
    beta`` stays inside its clip and every param reaches the loss)."""
    jsvi = jinfer.SVI(jmodel, jguide, joptim.Adam(0.01), jinfer.Trace_ELBO(num_particles))
    jstate = jsvi.init(random.PRNGKey(0), *jargs)
    tsvi = SVI(tmodel, tguide, optim.Adam(0.01), Trace_ELBO(num_particles), device="cpu")
    tstate = tsvi.init(0, *targs)
    uj = jsvi.optim.get_params(jstate[0])
    ut = tsvi.optim.get_params(tstate.optim_state)
    assert {k: tuple(np.shape(v)) for k, v in uj.items()} == {
        k: tuple(v.shape) for k, v in ut.items()}
    rng = np.random.default_rng(seed)
    u = {k: np.asarray(v) if k in keep else
         (np.asarray(v) + 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
         for k, v in uj.items()}
    return jsvi, tsvi, u


def _dais_noise(jguide, params, seeds, args, cholesky):
    """z_0's standard-normal noise and the momentum's, per guide seed."""
    z_rows, m_rows = [], []
    for seed in seeds:
        tr = jhandlers.trace(
            jhandlers.substitute(jhandlers.seed(jguide, seed), data=params)).get_trace(*args)
        z0, mom = tr["auto_z_0"]["value"], tr["auto_momentum"]["value"]
        loc = params["auto_z_0_loc"]
        if cholesky:
            z_rows.append(solve_triangular(params["auto_z_0_scale_tril"], z0 - loc, lower=True))
        else:
            z_rows.append((z0 - loc) / params["auto_z_0_scale"])
        m_rows.append(mom / params["auto_mass_matrix"])
    return [np.stack([np.asarray(r) for r in z_rows]), np.stack([np.asarray(r) for r in m_rows])]


def _jax_value_and_grad(jsvi, jloss, jmodel, jguide, jargs, key, u, missing=None):
    def fn(u):
        params = jsvi.constrain_fn(u)
        loss = jloss.loss(key, params, jmodel, jguide, *jargs)
        return loss if missing is None else loss + jnp.mean(missing(params))

    return jax.jit(jax.value_and_grad(fn))({k: jnp.asarray(v) for k, v in u.items()})


def _torch_value_and_grad(tsvi, tmodel, tguide, targs, u, noise, num_particles, monkeypatch):
    tables = [np.asarray(t, dtype=np.float32) for t in noise]
    return torch_value_and_grad(tsvi, Trace_ELBO(num_particles), tmodel, tguide, targs, u,
                                tables, monkeypatch)


# ---------------------------------------------------------------------------
# DAIS


@pytest.mark.parametrize("base_dist", ["diagonal", "cholesky"])
@pytest.mark.parametrize("num_particles", [1, 2])
def test_dais_loss_and_gradient_match_jax(base_dist, num_particles, monkeypatch):
    jguide = jautoguide.AutoDAIS(sum_model_j, K=3, base_dist=base_dist)
    tguide = autoguide.AutoDAIS(sum_model_t, K=3, base_dist=base_dist)
    jsvi, tsvi, u = _svis(jguide, tguide, sum_model_j, sum_model_t, (2.0,),
                          (torch.tensor(2.0),), num_particles)
    key = random.PRNGKey(3)
    params = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    seeds = _guide_seeds(key, num_particles, num_particles > 1)
    noise = _dais_noise(jguide, params, seeds, (2.0,), base_dist == "cholesky")
    jval, jgrad = _jax_value_and_grad(jsvi, jinfer.Trace_ELBO(num_particles), sum_model_j,
                                      jguide, (2.0,), key, u)
    tval, tgrad = _torch_value_and_grad(tsvi, sum_model_t, tguide, (torch.tensor(2.0),), u,
                                        noise, num_particles, monkeypatch)
    np.testing.assert_allclose(tval, float(jval), rtol=LOSS_RTOL)
    assert_trees_close(tgrad, jgrad, G_RTOL, G_ATOL)


def test_surrogate_dais_matches_jax_and_holds_the_surrogate_params(monkeypatch):
    """The loss and every gradient agree with JAX's.  Both packages
    evaluate the surrogate's potential under ``block()``, which hides its
    param from SVI's substitution: the param is registered with the guide's
    but its gradient is exactly 0 in both (ROADMAP.md, Queue 3)."""
    jguide = jautoguide.AutoSurrogateLikelihoodDAIS(sum_model_j, surrogate_j, K=2)
    tguide = autoguide.AutoSurrogateLikelihoodDAIS(sum_model_t, surrogate_t, K=2)
    jsvi, tsvi, u = _svis(jguide, tguide, sum_model_j, sum_model_t, (2.0,),
                          (torch.tensor(2.0),), 1, keep=("surrogate_scale", "auto_eta_coeff"))
    np.testing.assert_allclose(np.exp(u["surrogate_scale"]), 0.7, rtol=1e-6)
    key = random.PRNGKey(3)
    params = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    noise = _dais_noise(jguide, params, _guide_seeds(key, 1, False), (2.0,), False)
    jval, jgrad = _jax_value_and_grad(jsvi, jinfer.Trace_ELBO(), sum_model_j, jguide, (2.0,),
                                      key, u)
    tval, tgrad = _torch_value_and_grad(tsvi, sum_model_t, tguide, (torch.tensor(2.0),), u,
                                        noise, 1, monkeypatch)
    np.testing.assert_allclose(tval, float(jval), rtol=LOSS_RTOL)
    assert float(jgrad["surrogate_scale"]) == 0.0
    assert tgrad["surrogate_scale"].item() == 0.0
    assert_trees_close(tgrad, jgrad, G_RTOL, G_ATOL)


def test_dais_sample_posterior_matches_jax(monkeypatch):
    jguide = jautoguide.AutoDAIS(sum_model_j, K=3)
    tguide = autoguide.AutoDAIS(sum_model_t, K=3)
    jsvi, tsvi, u = _svis(jguide, tguide, sum_model_j, sum_model_t, (2.0,),
                          (torch.tensor(2.0),), 1)
    jparams = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    tparams = tsvi.constrain_fn(nn.params_from_numpy(u, "cpu"))
    key = random.PRNGKey(5)
    want = jguide.sample_posterior(key, jparams)
    tr = jhandlers.trace(jhandlers.substitute(jhandlers.seed(jguide._sample_latent, key),
                                              data=jparams)).get_trace()
    z0 = (tr["auto_z_0"]["value"] - jparams["auto_z_0_loc"]) / jparams["auto_z_0_scale"]
    mom = tr["auto_momentum"]["value"] / jparams["auto_mass_matrix"]
    from test_torch_svi import fed_noise

    with fed_noise(monkeypatch, [torch.from_numpy(np.asarray(z0)),
                                 torch.from_numpy(np.asarray(mom))]):
        got = tguide.sample_posterior(torch.Generator().manual_seed(0), tparams)
    np.testing.assert_allclose(got["x"].detach().numpy(), np.asarray(want["x"]), rtol=1e-5,
                               atol=1e-6)
    # a batch of draws, one annealing run each
    many = tguide.sample_posterior(torch.Generator().manual_seed(1), tparams, sample_shape=(4, 5))
    assert many["x"].shape == (4, 5, 2) and torch.isfinite(many["x"]).all()
    assert len(torch.unique(many["x"][..., 0])) == 20
    with pytest.raises(NotImplementedError):
        tguide.get_transform(tparams)


@pytest.mark.parametrize("kwargs,match", [
    ({"K": 0}, "K must satisfy"),
    ({"eta_init": 0.0}, "eta_init must be positive"),
    ({"eta_init": 0.2, "eta_max": 0.1}, "eta_init must be positive"),
    ({"gamma_init": 1.0}, "gamma_init must be in"),
    ({"init_scale": 0.0}, "init_scale must be positive"),
    ({"base_dist": "full"}, "base_dist must be one of"),
])
def test_dais_hyperparameter_checks_raise_as_in_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        jautoguide.AutoDAIS(sum_model_j, **kwargs)
    with pytest.raises(ValueError, match=match):
        autoguide.AutoDAIS(sum_model_t, **kwargs)


def test_dais_refuses_subsampling_and_semi_dais_is_a_placeholder():
    def model():
        with npt.plate("N", 10, subsample_size=5):
            npt.sample("x", dist.Normal(0.0, 1.0))

    with pytest.raises(NotImplementedError, match="subsampling"):
        SVI(model, autoguide.AutoDAIS(model), optim.Adam(0.01), Trace_ELBO(),
            device="cpu").init(0)
    # AutoSemiDAIS, a placeholder that raised until it was ported, now takes
    # the subsampled model: its per-datum params have the plate's full size
    # and a step gives a finite loss (tests/test_torch_semi_dais.py holds it
    # to the JAX package)
    svi = SVI(model, autoguide.AutoSemiDAIS(model, model, None, K=2), optim.Adam(0.01),
              Trace_ELBO(), device="cpu")
    state = svi.init(0)
    params = svi.get_params(state)
    assert params["auto_eta0"].shape == (10,) and params["auto_z_0_loc"].shape == (10, 1)
    state, loss = svi.update(state)
    assert torch.isfinite(loss)


def _demo_data(n=100):
    """``examples/dais_demo.py``'s strongly correlated design, numpy seed 0."""
    rng = np.random.RandomState(0)
    base = rng.randn(n, 1)
    X = np.concatenate([base + 0.1 * rng.randn(n, 1), base + 0.1 * rng.randn(n, 1)], 1)
    return X.astype(np.float32), (rng.rand(n) < 0.5).astype(np.float32)


def demo_model_j(X, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(2), 1.0).to_event(1))
    with numpyro_tpu.plate("N", X.shape[0]):
        numpyro_tpu.sample("y", jdist.Bernoulli(logits=X @ w), obs=y)


def demo_model_t(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(2), 1.0).to_event(1))
    with npt.plate("N", X.shape[0]):
        npt.sample("y", dist.Bernoulli(logits=X @ w), obs=y)


def test_dais_training_follows_jax_on_jax_draws(monkeypatch):
    """Thirty Adam steps of ``AutoDAIS(K=4)`` on the DAIS demo's model from
    w = 0, each on JAX's draws for that step: the port's params follow JAX's
    (the learned step size ``eta0 + eta_coeff * beta``, whose growth decides
    whether the annealing recovers the posterior's correlation, included).
    Tolerance: rtol 1e-4, atol 1e-5 on the unconstrained params, float32
    rounding compounded over the steps."""
    from numpyro_tpu.infer.initialization import init_to_value as jinit_to_value
    from numpyro_tpu_torch.infer import init_to_value

    P, steps = 4, 30
    X, y = _demo_data()
    jX, jy, tX, ty = jnp.asarray(X), jnp.asarray(y), torch.from_numpy(X), torch.from_numpy(y)
    jguide = jautoguide.AutoDAIS(demo_model_j, K=4,
                                 init_loc_fn=jinit_to_value(values={"w": jnp.zeros(2)}))
    tguide = autoguide.AutoDAIS(demo_model_t, K=4,
                                init_loc_fn=init_to_value(values={"w": torch.zeros(2)}))
    jsvi = jinfer.SVI(demo_model_j, jguide, joptim.Adam(5e-3), jinfer.Trace_ELBO(P))
    jopt = jsvi.init(random.PRNGKey(0), jX, jy)[0]
    tsvi = SVI(demo_model_t, tguide, optim.Adam(5e-3), Trace_ELBO(P), device="cpu")
    topt = tsvi.init(0, tX, ty).optim_state
    jloss = jinfer.Trace_ELBO(P)
    jvg = jax.jit(jax.value_and_grad(
        lambda u, key: jloss.loss(key, jsvi.constrain_fn(u), demo_model_j, jguide, jX, jy)))
    for t in range(steps):
        key = random.fold_in(random.PRNGKey(1), t)
        uj = jsvi.optim.get_params(jopt)
        jval, jgrad = jvg(uj, key)
        noise = _dais_noise(jguide, jsvi.constrain_fn(uj), _guide_seeds(key, P, True),
                            (jX, jy), False)
        ut = {k: v.numpy() for k, v in tsvi.optim.get_params(topt).items()}
        tval, tgrad = _torch_value_and_grad(tsvi, demo_model_t, tguide, (tX, ty), ut, noise, P,
                                            monkeypatch)
        np.testing.assert_allclose(tval, float(jval), rtol=LOSS_RTOL)
        jopt = jsvi.optim.update(jgrad, jopt)
        topt = tsvi.optim.update(tgrad, topt)
    uj, ut = jsvi.optim.get_params(jopt), tsvi.optim.get_params(topt)
    assert float(uj["auto_eta_coeff"]) > 0.01  # the step size has started to grow
    assert_trees_close(ut, uj, G_RTOL, G_ATOL)


def test_dais_converges():
    """``tests/infer/test_autoguide_extra.py``'s check on the port."""
    guide = autoguide.AutoDAIS(sum_model_t, K=4)
    res = SVI(sum_model_t, guide, optim.Adam(0.01), Trace_ELBO(num_particles=4),
              device="cpu").run(0, 800, torch.tensor(2.0))
    assert torch.isfinite(res.losses[-50:]).all()
    s = guide.sample_posterior(torch.Generator().manual_seed(1), res.params, sample_shape=(500,))
    assert abs(s["x"].sum(-1).mean().item() - POST_MEAN) < 0.3


# ---------------------------------------------------------------------------
# the batched guides


BATCHED = ["AutoBatchedMultivariateNormal", "AutoBatchedLowRankMultivariateNormal"]


def _batched_noise(jguide, params, seeds, args, name, rank):
    tables = [[], []]
    for seed in seeds:
        tr = jhandlers.trace(
            jhandlers.substitute(jhandlers.seed(jguide, seed), data=params)).get_trace(*args)
        site_key = tr["_auto_latent"]["kwargs"]["rng_key"]
        if name == "AutoBatchedMultivariateNormal":
            tables[0].append(np.asarray(random.normal(site_key, (3, 2))))
        else:
            k_low, k_diag = random.split(site_key)
            tables[0].append(np.asarray(random.normal(k_low, (3, rank))))
            tables[1].append(np.asarray(random.normal(k_diag, (3, 2))))
    return [np.stack(t) for t in tables if t]


def _batched_latent(base, noise, name):
    if name == "AutoBatchedMultivariateNormal":
        (eps,) = noise
        return base.loc + (base.scale_tril @ eps[..., None])[..., 0]
    eps_low, eps_diag = noise
    return (base.loc + (base.cov_factor @ eps_low[..., None])[..., 0]
            + jnp.sqrt(base.cov_diag) * eps_diag)


@pytest.mark.parametrize("name", BATCHED)
@pytest.mark.parametrize("num_particles", [1, 3])
def test_batched_guide_loss_gradient_and_median_match_jax(name, num_particles, monkeypatch):
    jguide = getattr(jautoguide, name)(batched_model_j, batch_ndim=1)
    tguide = getattr(autoguide, name)(batched_model_t, batch_ndim=1)
    jargs, targs = (jnp.asarray(BATCHED_Y),), (torch.from_numpy(BATCHED_Y),)
    jsvi, tsvi, u = _svis(jguide, tguide, batched_model_j, batched_model_t, jargs, targs,
                          num_particles)
    assert tguide._batch_shape == jguide._batch_shape == (3,)
    assert tguide._event_shape == jguide._event_shape == (2,)
    key = random.PRNGKey(3)
    params = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    rank = 1
    seeds = _guide_seeds(key, num_particles, num_particles > 1)
    noise = _batched_noise(jguide, params, seeds, jargs, name, rank)

    def missing(params):
        # log q of the packed latent, which JAX's guide leaves out
        posterior = jhandlers.substitute(jguide._get_posterior, data=params)()
        base = posterior.base_dist
        base = getattr(base, "base_dist", base)  # under the reshape's extra event dim
        latent = _batched_latent(base, [jnp.asarray(t) for t in noise], name)
        return posterior.log_prob(latent.reshape(latent.shape[:-2] + (6,)))

    jval, jgrad = _jax_value_and_grad(jsvi, jinfer.Trace_ELBO(num_particles), batched_model_j,
                                      jguide, jargs, key, u, missing)
    tval, tgrad = _torch_value_and_grad(tsvi, batched_model_t, tguide, targs, u, noise,
                                        num_particles, monkeypatch)
    np.testing.assert_allclose(tval, float(jval), rtol=LOSS_RTOL)
    assert_trees_close(tgrad, jgrad, G_RTOL, G_ATOL)
    tparams = tsvi.constrain_fn(nn.params_from_numpy(u, "cpu"))
    np.testing.assert_allclose(tguide.median(tparams)["x"].numpy(),
                               np.asarray(jguide.median(params)["x"]), rtol=1e-6)


def test_batched_guides_check_their_batch_shapes():
    def unbatched(y):
        npt.sample("x", dist.Normal(0.0, 1.0))

    def mixed(y):
        with npt.plate("B", 3):
            npt.sample("x", dist.Normal(0.0, 1.0))
        with npt.plate("C", 2):
            npt.sample("z", dist.Normal(0.0, 1.0))

    for model, err, match in ((unbatched, ValueError, "Expected 1 batch dimensions"),
                              (mixed, ValueError, "inconsistent batch shapes")):
        with pytest.raises(err, match=match):
            SVI(model, autoguide.AutoBatchedMultivariateNormal(model, batch_ndim=1),
                optim.Adam(0.01), Trace_ELBO(), device="cpu").init(0, None)
    with pytest.raises(ValueError, match="init_scale"):
        autoguide.AutoBatchedLowRankMultivariateNormal(batched_model_t, init_scale=0.0,
                                                       batch_ndim=1)


@pytest.mark.parametrize("name", BATCHED)
def test_batched_guides_converge(name):
    """``tests/infer/test_autoguide_extra.py``'s check on the port."""
    y = torch.from_numpy(BATCHED_Y)
    guide = getattr(autoguide, name)(batched_model_t, batch_ndim=1)
    res = SVI(batched_model_t, guide, optim.Adam(0.05), Trace_ELBO(), device="cpu").run(
        0, 800, y)
    est = guide.median(res.params)["x"].sum(-1)
    np.testing.assert_allclose(est.numpy(), 2 * BATCHED_Y / 2.25, atol=0.3)
