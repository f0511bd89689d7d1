"""``Predictive``, ``log_likelihood`` and ``soft_vmap`` in the port against
the JAX package, on JAX's own posterior samples and SVI params handed over
with ``samples_from_numpy``.  Deterministic sites and log-likelihoods agree
to 1e-5 relative; draws agree by moments within 4 Monte-Carlo standard
errors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
import numpyro_tpu.infer.autoguide as jautoguide
import numpyro_tpu.optim as joptim
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu import util as jax_util
from numpyro_tpu.infer import reparam as jreparam
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.infer import SVI, Predictive, Trace_ELBO, log_likelihood, reparam
from numpyro_tpu_torch.infer import autoguide
from numpyro_tpu_torch.infer.util import samples_from_numpy
from numpyro_tpu_torch.optim import Adam
from numpyro_tpu_torch.util import soft_vmap

torch.set_num_threads(1)

Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32)
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], np.float32)
RTOL = 1e-5


def jax_model(y, sigma):
    mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, 5.0))
    tau = numpyro_tpu.sample("tau", jdist.HalfCauchy(5.0))
    with numpyro_tpu.plate("J", 8):
        theta = numpyro_tpu.sample("theta", jdist.Normal(mu, tau))
        numpyro_tpu.sample("obs", jdist.Normal(theta, sigma), obs=y)


def torch_model(y, sigma):
    mu = npt.sample("mu", dist.Normal(0.0, 5.0))
    tau = npt.sample("tau", dist.HalfCauchy(5.0))
    with npt.plate("J", 8):
        theta = npt.sample("theta", dist.Normal(mu, tau))
        npt.sample("obs", dist.Normal(theta, sigma), obs=y)


JMODEL = jhandlers.reparam(jax_model, config={"theta": jreparam.LocScaleReparam(0)})
TMODEL = handlers.reparam(torch_model, config={"theta": reparam.LocScaleReparam(0)})
SIGMA_T = torch.from_numpy(SIGMA)


@pytest.fixture(scope="module")
def jax_posterior():
    """JAX's posterior samples of the non-centred 8-schools, 2 chains x 300."""
    mcmc = jinfer.MCMC(jinfer.NUTS(JMODEL), num_warmup=200, num_samples=300, num_chains=2,
                       progress_bar=False)
    mcmc.run(random.PRNGKey(0), Y, SIGMA)
    return {k: np.asarray(v) for k, v in mcmc.get_samples().items()}


def assert_moments_agree(got, want, axis=0):
    """Means and stds along ``axis`` within 4 Monte-Carlo standard errors of
    two independent samples of ``n`` draws each (the std's error for a
    normal law, sd / sqrt(2n))."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n_got, n_want = got.shape[axis], want.shape[axis]
    sd = np.maximum(got.std(axis), want.std(axis))
    mean_se = sd * np.sqrt(1 / n_got + 1 / n_want)
    std_se = sd * np.sqrt(1 / (2 * n_got) + 1 / (2 * n_want))
    assert (np.abs(got.mean(axis) - want.mean(axis)) < 4 * mean_se).all()
    assert (np.abs(got.std(axis) - want.std(axis)) < 4 * std_se).all()


def test_log_likelihood_matches_jax_on_jax_samples(jax_posterior):
    want = jinfer.log_likelihood(JMODEL, jax_posterior, Y, SIGMA)
    samples = samples_from_numpy(jax_posterior)
    got = log_likelihood(TMODEL, samples, torch.from_numpy(Y), SIGMA_T)
    assert set(got) == set(want) == {"obs"}
    assert got["obs"].shape == (600, 8)
    np.testing.assert_allclose(got["obs"].numpy(), want["obs"], rtol=RTOL)
    ref = dist.Normal(samples["theta"], SIGMA_T).log_prob(torch.from_numpy(Y))
    np.testing.assert_allclose(got["obs"].numpy(), ref.numpy(), rtol=RTOL)
    # grouped by chain: two batch axes
    grouped = {k: v.reshape((2, 300) + v.shape[1:]) for k, v in samples.items()}
    by_chain = log_likelihood(TMODEL, grouped, torch.from_numpy(Y), SIGMA_T, batch_ndims=2,
                              parallel=True)
    torch.testing.assert_close(by_chain["obs"].reshape(600, 8), got["obs"])


@pytest.mark.parametrize("exclude_deterministic", [True, False])
def test_predictive_matches_jax_on_jax_samples(jax_posterior, exclude_deterministic):
    want = jinfer.Predictive(JMODEL, jax_posterior,
                             exclude_deterministic=exclude_deterministic)(
        random.PRNGKey(1), None, SIGMA)
    got = Predictive(TMODEL, samples_from_numpy(jax_posterior), device="cpu",
                     exclude_deterministic=exclude_deterministic)(0, None, SIGMA_T)
    assert set(got) == set(want) == {"theta", "obs"}
    assert got["obs"].shape == (600, 8) and got["obs"].device.type == "cpu"
    # the deterministic site is recomputed from the samples: exact
    np.testing.assert_allclose(got["theta"].numpy(), want["theta"], rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got["theta"].numpy(), jax_posterior["theta"], rtol=RTOL,
                               atol=1e-5)
    # the observations: theta + sigma * N(0, 1), by moments of the residual
    resid_got = (got["obs"].numpy() - jax_posterior["theta"]) / SIGMA
    resid_want = (np.asarray(want["obs"]) - jax_posterior["theta"]) / SIGMA
    assert_moments_agree(resid_got, resid_want)
    assert_moments_agree(resid_got, np.random.default_rng(0).standard_normal((600, 8)))


def test_return_sites_and_parallel(jax_posterior):
    samples = samples_from_numpy(jax_posterior)
    pred = Predictive(TMODEL, samples, return_sites=["mu", "obs", "theta_decentered"],
                      parallel=True, device="cpu")
    got = pred(1, None, SIGMA_T)
    assert set(got) == {"mu", "obs", "theta_decentered"}
    # a site given by the samples comes back as given
    torch.testing.assert_close(got["mu"], samples["mu"], rtol=0, atol=0)
    want = jinfer.Predictive(JMODEL, jax_posterior, return_sites=["mu", "obs"])(
        random.PRNGKey(2), None, SIGMA)
    assert_moments_agree((got["obs"].numpy() - jax_posterior["theta"]) / SIGMA,
                         (np.asarray(want["obs"]) - jax_posterior["theta"]) / SIGMA)


def test_prior_predictive_draws_every_site():
    got = Predictive(TMODEL, num_samples=4000, device="cpu")(3, None, SIGMA_T)
    want = jinfer.Predictive(JMODEL, num_samples=4000)(random.PRNGKey(3), None, SIGMA)
    assert set(got) == set(want) == {"mu", "tau", "theta_decentered", "theta", "obs"}
    for k in ("mu", "theta_decentered"):
        assert got[k].shape == tuple(want[k].shape)
        assert_moments_agree(got[k].numpy(), want[k])
    # HalfCauchy has no moments: compare its median and quartiles
    q = [0.25, 0.5, 0.75]
    np.testing.assert_allclose(np.quantile(got["tau"].numpy(), q), np.quantile(want["tau"], q),
                               rtol=0.1)


@pytest.fixture(scope="module")
def jax_guide_params():
    """JAX's AutoNormal on the non-centred model after 300 Adam steps."""
    guide = jautoguide.AutoNormal(JMODEL)
    svi = jinfer.SVI(JMODEL, guide, joptim.Adam(0.05), jinfer.Trace_ELBO())
    res = svi.run(random.PRNGKey(0), 300, Y, SIGMA, progress_bar=False)
    return guide, {k: np.asarray(v) for k, v in res.params.items()}


def port_guide():
    """The port's AutoNormal, set up by ``SVI.init`` as after a fit."""
    guide = autoguide.AutoNormal(TMODEL)
    SVI(TMODEL, guide, Adam(0.05), Trace_ELBO(), device="cpu").init(
        0, torch.from_numpy(Y), SIGMA_T)
    return guide


SITES = ["mu", "tau", "theta_decentered", "theta", "obs"]


def test_guide_predictive_matches_jax_on_jax_params(jax_guide_params):
    jguide, jparams = jax_guide_params
    tguide, tparams = port_guide(), samples_from_numpy(jparams)
    # by default the guide's draws stand in for posterior samples
    plain = Predictive(TMODEL, guide=tguide, params=tparams, num_samples=5, device="cpu")(
        4, None, SIGMA_T)
    assert set(plain) == set(jinfer.Predictive(JMODEL, guide=jguide, params=jparams,
                                               num_samples=5)(random.PRNGKey(4), None, SIGMA))
    want = jinfer.Predictive(JMODEL, guide=jguide, params=jparams, num_samples=2000,
                             return_sites=SITES)(random.PRNGKey(4), None, SIGMA)
    got = Predictive(TMODEL, guide=tguide, params=tparams, num_samples=2000,
                     return_sites=SITES, device="cpu")(4, None, SIGMA_T)
    assert set(got) == set(want) == set(SITES)
    for k in ("mu", "theta_decentered", "obs"):
        assert got[k].shape == tuple(want[k].shape) == (2000,) + np.shape(want[k])[1:]
        assert_moments_agree(got[k].numpy(), want[k])
    # the guide's draw of mu is Normal(loc, scale)
    loc, scale = jparams["auto_mu_loc"], jparams["auto_mu_scale"]
    assert_moments_agree(got["mu"].numpy(), loc + scale * np.random.default_rng(1)
                         .standard_normal(2000))
    # theta is the model's deterministic function of the guide's draws
    theta = got["mu"][:, None] + got["tau"][:, None] * got["theta_decentered"]
    torch.testing.assert_close(got["theta"], theta, rtol=RTOL, atol=1e-5)


def test_guide_predictive_over_a_batch_of_params(jax_guide_params):
    """``batch_ndims=1``: a leading axis of three param sets, mapped with
    ``vmap``; the draws come out on axis 1 as in the JAX package."""
    jguide, jparams = jax_guide_params
    batched = {k: np.stack([v, v, v]) for k, v in jparams.items()}
    batched["auto_mu_loc"] = jparams["auto_mu_loc"] + np.array([-5.0, 0.0, 5.0], np.float32)
    want = jinfer.Predictive(JMODEL, guide=jguide, params=batched, num_samples=500,
                             batch_ndims=1, return_sites=SITES)(random.PRNGKey(5), None, SIGMA)
    got = Predictive(TMODEL, guide=port_guide(), params=samples_from_numpy(batched),
                     num_samples=500, batch_ndims=1, return_sites=SITES, device="cpu")(
        5, None, SIGMA_T)
    assert got["obs"].shape == tuple(want["obs"].shape) == (500, 3, 8)
    for i in range(3):
        assert_moments_agree(got["mu"][:, i].numpy(), want["mu"][:, i])
    # each param set draws its own values
    assert not torch.equal(got["theta_decentered"][:, 0], got["theta_decentered"][:, 1])


@pytest.mark.parametrize("batch_shape,chunk_size", [((10,), 4), ((10,), 3), ((2, 5), 4),
                                                   ((7,), None), ((1,), 2)])
def test_soft_vmap_matches_jax(batch_shape, chunk_size):
    """Chunks that do not divide the batch are padded and cut; the result
    gets the batch shape back (a batch of one is not mapped)."""
    rng = np.random.default_rng(0)
    xs = {"a": rng.standard_normal(batch_shape + (3,)).astype(np.float32),
          "b": rng.standard_normal(batch_shape).astype(np.float32)}

    def fn_j(x):
        return {"s": jnp.sum(x["a"], -1) * x["b"], "v": x["a"] * 2.0}

    def fn_t(x):
        return {"s": x["a"].sum(-1) * x["b"], "v": x["a"] * 2.0}

    want = jax_util.soft_vmap(fn_j, xs, len(batch_shape), chunk_size)
    got = soft_vmap(fn_t, samples_from_numpy(xs), len(batch_shape), chunk_size)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6)


def test_soft_vmap_replays_a_model_in_chunks_with_different_draws(jax_posterior):
    """A replay of the model in chunks of 7 over 600 samples: the same
    log-likelihood as one ``vmap``, and fresh draws per element from one
    generator."""
    samples = samples_from_numpy(jax_posterior)
    gen = torch.Generator().manual_seed(0)

    def one(s):
        tr = handlers.trace(handlers.seed(handlers.substitute(TMODEL, s), gen)).get_trace(
            None, SIGMA_T)
        return {"theta": tr["theta"]["value"], "obs": tr["obs"]["value"]}

    chunked = soft_vmap(one, samples, 1, 7)
    assert chunked["obs"].shape == (600, 8)
    torch.testing.assert_close(chunked["theta"], samples["theta"], rtol=RTOL, atol=1e-5)
    resid = ((chunked["obs"] - samples["theta"]) / SIGMA_T).numpy()
    assert len(np.unique(resid[:, 0])) == 600
    assert_moments_agree(resid, np.random.default_rng(2).standard_normal((600, 8)))


def test_predictive_defaults_to_cuda_and_unported_options_raise():
    pred = Predictive(TMODEL, num_samples=3)
    assert pred.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pred(0, None, SIGMA_T)
    # infer_discrete is ported: a model without discrete sites draws as without it
    drawn = Predictive(TMODEL, num_samples=3, infer_discrete=True, device="cpu")(0, None, SIGMA_T)
    assert drawn["obs"].shape == (3, 8) and torch.isfinite(drawn["obs"]).all()
    with pytest.raises(ValueError, match="num_samples"):
        Predictive(TMODEL)
    with pytest.raises(ValueError, match="Batch shapes"):
        Predictive(TMODEL, {"mu": torch.zeros(3), "tau": torch.ones(4)})
    with pytest.warns(UserWarning, match="Defaulting to 3"):
        Predictive(TMODEL, {"mu": torch.zeros(3)}, num_samples=5, device="cpu")


def test_samples_from_numpy_keeps_dtypes_and_groups():
    s = samples_from_numpy({"a": np.zeros((2, 3), np.float32), "i": np.arange(4, dtype=np.int32),
                            "j": jnp.ones((2,), jnp.float32)})
    assert s["a"].dtype == torch.float32 and s["i"].dtype == torch.int32
    assert s["a"].shape == (2, 3) and s["j"].dtype == torch.float32
    # writable copies: the port may update them in place
    s["a"].add_(1.0)
    assert jax.device_get(jnp.ones(1))[0] == 1.0


def _nested_plates(module, dist_mod, y):
    module.sample("a", dist_mod.Normal(0.0, 1.0))
    with module.plate("outer", 3, dim=-2):
        with module.plate("inner", 2):
            module.sample("b", dist_mod.Normal(0.0, 1.0), obs=y)


@pytest.mark.parametrize("model", ["eight_schools", "nested", "no_plate"])
def test_guess_max_plate_nesting_matches_jax(model):
    from numpyro_tpu.infer.util import _guess_max_plate_nesting as jax_guess
    from numpyro_tpu_torch.infer.util import _guess_max_plate_nesting

    y = np.zeros((3, 2), np.float32)
    jax_fn, torch_fn, jargs, targs = {
        "eight_schools": (JMODEL, TMODEL, (Y, SIGMA), (torch.from_numpy(Y), SIGMA_T)),
        "nested": (lambda y: _nested_plates(numpyro_tpu, jdist, y),
                   lambda y: _nested_plates(npt, dist, y), (y,), (torch.from_numpy(y),)),
        "no_plate": (lambda: numpyro_tpu.sample("a", jdist.Normal(0.0, 1.0)),
                     lambda: npt.sample("a", dist.Normal(0.0, 1.0)), (), ()),
    }[model]
    want = jax_guess(jhandlers.trace(jhandlers.seed(jax_fn, 0)).get_trace(*jargs))
    got = _guess_max_plate_nesting(
        handlers.trace(handlers.seed(torch_fn, torch.Generator())).get_trace(*targs))
    assert got == want == {"eight_schools": 1, "nested": 2, "no_plate": 0}[model]
