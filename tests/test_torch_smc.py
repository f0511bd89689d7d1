"""``SMC`` of the port against the JAX package's: systematic resampling, the
temperature bisection, one rejuvenation, the initial cloud and one whole
stage exactly on JAX's draws (rtol 1e-6 in f32, beside the atol given at each
comparison); whole runs under ``tests/infer/test_smc.py``'s gates;
8-schools against JAX's SMC; and the raise on a discrete latent site, where
the JAX package's posterior is wrong."""

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.infer import SMC as JSMC
from numpyro_tpu.infer.initialization import init_to_sample as jinit_to_sample
from numpyro_tpu.infer.reparam import LocScaleReparam as JLocScaleReparam
from numpyro_tpu.infer.smc import _systematic_resample as j_systematic_resample
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.infer import SMC, SMCResult
from numpyro_tpu_torch.infer.reparam import LocScaleReparam
from numpyro_tpu_torch.infer.smc import SMCState, _systematic_resample, smc_state_from_numpy

from test_torch_kernels import QueueDraws

torch.set_num_threads(1)

RTOL = 1e-6
# log densities are f32 sums of per-site terms that the two packages add in
# another order: up to a few ulps of the largest term, 1e-5 relative
LP_RTOL = 1e-5
Y = np.array([0.5, 1.5, 1.0, 0.8, 1.2], np.float32)


def jax_gauss(y):
    mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, 1.0))
    with numpyro_tpu.plate("N", y.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(mu, 1.0), obs=y)


def torch_gauss(y):
    mu = npt.sample("mu", dist.Normal(0.0, 1.0))
    with npt.plate("N", y.shape[0]):
        npt.sample("y", dist.Normal(mu, 1.0), obs=y)


def jax_scale(y):
    s = numpyro_tpu.sample("s", jdist.HalfNormal(2.0))
    loc = numpyro_tpu.sample("loc", jdist.Normal(0.0, 1.0).expand([2]).to_event(1))
    with numpyro_tpu.plate("N", y.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(loc[0] + loc[1], s), obs=y)
    numpyro_tpu.factor("pull", -0.5 * loc[1] ** 2)


def torch_scale(y):
    s = npt.sample("s", dist.HalfNormal(2.0))
    loc = npt.sample("loc", dist.Normal(0.0, 1.0).expand([2]).to_event(1))
    with npt.plate("N", y.shape[0]):
        npt.sample("y", dist.Normal(loc[0] + loc[1], s), obs=y)
    npt.factor("pull", -0.5 * loc[1] ** 2)


def _close(a, b, atol=0.0, msg="", rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def test_systematic_resample_matches_jax():
    rng = np.random.default_rng(0)
    lw = (3 * rng.standard_normal(500)).astype(np.float32)
    for seed in range(4):
        key = random.PRNGKey(seed)
        want = np.asarray(j_systematic_resample(key, jnp.asarray(lw)))
        draws = QueueDraws([("uniforms", random.uniform(key))])
        got = _systematic_resample(draws, torch.from_numpy(lw)).numpy()
        np.testing.assert_array_equal(got, want)


def _pair(p=600, steps=3):
    """A JAX and a port SMC set up on the same model and data."""
    j = JSMC(jax_scale, num_particles=p, num_mcmc_steps=steps)
    t = SMC(torch_scale, num_particles=p, num_mcmc_steps=steps, device="cpu")
    j._setup(random.PRNGKey(0), jnp.asarray(Y))
    t._setup(torch.Generator().manual_seed(0), (torch.from_numpy(Y),), {})
    return j, t


def _jax_prior_values(j, key, p):
    """JAX's initial cloud as constrained site values (``smc.py``
    ``_init_particles``, with the values before the inverse transforms)."""

    def draw(k):
        with jhandlers.block(), jhandlers.trace() as tr:
            jhandlers.substitute(jhandlers.seed(jax_scale, k), substitute_fn=jinit_to_sample())(
                jnp.asarray(Y))
        return {name: tr[name]["value"] for name in ("loc", "s")}

    return jax.vmap(draw)(random.split(key, p))


def test_initial_cloud_and_split_log_probs_match_jax():
    j, t = _pair()
    key = random.PRNGKey(1)
    want = np.asarray(j._init_particles(key, jnp.asarray(Y)))
    values = {k: torch.from_numpy(np.array(v)) for k, v in _jax_prior_values(j, key, 600).items()}

    class PriorDraws(QueueDraws):
        def prior(self, draw_fn, num):
            assert num == 600
            return values

    got = t._init_particles(PriorDraws(), (torch.from_numpy(Y),), {})
    _close(got, want, 1e-6, "particles")
    lp_j = jax.jit(jax.vmap(j._split_log_probs))(jnp.asarray(want))
    lp_t = t._split_log_probs(torch.from_numpy(want))
    for a, b, name in zip(lp_t, lp_j, ("prior", "likelihood")):
        _close(a, b, 1e-4, name, rtol=LP_RTOL)


def test_next_beta_matches_jax():
    j, t = _pair()
    rng = np.random.default_rng(2)
    for beta, scale in ((0.0, 30.0), (0.13, 8.0), (0.5, 0.3)):
        log_lik = (scale * rng.standard_normal(600) - 5).astype(np.float32)
        want = j._next_beta(beta, jnp.asarray(log_lik))
        got = t._next_beta(beta, torch.from_numpy(log_lik))
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=RTOL)


def _rejuvenate_draws(key, steps, p, d):
    """JAX's draws of ``_rejuvenate`` (``smc.py``: one key per step, split in
    a proposal and an accept key)."""
    items = []
    for k in random.split(key, steps):
        key_prop, key_acc = random.split(k)
        items += [("normals", random.normal(key_prop, (p, d))),
                  ("uniforms", random.uniform(key_acc, (p,)))]
    return items


def test_one_rejuvenation_matches_jax():
    j, t = _pair()
    particles = np.asarray(j._init_particles(random.PRNGKey(3), jnp.asarray(Y)))
    key = random.PRNGKey(4)
    want_p, want_ll = j._rejuvenate(key, jnp.asarray(particles), 0.3)
    draws = QueueDraws(_rejuvenate_draws(key, 3, 600, 3))
    got_p, got_ll = t._rejuvenate(draws, torch.from_numpy(particles), 0.3)
    assert not draws.items
    _close(got_p, want_p, 1e-6, "particles")
    _close(got_ll, want_ll, 1e-4, "log_lik", rtol=LP_RTOL)
    assert 0.05 < float(np.mean(np.any(np.asarray(want_p) != particles, axis=1))) < 1


def test_one_whole_stage_from_a_jax_state_matches_jax():
    """A stage from JAX's state after one tempering stage (reweighted, not
    resampled) and its own inline stage (``smc.py`` ``run``), on its draws."""
    j, t = _pair()
    res = JSMC(jax_scale, num_particles=600, num_mcmc_steps=3, max_stages=1).run(
        random.PRNGKey(5), jnp.asarray(Y))
    state = smc_state_from_numpy(jax.tree.map(np.asarray, res.state._asdict()))
    assert isinstance(state, SMCState) and state.beta == res.betas[-1] < 1
    jp = jnp.asarray(state.particles.numpy())
    _, log_lik = jax.vmap(j._split_log_probs)(jp)
    key = random.PRNGKey(6)
    _, key_resample, key_mcmc = random.split(key, 3)
    # the JAX stage (smc.py run, steps 1-4)
    lw = jnp.asarray(state.log_weights.numpy())
    beta_new = j._next_beta(state.beta, log_lik)
    incr = (beta_new - state.beta) * log_lik
    ev = state.log_evidence.numpy() + (jax.scipy.special.logsumexp(lw + incr)
                                       - jax.scipy.special.logsumexp(lw))
    lw = lw + incr
    ess = jnp.exp(2 * jax.scipy.special.logsumexp(lw) - jax.scipy.special.logsumexp(2 * lw))
    resample = ess < 0.5 * 600
    idx = j_systematic_resample(key_resample, lw)
    jp = jnp.where(resample, jp[idx], jp)
    lw = jnp.where(resample, jnp.zeros_like(lw), lw)
    jp, jll = j._rejuvenate(key_mcmc, jp, beta_new)

    draws = QueueDraws([("uniforms", random.uniform(key_resample))]
                       + _rejuvenate_draws(key_mcmc, 3, 600, 3))
    t_ll = t._split_log_probs(state.particles)[1]
    p_t, lw_t, ll_t, ev_t, beta_t = t._stage(draws, state.particles, state.log_weights, t_ll,
                                             state.beta, state.log_evidence)
    assert not draws.items
    np.testing.assert_allclose(beta_t, beta_new, rtol=RTOL)
    _close(p_t, jp, 1e-5, "particles")
    _close(lw_t, lw, 1e-4, "log_weights")
    _close(ll_t, jll, 1e-4, "log_lik", rtol=LP_RTOL)
    _close(ev_t, ev, 1e-4, "log_evidence")


def test_smc_conjugate_gaussian_evidence():
    """``tests/infer/test_smc.py``'s case and gates."""
    y = torch.from_numpy(Y)
    res = SMC(torch_gauss, num_particles=2000, num_mcmc_steps=10, device="cpu").run(0, y)
    assert isinstance(res, SMCResult) and res.samples["mu"].shape == (2000,)
    mu = res.samples["mu"].numpy()
    assert abs(mu.mean() - Y.sum() / 6) < 0.05
    assert abs(mu.std() - (1 / 6) ** 0.5) < 0.07
    n = len(Y)
    exact = st.multivariate_normal(np.zeros(n), np.eye(n) + np.ones((n, n))).logpdf(Y)
    assert abs(res.log_evidence - exact) < 0.2
    assert res.betas[0] == 0.0 and res.betas[-1] == 1.0
    assert res.state.step == len(res.betas)


def test_smc_constrained_support():
    def model(y):
        s = npt.sample("s", dist.HalfNormal(2.0))
        with npt.plate("N", y.shape[0]):
            npt.sample("y", dist.Normal(0.0, s), obs=y)

    res = SMC(model, num_particles=1000, num_mcmc_steps=8, device="cpu").run(
        torch.Generator().manual_seed(1), torch.from_numpy(Y))
    s = res.samples["s"].numpy()
    assert (s > 0).all()
    assert 0.5 < s.mean() < 2.0


ES_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
ES_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)


def jax_schools(y, sigma):
    mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, 5.0))
    tau = numpyro_tpu.sample("tau", jdist.HalfCauchy(5.0))
    with numpyro_tpu.plate("J", 8):
        theta = numpyro_tpu.sample("theta", jdist.Normal(mu, tau))
        numpyro_tpu.sample("obs", jdist.Normal(theta, sigma), obs=y)


def torch_schools(y, sigma):
    mu = npt.sample("mu", dist.Normal(0.0, 5.0))
    tau = npt.sample("tau", dist.HalfCauchy(5.0))
    with npt.plate("J", 8):
        theta = npt.sample("theta", dist.Normal(mu, tau))
        npt.sample("obs", dist.Normal(theta, sigma), obs=y)


def test_eight_schools_matches_jax_smc():
    """Non-centred 8-schools, 2,048 particles, the defaults otherwise: the
    posterior means of ``mu`` and ``tau`` and the log evidence of the port's
    run against JAX's, within 4 standard errors of the difference of two
    runs' means (from the particles' spread, an effective size of a fifth of
    the particles for a resampled, rejuvenated cloud) and 0.3 nats."""
    jm = jhandlers.reparam(jax_schools, config={"theta": JLocScaleReparam(0)})
    tm = handlers.reparam(torch_schools, config={"theta": LocScaleReparam(0)})
    p = 2048
    rj = JSMC(jm, num_particles=p).run(random.PRNGKey(0), jnp.asarray(ES_Y), jnp.asarray(ES_SIGMA))
    rt = SMC(tm, num_particles=p, device="cpu").run(0, torch.tensor(ES_Y), torch.tensor(ES_SIGMA))
    assert sorted(rt.samples) == ["mu", "tau", "theta_decentered"]  # no deterministic theta
    for site in ("mu", "tau"):
        a, b = rt.samples[site].numpy(), np.asarray(rj.samples[site])
        se = np.sqrt((a.var() + b.var()) / (p / 5))
        assert abs(a.mean() - b.mean()) < 4 * se, (site, a.mean(), b.mean(), se)
    assert abs(rt.log_evidence - rj.log_evidence) < 0.3
    assert 2 <= len(rt.betas) - 1 <= 4


PROBS = np.array([0.15, 0.3, 0.3, 0.25], np.float32)
LOCS = np.array([-1.0, 0.0, 1.0, 2.0], np.float32)


def _exact_mixture_posterior(y=0.7):
    """Mean and std of x | y by quadrature: c ~ Categorical(PROBS), x ~
    N(LOCS[c], 0.5), y ~ N(x, 1)."""
    xs = np.linspace(-8, 9, 200001)
    prior = sum(p * st.norm.pdf(xs, m, 0.5) for p, m in zip(PROBS, LOCS))
    post = prior * st.norm.pdf(y, xs, 1.0)
    post /= np.trapezoid(post, xs)
    mean = np.trapezoid(xs * post, xs)
    return mean, np.sqrt(np.trapezoid((xs - mean) ** 2 * post, xs))


def test_discrete_latent_site_raises_where_jax_is_wrong():
    """The port raises; the JAX package redraws ``c`` with one fixed key for
    every particle, so its posterior mean of ``x`` is off the exact one by
    more than 0.5 (0.699 by quadrature)."""

    def jax_model(y):
        c = numpyro_tpu.sample("c", jdist.Categorical(jnp.asarray(PROBS)))
        x = numpyro_tpu.sample("x", jdist.Normal(jnp.asarray(LOCS)[c], 0.5))
        numpyro_tpu.sample("y", jdist.Normal(x, 1.0), obs=y)

    def torch_model(y):
        c = npt.sample("c", dist.Categorical(torch.from_numpy(PROBS)))
        x = npt.sample("x", dist.Normal(torch.from_numpy(LOCS)[c], 0.5))
        npt.sample("y", dist.Normal(x, 1.0), obs=y)

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SMC(torch_model, num_particles=100, device="cpu").run(0, torch.tensor(0.7))
    mean, sd = _exact_mixture_posterior()
    assert abs(mean - 0.699) < 1e-3 and abs(sd - 0.806) < 1e-3
    res = JSMC(jax_model, num_particles=2000, num_mcmc_steps=10).run(random.PRNGKey(0),
                                                                      jnp.asarray(0.7))
    assert "c" not in res.samples
    assert abs(float(np.mean(res.samples["x"])) - mean) > 0.5


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the fault on a machine without CUDA")
def test_default_device_is_cuda_and_never_falls_back_to_the_cpu():
    smc = SMC(torch_gauss, num_particles=10)
    assert smc.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        smc.run(0, torch.from_numpy(Y))
    with pytest.raises(ValueError, match="lives on cpu and the run on cuda"):
        smc.run(torch.Generator().manual_seed(0), torch.from_numpy(Y))
