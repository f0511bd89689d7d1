"""Stochastic volatility in the port against the JAX package: ``Exponential``,
``StudentT`` and ``GaussianRandomWalk`` (``log_prob`` over a seeded grid to
1e-5 relative in f32, draws by moments and by their distribution function),
the model of ``examples/stochastic_volatility.py`` (its potential and
gradient at JAX's points), and one short whole run of it, compared with the
JAX package's run by moments within 4 Monte-Carlo standard errors (each
from the run's ESS)."""

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
from numpyro_tpu.diagnostics import effective_sample_size
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.infer import MCMC, NUTS
from numpyro_tpu_torch.infer import util

torch.set_num_threads(1)

RTOL = 1e-5
N_DRAWS = 20_000
# the 1% critical value of the two-sided Kolmogorov-Smirnov statistic
KS_1PC = 1.63 / np.sqrt(N_DRAWS)


def returns(T, seed=0):
    """``examples/stochastic_volatility.py:28-29`` in numpy: returns with a
    random-walk log volatility; also that log volatility."""
    rng = np.random.default_rng(seed)
    log_vol = 0.1 * np.cumsum(rng.standard_normal(T)) * 0.3 - 2
    r = np.exp(log_vol) * rng.standard_normal(T)
    return r.astype(np.float32), log_vol


def jax_sv(returns):
    T = returns.shape[0]
    sigma = numpyro_tpu.sample("sigma", jdist.Exponential(50.0))
    nu = numpyro_tpu.sample("nu", jdist.Exponential(0.1))
    s = numpyro_tpu.sample("s", jdist.GaussianRandomWalk(scale=sigma, num_steps=T))
    numpyro_tpu.sample("r", jdist.StudentT(df=nu, loc=0.0, scale=jnp.exp(s)), obs=returns)


def torch_sv(returns):
    T = returns.shape[0]
    sigma = npt.sample("sigma", dist.Exponential(50.0))
    nu = npt.sample("nu", dist.Exponential(0.1))
    s = npt.sample("s", dist.GaussianRandomWalk(scale=sigma, num_steps=T))
    npt.sample("r", dist.StudentT(df=nu, loc=0.0, scale=torch.exp(s)), obs=returns)


# ---------------------------------------------------------------------------
# the distributions

DF = np.array([0.05, 0.3, 1.0, 2.5, 7.0, 40.0, 3e3], np.float32)
Z = np.array([-1e4, -250.0, -3.0, -0.1, 0.0, 0.7, 12.0, 2e3], np.float32)


def _both(name, *args):
    return (getattr(dist, name)(*(torch.from_numpy(np.asarray(a)) for a in args)),
            getattr(jdist, name)(*(jnp.asarray(a) for a in args)))


def test_student_t_log_prob_matches_jax_for_small_df_and_large_z():
    df, z = np.meshgrid(DF, Z, indexing="ij")
    loc = np.float32(0.4)
    scale = np.linspace(0.2, 3.0, z.size, dtype=np.float32).reshape(z.shape)
    x = (loc + scale * z).astype(np.float32)
    t, j = _both("StudentT", df, loc, scale)
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(x))), rtol=RTOL)
    np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()), rtol=RTOL, atol=1e-6)
    for moment in ("mean", "variance"):
        np.testing.assert_allclose(getattr(t, moment).numpy(), np.asarray(getattr(j, moment)),
                                   rtol=RTOL)
    # cdf goes through the port's betainc; icdf raises, as in the JAX package.
    # At df = 3e3, df / (df + z^2) rounds in float32 to within 1e-6 of 1,
    # where betainc(df / 2, 1 / 2, .) is steep: both packages lose digits
    # there (JAX 8e-4 relative to scipy in float64, the port 6e-5), so that
    # row is held to scipy at 1e-4
    cdf_t = t.cdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(cdf_t[:-1], np.asarray(j.cdf(jnp.asarray(x)))[:-1], rtol=RTOL,
                               atol=1e-6)
    exact = scipy.stats.t.cdf((x[-1].astype(np.float64) - loc) / scale[-1], DF[-1])
    np.testing.assert_allclose(cdf_t[-1], exact, rtol=1e-4, atol=1e-6)
    with pytest.raises(NotImplementedError):
        t.icdf(torch.zeros(()))


def test_exponential_matches_jax():
    rate = np.array([1e-3, 0.1, 1.0, 50.0, 3e3], np.float32)
    x = np.array([[0.0], [1e-4], [0.02], [1.0], [300.0]], np.float32)
    t, j = _both("Exponential", rate)
    assert t.support is dist.constraints.positive
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(x))), rtol=RTOL)
    np.testing.assert_allclose(t.cdf(torch.from_numpy(x)).numpy(),
                               np.asarray(j.cdf(jnp.asarray(x))), rtol=RTOL, atol=1e-7)
    q = np.array([[1e-6], [0.1], [0.5], [0.99]], np.float32)
    np.testing.assert_allclose(t.icdf(torch.from_numpy(q)).numpy(),
                               np.asarray(j.icdf(jnp.asarray(q))), rtol=RTOL)
    for moment in ("mean", "variance"):
        np.testing.assert_allclose(getattr(t, moment).numpy(), np.asarray(getattr(j, moment)),
                                   rtol=RTOL)
    np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()), rtol=RTOL)


@pytest.mark.parametrize("scale_shape", [(), (3,)])
def test_gaussian_random_walk_matches_jax(scale_shape):
    rng = np.random.default_rng(0)
    scale = np.asarray(np.exp(rng.standard_normal(scale_shape)), np.float32)
    x = rng.standard_normal((4,) + scale_shape + (50,)).cumsum(-1).astype(np.float32) * 3
    t = dist.GaussianRandomWalk(torch.from_numpy(scale), num_steps=50)
    j = jdist.GaussianRandomWalk(jnp.asarray(scale), num_steps=50)
    assert t.batch_shape == j.batch_shape and t.event_shape == j.event_shape == (50,)
    assert t.support is dist.constraints.real_vector
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(x))), rtol=RTOL)
    np.testing.assert_allclose(t.variance.numpy(), np.asarray(j.variance), rtol=RTOL)
    assert t.mean.shape == scale_shape + (50,)
    with pytest.raises(AssertionError):
        dist.GaussianRandomWalk(1.0, num_steps=0)


def _ks(draws, cdf):
    x = np.sort(np.asarray(draws, np.float64))
    n = len(x)
    f = cdf(x)
    return max((np.arange(1, n + 1) / n - f).max(), (f - np.arange(n) / n).max())


@pytest.mark.parametrize("df", [0.7, 5.0])
def test_student_t_draws_follow_the_law(df):
    g = torch.Generator().manual_seed(0)
    x = dist.StudentT(torch.tensor(df), 1.0, 2.0).sample(g, (N_DRAWS,))
    assert torch.isfinite(x).all()
    assert _ks(x.numpy(), lambda v: scipy.stats.t.cdf(v, df, 1.0, 2.0)) < KS_1PC
    jx = jdist.StudentT(df, 1.0, 2.0).sample(random.PRNGKey(0), (N_DRAWS,))
    assert _ks(jx, lambda v: scipy.stats.t.cdf(v, df, 1.0, 2.0)) < KS_1PC


def test_exponential_and_walk_draws_follow_their_laws():
    g = torch.Generator().manual_seed(1)
    x = dist.Exponential(torch.tensor(2.0)).sample(g, (N_DRAWS,))
    assert (x >= 0).all()
    assert _ks(x.numpy(), lambda v: scipy.stats.expon.cdf(v, scale=0.5)) < KS_1PC
    w = dist.GaussianRandomWalk(torch.tensor(0.5), num_steps=10).sample(g, (N_DRAWS,))
    steps = torch.diff(w, dim=-1, prepend=torch.zeros_like(w[..., :1])).numpy()
    for k in (0, 9):
        assert _ks(steps[:, k], lambda v: scipy.stats.norm.cdf(v, 0.0, 0.5)) < KS_1PC
    # var(w_T) = T scale^2, within 4 standard errors of a normal variance
    var = w[:, -1].var().item()
    assert abs(var - 2.5) < 4 * 2.5 * np.sqrt(2 / N_DRAWS)


def test_draws_under_vmap_differ_per_element():
    """Every sampler takes the generator and draws anew for each element
    under ``vmap(randomness="different")``, the gamma draw of ``StudentT``
    included."""
    g = torch.Generator().manual_seed(2)

    def one(df):
        return {
            "t": dist.StudentT(df, 0.0, 1.0).sample(g),
            "e": dist.Exponential(df).sample(g),
            "w": dist.GaussianRandomWalk(df, num_steps=3).sample(g),
        }

    out = torch.func.vmap(one, randomness="different")(torch.full((64,), 3.0))
    for k, v in out.items():
        assert torch.isfinite(v).all() and len(torch.unique(v.reshape(64, -1)[:, 0])) == 64, k


# ---------------------------------------------------------------------------
# the model

def test_sv_potential_and_gradient_match_jax():
    """The potential against JAX's in f32; the gradient against JAX's in
    float64 (``jax.enable_x64``): in f32 the JAX package's ``betaln``
    gradient in ``df`` (a difference of digammas) is off the float64 value
    by up to 2.5e-5 relative at these points, where the port computes
    ``betaln`` in float64 and stays within 1e-5 (ROADMAP.md, Queue 3)."""
    r, _ = returns(100)
    t_args = (torch.from_numpy(r),)
    keys = random.split(random.PRNGKey(7), 3)
    for i in range(3):
        u = {"sigma": random.normal(keys[i], ()) - 3.0,
             "nu": random.normal(random.fold_in(keys[i], 1), ()) + 2.0,
             "s": random.normal(random.fold_in(keys[i], 2), (100,)) * 0.3 - 2.0}
        jpe = jutil.potential_energy(jax_sv, (jnp.asarray(r),), {}, u)
        with jax.enable_x64():
            jg = jax.grad(lambda p: jutil.potential_energy(
                jax_sv, (jnp.asarray(r, jnp.float64),), {}, p))(
                {k: jnp.asarray(v, jnp.float64) for k, v in u.items()})
        tg, tpe = torch.func.grad_and_value(
            lambda p: util.potential_energy(torch_sv, t_args, {}, p))(util.samples_from_numpy(u))
        np.testing.assert_allclose(tpe.item(), float(jpe), rtol=RTOL)
        for k in jg:
            g = np.asarray(jg[k])
            np.testing.assert_allclose(tg[k].numpy(), g, rtol=RTOL,
                                       atol=RTOL * np.abs(g).max(), err_msg=k)


# ---------------------------------------------------------------------------
# whole runs against the JAX package's

def mc_agree(got, want):
    """Posterior means per coordinate within 4 Monte-Carlo standard errors,
    each run's from its own ESS; draws are ``(chains, n, ...)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)

    def se(x):
        ess = np.asarray(effective_sample_size(x))
        return x.reshape((-1,) + x.shape[2:]).std(0) / np.sqrt(ess)

    bound = 4 * np.sqrt(se(got) ** 2 + se(want) ** 2)
    gap = np.abs(got.mean((0, 1)) - want.mean((0, 1)))
    assert (gap < bound).all(), (gap, bound)


def test_short_sv_run_matches_jax():
    """T = 20, 4 chains, 70 + 40 at depths (4, 5), pooled adaptation."""
    r, _ = returns(20)
    jm = jinfer.MCMC(jinfer.NUTS(jax_sv, max_tree_depth=(4, 5), pooled_adaptation=True),
                     num_warmup=70, num_samples=40, num_chains=4, progress_bar=False)
    jm.run(random.PRNGKey(0), r)
    tm = MCMC(NUTS(torch_sv, max_tree_depth=(4, 5), pooled_adaptation=True), num_warmup=70,
              num_samples=40, num_chains=4, device="cpu")
    tm.run(0, torch.from_numpy(r))
    jz, tz = jm.get_samples(group_by_chain=True), tm.get_samples(group_by_chain=True)
    assert tz["s"].shape == (4, 40, 20) and torch.isfinite(tz["s"]).all()
    for k in ("s", "sigma", "nu"):
        mc_agree(tz[k].numpy(), jz[k])
