"""The horseshoe regression of ``examples/horseshoe_regression.py`` in the
port against the JAX package: ``Cauchy``, ``HalfCauchy`` and ``HalfNormal``,
the exp and affine transforms and ``biject_to`` onto half-lines, the model's
potential and gradient in reverse and forward mode, and a whole run with a
dense mass matrix.  Tolerances are written at each comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.distributions import constraints as jconstraints
from numpyro_tpu.distributions import transforms as jtransforms
from numpyro_tpu.infer import MCMC as JMCMC, NUTS as JNUTS
from numpyro_tpu.infer import hmc_core as jc
from numpyro_tpu.infer import util as jutil
from numpyro_tpu_torch.distributions import constraints, transforms
from numpyro_tpu_torch.infer import MCMC, NUTS
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util

torch.set_num_threads(1)


def make_data(N, D, active, key=0):
    """``examples/horseshoe_regression.py::make_data``, in numpy."""
    rng = np.random.RandomState(key)
    X = rng.randn(N, D)
    beta = np.zeros(D)
    beta[:active] = rng.randn(active) * 2.0
    y = X @ beta + 0.5 * rng.randn(N)
    return X.astype(np.float32), y.astype(np.float32), beta


def jax_model(X, y):
    D = X.shape[1]
    tau = numpyro_tpu.sample("tau", jdist.HalfCauchy(0.1))
    with numpyro_tpu.plate("D", D):
        lam = numpyro_tpu.sample("lambda", jdist.HalfCauchy(1.0))
    sigma = numpyro_tpu.sample("sigma", jdist.HalfNormal(1.0))
    with numpyro_tpu.plate("D2", D):
        beta = numpyro_tpu.sample("beta", jdist.Normal(0.0, tau * lam))
    with numpyro_tpu.plate("N", X.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(X @ beta, sigma), obs=y)


def torch_model(X, y):
    D = X.shape[1]
    tau = npt.sample("tau", dist.HalfCauchy(0.1))
    with npt.plate("D", D):
        lam = npt.sample("lambda", dist.HalfCauchy(1.0))
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    with npt.plate("D2", D):
        beta = npt.sample("beta", dist.Normal(0.0, tau * lam))
    with npt.plate("N", X.shape[0]):
        npt.sample("y", dist.Normal(X @ beta, sigma), obs=y)


# ---------------------------------------------------------------------------
# Distributions and transforms (rtol 1e-6)

VALUES = np.array([1e-3, 0.1, 1.0, 3.5, 40.0], np.float32)


@pytest.mark.parametrize("name,args", [
    ("Cauchy", (0.3, 2.0)), ("Cauchy", (np.array([-1.0, 0.5], np.float32), 0.7)),
    ("HalfCauchy", (0.1,)), ("HalfCauchy", (np.array([1.0, 2.5], np.float32),)),
    ("HalfNormal", (1.0,)), ("HalfNormal", (np.array([0.2, 3.0], np.float32),)),
])
def test_log_prob_mean_and_variance_match_jax(name, args):
    d_t = getattr(dist, name)(*(torch.as_tensor(a) for a in args))
    d_j = getattr(jdist, name)(*(jnp.asarray(a) for a in args))
    assert tuple(d_t.batch_shape) == tuple(d_j.batch_shape)
    v = VALUES.reshape((-1,) + (1,) * len(d_j.batch_shape))
    np.testing.assert_allclose(d_t.log_prob(torch.from_numpy(v)).numpy(),
                               np.asarray(d_j.log_prob(jnp.asarray(v))), rtol=1e-6)
    for moment in ("mean", "variance"):
        np.testing.assert_allclose(getattr(d_t, moment).numpy(),
                                   np.asarray(getattr(d_j, moment)), rtol=1e-6)
    draws = d_t.sample(torch.Generator().manual_seed(0), (4000,))
    assert draws.shape == (4000,) + tuple(d_j.batch_shape)
    if name != "Cauchy":
        assert bool((draws >= 0).all()) and d_t.support is constraints.positive
    # the median of |X| (and of X) is where the cdf crosses one half
    if name == "HalfNormal":
        np.testing.assert_allclose(draws.median(0).values.numpy(), 0.6745 * np.asarray(args[0]),
                                   rtol=0.1)


def test_exp_and_affine_transforms_match_jax():
    x = np.linspace(-3, 3, 7).astype(np.float32)
    loc, scale = np.float32(1.5), np.array([-2.0, 0.5, 3.0], np.float32)
    pairs = [
        (transforms.ExpTransform(), jtransforms.ExpTransform()),
        (transforms.AffineTransform(loc, torch.from_numpy(scale)),
         jtransforms.AffineTransform(loc, jnp.asarray(scale))),
        (transforms.AffineTransform(0.0, 1.0, domain=constraints.positive),
         jtransforms.AffineTransform(0.0, 1.0, domain=jconstraints.positive)),
    ]
    xs = np.repeat(x[:, None], 3, 1)
    for t, j in pairs:
        y_t, y_j = t(torch.from_numpy(xs)), j(jnp.asarray(xs))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6)
        np.testing.assert_allclose(t.inv(y_t).numpy(), np.asarray(j.inv(y_j)), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(t.log_abs_det_jacobian(torch.from_numpy(xs), y_t).numpy(),
                                   np.asarray(j.log_abs_det_jacobian(jnp.asarray(xs), y_j)),
                                   rtol=1e-6)
        np.testing.assert_allclose(t.inv.log_abs_det_jacobian(y_t, torch.from_numpy(xs)).numpy(),
                                   np.asarray(j.inv.log_abs_det_jacobian(y_j, jnp.asarray(xs))),
                                   rtol=1e-6)
        assert repr(t.codomain) == repr(j.codomain)
    assert transforms.AffineTransform(2.0, 3.0).forward_shape((4, 1)) == (4, 1)


@pytest.mark.parametrize("name,args", [
    ("positive", None), ("nonnegative", None), ("greater_than", 1.5), ("greater_than_eq", -2.0),
])
def test_biject_to_half_lines_matches_jax(name, args):
    c_t = getattr(constraints, name) if args is None else getattr(constraints, name)(args)
    c_j = getattr(jconstraints, name) if args is None else getattr(jconstraints, name)(args)
    t, j = transforms.biject_to(c_t), jtransforms.biject_to(c_j)
    # the JAX package's table sends every _GreaterThan, ``positive``
    # included, to Exp followed by Affine(bound, 1); the port makes the same
    # choice (exp itself may differ in the last bit between the two)
    assert [type(p).__name__ for p in t.parts] == [type(p).__name__ for p in j.parts] == [
        "ExpTransform", "AffineTransform"]
    x = np.linspace(-4, 4, 9).astype(np.float32)
    y_t, y_j = t(torch.from_numpy(x)), j(jnp.asarray(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6)
    np.testing.assert_array_equal(
        t.log_abs_det_jacobian(torch.from_numpy(x), y_t).numpy(),
        np.asarray(j.log_abs_det_jacobian(jnp.asarray(x), y_j)))
    np.testing.assert_allclose(t.inv(y_t).numpy(), x, rtol=1e-5, atol=1e-5)
    assert bool(c_t(y_t).all()) and repr(c_t) == repr(c_j) and repr(t.codomain) == repr(j.codomain)
    assert c_t == (getattr(constraints, name) if args is None else getattr(constraints, name)(args))


# ---------------------------------------------------------------------------
# The model's potential and gradient (rtol 1e-5)

N_DATA, D_DATA = 100, 20  # the example's defaults
C = 4


@pytest.fixture(scope="module")
def horseshoe():
    X, y, _ = make_data(N_DATA, D_DATA, 3)
    rng = np.random.default_rng(1)
    z = {
        "beta": rng.normal(0, 1, (C, D_DATA)), "lambda": rng.normal(0, 1, (C, D_DATA)),
        "sigma": rng.normal(-0.5, 0.3, C), "tau": rng.normal(-2, 0.3, C),
    }
    z = {k: v.astype(np.float32) for k, v in z.items()}
    return X, y, z


@pytest.mark.parametrize("forward_mode", [False, True])
def test_potential_and_gradient_match_jax(horseshoe, forward_mode):
    X, y, z = horseshoe
    j_layout = jc.FlatLayout({k: jnp.asarray(v[0]) for k, v in z.items()})
    t_layout = core.FlatLayout({k: torch.as_tensor(v[0]) for k, v in z.items()})
    args_t = (torch.from_numpy(X), torch.from_numpy(y))

    def pe_fn_t(p):
        return util.potential_energy(torch_model, args_t, {}, p)

    pe_j = jax.jit(jc.batched_potential(
        lambda p: jutil.potential_energy(jax_model, (jnp.asarray(X), jnp.asarray(y)), {}, p),
        j_layout, forward_mode))
    pe_t = core.batched_potential(pe_fn_t, t_layout, forward_mode=forward_mode)
    panel = np.asarray(j_layout.ravel_batch({k: jnp.asarray(v) for k, v in z.items()}))
    v_j, g_j = pe_j(jnp.asarray(panel))
    v_t, g_t = pe_t(torch.from_numpy(panel))
    assert g_t.dtype == torch.float32 and g_t.shape == (C, 2 * D_DATA + 2)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(g_j)).max())
    if forward_mode:  # and forward mode agrees with reverse mode in the port
        _, g_rev = core.batched_potential(pe_fn_t, t_layout)(torch.from_numpy(panel))
        np.testing.assert_allclose(g_t.numpy(), g_rev.numpy(), rtol=1e-5,
                                   atol=1e-5 * g_rev.abs().max().item())


def test_forward_mode_runs_through_mcmc_and_the_init_search():
    X, y, _ = make_data(N_DATA, D_DATA, 3)
    kernel = NUTS(torch_model, dense_mass=True, max_tree_depth=3, forward_mode_differentiation=True)
    mcmc = MCMC(kernel, num_warmup=4, num_samples=3, num_chains=2, device="cpu")
    mcmc.run(0, torch.from_numpy(X), torch.from_numpy(y))
    draws = mcmc.get_samples(group_by_chain=True)
    assert draws["beta"].shape == (2, 3, D_DATA) and bool(torch.isfinite(draws["beta"]).all())
    assert bool((draws["tau"] > 0).all()) and bool((draws["lambda"] > 0).all())
    assert mcmc.last_state.z_grad["beta"].dtype == torch.float32
    info = util.initialize_model(torch.Generator().manual_seed(0), torch_model, num_chains=3,
                                 model_args=(torch.from_numpy(X), torch.from_numpy(y)),
                                 forward_mode_differentiation=True)
    pe_fn = info.potential_fn
    pe, grad = util.batched_value_and_grad(pe_fn)(info.param_info.z)
    np.testing.assert_allclose(info.param_info.potential_energy.numpy(), pe.numpy(), rtol=1e-6)
    for k in grad:
        np.testing.assert_allclose(info.param_info.z_grad[k].numpy(), grad[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * grad[k].abs().max().item())


# ---------------------------------------------------------------------------
# A whole run at a small size against the JAX package


def _moments(samples):
    """Median and IQR per coefficient (tests/test_reference_parity.py:95-104)."""
    q25, q50, q75 = np.percentile(np.asarray(samples), [25, 50, 75], axis=0)
    return q50, q75 - q25


def test_dense_horseshoe_run_matches_jax():
    """``beta``'s medians within 0.35 of the posterior IQR (plus 5% of the
    median) and its IQRs within 35% (plus 0.01) of JAX's: the rule of
    tests/test_reference_parity.py:106-124, copied here."""
    X, y, beta_true = make_data(50, 5, 2)
    run = dict(num_warmup=50, num_samples=25, num_chains=32)
    jm = JMCMC(JNUTS(jax_model, dense_mass=True, max_tree_depth=(4, 5)), chain_method="vectorized",
               progress_bar=False, **run)
    jm.run(random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y))
    tm = MCMC(NUTS(torch_model, dense_mass=True, max_tree_depth=(4, 5)), device="cpu", **run)
    tm.run(0, torch.from_numpy(X), torch.from_numpy(y))
    m_ref, s_ref = _moments(jm.get_samples()["beta"])
    m_ours, s_ours = _moments(tm.get_samples()["beta"].numpy())
    tol = 0.35 * (np.abs(s_ref) + 1e-3)
    assert np.all(np.abs(m_ours - m_ref) < tol + 0.05 * np.abs(m_ref)), (m_ours, m_ref, s_ref)
    assert np.all(np.abs(s_ours - s_ref) < 0.35 * np.abs(s_ref) + 1e-2), (s_ours, s_ref)
    assert np.abs(m_ours - beta_true).max() < 0.2
    assert tm.last_state.adapt_state.inverse_mass_matrix.shape == (32, 12, 12)
