"""The gamma draw's reparameterised derivative in the port
(``distributions.util._gamma_draw_derivative`` through ``_GammaDraw``): its
accuracy against a float64 reference over a in [0.05, 1e6] and x from the
1e-4 to the 1 - 1e-4 quantile (rtol 1e-5), and far out in both tails
against mpmath (rtol 1e-9), against the JAX package's
``random_gamma_grad`` on the same draws (rtol 1e-5, widened by JAX's own
float32 drift at large shapes), in forward mode
against reverse mode for every family that draws gammas (rtol 1e-6), a
model with a gamma site under ``forward_mode_differentiation=True`` against
the JAX package's potential gradient (rtol 1e-5), ``gammainc``'s
derivative in its shape against JAX's (as the draws'), and the raise of a
second derivative through either."""

import numpy as np
import pytest
import torch
from scipy import special

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu.infer import hmc_core as jc
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions.util import _gamma_draw_derivative, gammainc
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util

from torch_draws import FedDraws

torch.set_num_threads(1)

# 0.05 to 1000, and the large shapes where Temme's expansion takes over
SHAPES = np.concatenate([np.geomspace(0.05, 1000.0, 13), [5e3, 1e4, 1e5, 1e6]])


def _reference(a, x, rel=1e-5):
    """``dx/da`` at fixed ``P(a, x)`` in float64: a central difference of
    scipy's ``gammaincinv`` (``gammainccinv`` above the median), Richardson
    extrapolated from steps ``rel * a`` and ``2 rel * a``."""
    lower = special.gammainc(a, x)
    upper = special.gammaincc(a, x)
    above = lower > 0.5

    def inverse(s):
        return np.where(above, special.gammainccinv(s, upper), special.gammaincinv(s, lower))

    h = rel * a
    d1 = (inverse(a + h) - inverse(a - h)) / (2 * h)
    d2 = (inverse(a + 2 * h) - inverse(a - 2 * h)) / (4 * h)
    return (4 * d1 - d2) / 3


@pytest.mark.parametrize("a", SHAPES)
def test_draw_derivative_matches_the_float64_reference(a):
    q = np.concatenate([np.geomspace(1e-4, 0.5, 40), 1 - np.geomspace(1e-4, 0.5, 40)])
    x = special.gammaincinv(a, q)
    shape = np.full_like(x, a)
    got = _gamma_draw_derivative(torch.from_numpy(shape), torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _reference(shape, x), rtol=1e-5)


@pytest.mark.parametrize("a", [0.3, 20.0, 49.0, 50.0, 1e3, 1e4])
def test_draw_derivative_far_in_the_tails(a):
    """At ``x / a`` from 0.01 to 20, where ``gammainc``'s derivative in its
    shape is taken though no draw lands there: the series, the continued
    fraction and Temme's expansion each against mpmath's derivative of the
    regularized incomplete gamma function (50 digits)."""
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 50
    lam = np.array([0.01, 0.29, 0.31, 0.7, 1.3, 2.3, 2.4, 20.0])
    x = lam * a
    want = []
    for xi in x:
        s, t = mp.mpf(float(a)), mp.mpf(float(xi))
        if t > s:
            dq = mp.diff(lambda b: mp.gammainc(b, t, mp.inf, regularized=True), s)
        else:
            dq = -mp.diff(lambda b: mp.gammainc(b, 0, t, regularized=True), s)
        want.append(float(dq / mp.exp((s - 1) * mp.log(t) - t - mp.loggamma(s))))
    got = _gamma_draw_derivative(torch.full((len(x),), a, dtype=torch.float64),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


def test_draw_derivative_edges():
    """0 at a draw of 0; NaN off the domain, as JAX's ``random_gamma_grad``."""
    a = torch.tensor([2.0, -1.0, 0.0, float("nan"), 2.0], dtype=torch.float64)
    x = torch.tensor([0.0, 1.0, 1.0, 1.0, -1.0], dtype=torch.float64)
    got = _gamma_draw_derivative(a, x)
    want = np.asarray(jax.lax.random_gamma_grad(jnp.asarray(a.numpy(), jnp.float32),
                                                jnp.asarray(x.numpy(), jnp.float32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_second_derivative_of_a_draw_raises():
    """The draw's derivative is computed off the graph, so a second
    derivative through it raises, as JAX's ``random_gamma_grad`` and
    ``igamma_grad_a`` have none; the first is unchanged under
    ``torch.func.grad`` (which keeps a graph of the backward)."""
    def draw(c):
        return dist.Gamma(c, 1.0).sample(torch.Generator().manual_seed(0)).sum()

    conc = torch.tensor([2.0, 300.0])
    x = dist.Gamma(conc, 1.0).sample(torch.Generator().manual_seed(0))
    want = _gamma_draw_derivative(conc.double(), x.double()).float()
    np.testing.assert_allclose(torch.func.grad(draw)(conc).numpy(), want.numpy(), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="has no derivative"):
        torch.func.grad(lambda c: torch.func.grad(draw)(c).sum())(conc)
    with pytest.raises(NotImplementedError, match="has no derivative"):
        torch.func.grad(lambda s: torch.func.grad(
            lambda t: gammainc(t, torch.tensor(1.5)))(s))(torch.tensor(2.0))


def _near_jax(got, want, ref):
    """``got`` within 1e-5 relative of JAX's ``want``, widened by JAX's own
    distance from the float64 reference ``ref`` where that is larger: the
    JAX package's float32 derivative drifts with the shape (5e-5 relative
    off at a = 900, 8.5e-5 for ``gammainc`` at a = 300), while the port's
    stays within 1e-9 of the reference."""
    got, want, ref = (np.asarray(v, np.float64) for v in (got, want, ref))
    drift = np.where(np.isfinite(ref), np.abs(want - ref), 0.0)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + drift + 1e-30).all(), (got, want, ref)
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-5)


@pytest.mark.parametrize("a", [0.05, 0.7, 3.0, 60.0, 300.0, 900.0, 5e3, 1e5])
def test_draw_derivative_matches_jax_on_its_draws(a):
    key = random.PRNGKey(int(a * 10))
    conc = jnp.full((64,), a, jnp.float32)
    draws = random.gamma(key, conc)
    weights = jnp.arange(1.0, 65.0)
    want = jax.grad(lambda c: (random.gamma(key, c) * weights).sum())(conc) / weights
    alpha = torch.full((64,), a).requires_grad_()
    got = dist.util.standard_gamma(FedDraws([("gammas", draws)]), alpha)
    (got * torch.arange(1.0, 65.0)).sum().backward()
    x = np.asarray(draws, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        ref = np.where(x > 0, _reference(np.full(64, a), np.maximum(x, 1e-300)), np.nan)
    _near_jax(alpha.grad.numpy() / np.arange(1.0, 65.0), want, ref)


def _fed(name, conc, key):
    conc = np.asarray(conc, np.float32)
    if name == "Gamma":
        return dist.Gamma(torch.from_numpy(conc), 1.5), [random.gamma(key, conc)]
    if name == "Beta":
        k1, k0 = random.split(key)
        return dist.Beta(torch.from_numpy(conc), 2.5), [random.gamma(k1, conc),
                                                        random.gamma(k0, jnp.full(3, 2.5))]
    if name == "Dirichlet":
        return dist.Dirichlet(torch.from_numpy(conc)), [random.gamma(key, conc)]
    return dist.StudentT(torch.from_numpy(conc), 0.5, 2.0), [random.gamma(key, conc / 2)]


@pytest.mark.parametrize("name", ["Gamma", "Beta", "Dirichlet", "StudentT"])
def test_jvp_of_a_draw_equals_the_vjp_derivative(name):
    """The Jacobian of a draw in its concentration (or ``df``) by forward
    mode equals the one by reverse mode, on the same draws (StudentT's
    normal draw is fed as well)."""
    conc = np.array([0.4, 2.0, 15.0], np.float32)
    key = random.PRNGKey(1)

    def _sample(c):
        d, gammas = _fed(name, conc, key)
        items = [("gammas", g) for g in gammas]
        if name == "StudentT":
            items.insert(0, ("normals", np.array([0.3, -1.2, 0.8], np.float32)))
        return _rebuild(name, c).sample(FedDraws(items))

    c0 = torch.from_numpy(conc)
    jac_fwd = torch.func.jacfwd(_sample)(c0)
    jac_rev = torch.func.jacrev(_sample)(c0)
    assert torch.isfinite(jac_fwd).all() and jac_fwd.abs().sum() > 0
    np.testing.assert_allclose(jac_fwd.numpy(), jac_rev.numpy(), rtol=1e-6, atol=1e-7)


def _rebuild(name, c):
    return {"Gamma": lambda: dist.Gamma(c, 1.5), "Beta": lambda: dist.Beta(c, 2.5),
            "Dirichlet": lambda: dist.Dirichlet(c),
            "StudentT": lambda: dist.StudentT(c, 0.5, 2.0)}[name]()


def test_gamma_draw_under_forward_mode_differentiation_with_a_generator():
    """From the run's generator, jvp and grad of the same draw agree, and
    each particle of a ``vmap`` draws its own value."""
    gen = torch.Generator().manual_seed(0)
    a = torch.tensor([0.5, 3.0, 40.0])
    value, tangent = torch.func.jvp(lambda c: dist.Gamma(c, 1.0).sample(
        torch.Generator().manual_seed(2)), (a,), (torch.ones(3),))
    grad = torch.func.jacrev(lambda c: dist.Gamma(c, 1.0).sample(
        torch.Generator().manual_seed(2)))(a).diagonal()
    np.testing.assert_allclose(tangent.numpy(), grad.numpy(), rtol=1e-6)
    tangents = torch.func.vmap(lambda _: torch.func.jvp(
        lambda c: dist.Gamma(c, 1.0).sample(gen), (a,), (torch.ones(3),))[1],
        randomness="different")(torch.arange(4))
    assert len(torch.unique(tangents[:, 0])) == 4


def jax_model(y):
    a = numpyro_tpu.sample("a", jdist.Gamma(2.0, 1.0))
    tau = numpyro_tpu.sample("tau", jdist.Gamma(a, 2.0))
    with numpyro_tpu.plate("N", y.shape[0]):
        numpyro_tpu.sample("y", jdist.Gamma(tau, 1.0), obs=y)


def torch_model(y):
    a = npt.sample("a", dist.Gamma(2.0, 1.0))
    tau = npt.sample("tau", dist.Gamma(a, 2.0))
    with npt.plate("N", y.shape[0]):
        npt.sample("y", dist.Gamma(tau, 1.0), obs=y)


def test_gamma_site_model_in_forward_mode_matches_jax():
    """The potential and its gradient by forward mode at 4 unconstrained
    points, against the JAX package's in forward mode; then NUTS in forward
    mode runs."""
    y = np.random.default_rng(0).gamma(2.0, 1.0, 10).astype(np.float32)
    z = {k: np.random.default_rng(1).normal(0, 0.5, 4).astype(np.float32) for k in ("a", "tau")}
    j_layout = jc.FlatLayout({k: jnp.asarray(v[0]) for k, v in z.items()})
    t_layout = core.FlatLayout({k: torch.as_tensor(v[0]) for k, v in z.items()})
    pe_j = jax.jit(jc.batched_potential(
        lambda p: jutil.potential_energy(jax_model, (jnp.asarray(y),), {}, p), j_layout, True))
    pe_t = core.batched_potential(
        lambda p: util.potential_energy(torch_model, (torch.from_numpy(y),), {}, p), t_layout,
        forward_mode=True)
    panel = np.asarray(j_layout.ravel_batch({k: jnp.asarray(v) for k, v in z.items()}))
    v_j, g_j = pe_j(jnp.asarray(panel))
    v_t, g_t = pe_t(torch.from_numpy(panel))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)
    from numpyro_tpu_torch.infer import MCMC, NUTS

    kernel = NUTS(torch_model, forward_mode_differentiation=True, max_tree_depth=3)
    mcmc = MCMC(kernel, num_warmup=5, num_samples=5, num_chains=2, device="cpu")
    mcmc.run(0, torch.from_numpy(y))
    assert bool(torch.isfinite(mcmc.get_samples()["tau"]).all())


def test_gammainc_derivative_in_the_shape_matches_jax():
    a = np.array([0.3, 1.0, 2.5, 9.0, 40.0, 300.0], np.float32)
    x = np.array([0.1, 1.7, 2.0, 12.0, 35.0, 310.0], np.float32)
    want_a, want_x = jax.grad(lambda a, x: jax.scipy.special.gammainc(a, x).sum(),
                              argnums=(0, 1))(jnp.asarray(a), jnp.asarray(x))
    at, xt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(x).requires_grad_()
    gammainc(at, xt).sum().backward()
    a64, x64 = a.astype(np.float64), x.astype(np.float64)
    h = 1e-5 * a64
    ref = (special.gammainc(a64 + h, x64) - special.gammainc(a64 - h, x64)) / (2 * h)
    _near_jax(at.grad.numpy(), want_a, ref)
    # the derivative in x is the density, in float32 as JAX's: both lose
    # 1e-4 relative to cancellation at a = 300, so held to 1e-5 below it
    np.testing.assert_allclose(xt.grad.numpy()[:5], np.asarray(want_x)[:5], rtol=1e-5)
    # forward mode gives the same
    _, t_a = torch.func.jvp(lambda s: gammainc(s, torch.from_numpy(x)), (torch.from_numpy(a),),
                            (torch.ones(6),))
    np.testing.assert_allclose(t_a.numpy(), at.grad.numpy(), rtol=1e-6)
