"""The port's directional families against the JAX package's, on the same
numpy inputs: ``VonMises``, ``ProjectedNormal`` (in dimensions 2, 3 and 5),
``SineSkewed``, ``SineBivariateVonMises`` and ``log_bessel_i_orders``
(``log_prob``, ``mean``, ``variance`` and the raise of a method the JAX class
lacks), ``sample`` on JAX's own draws (``von_mises``, ``normals`` and
``uniforms`` through ``tests/torch_draws.py``), the fixed-round rejection
samplers (no unsettled lane, the draws against their density by the port's
``gof``, the envelope's acceptance rate at the bound its round count is
sized for).  Tolerances: rtol 1e-5 and atol 1e-6 on float32 values unless a
case says why not."""

import math

import numpy as np
import pytest
import torch
from scipy import special

import jax.numpy as jnp
from jax import random

import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.directional import SBVM_ROUNDS, log_bessel_i_orders
from numpyro_tpu_torch.distributions.gof import (auto_goodness_of_fit,
                                                 torus_goodness_of_fit)
from numpyro_tpu_torch.distributions.util import VON_MISES_ROUNDS, von_mises_centered
from numpyro_tpu_torch.util import soft_vmap

from test_torch_discrete_families import _close, _t
from torch_draws import FedDraws, exact_sine_bivariate_draws

torch.set_num_threads(1)

TEST_FAILURE_RATE = 5e-3


# ---------------------------------------------------------------------------
# VonMises and its sampler


def _von_mises_pair():
    loc = np.array([0.5, -2.0, 3.0], np.float32)
    conc = np.array([2.0, 0.3, 40.0], np.float32)
    return (jdist.VonMises(jnp.asarray(loc), jnp.asarray(conc)),
            dist.VonMises(_t(loc), _t(conc)))


def test_von_mises_methods_and_fed_draws_match_jax():
    d_j, d_t = _von_mises_pair()
    x = np.asarray(d_j.sample(random.PRNGKey(0), (4,)))
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x))
    _close(d_t.log_prob(_t(x + 2 * np.pi)), d_j.log_prob(x + 2 * np.pi), atol=1e-5)
    _close(d_t.mean, d_j.mean)
    _close(d_t.variance, d_j.variance)
    for attr in ("cdf", "icdf", "entropy"):
        with pytest.raises(NotImplementedError, match=f"VonMises.{attr}"):
            getattr(d_t, attr)(*((_t(x),) if attr != "entropy" else ()))
    key = random.PRNGKey(3)
    centred = jdist.util.von_mises_centered(key, d_j.concentration, (5, 3), dtype=jnp.float32)
    source = FedDraws([("von_mises", centred)])
    # JAX's own sample on the same key is these centred draws, shifted and wrapped
    want = np.asarray(d_j.sample(key, (5,)))
    got = d_t.sample(source, (5,))
    assert not source.items
    _close(got, want, atol=1e-6)
    assert d_t.support is constraints.circular and not d_t.has_rsample


KAPPAS = [1e-3, 0.02, 1.0, 50.0, 1e4]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_von_mises_sampler_over_concentrations(kappa, dtype):
    """No unsettled lane in 20,000 draws; the mean resultant length
    ``E cos x = I1(k) / I0(k)`` within 4 standard errors; and the density
    test in float64, and in float32 up to a concentration of 1: above it
    the float32 proposals are too coarse for the nearest-neighbour test, and
    the JAX package's own float32 draws fail it too (p = 2e-110 at 50)."""
    n = 20_000
    gen = torch.Generator().manual_seed(int(kappa * 1000) % 997)
    x = von_mises_centered(gen, torch.tensor(kappa, dtype=dtype), (n,))
    assert x.dtype == dtype and not torch.isnan(x).any()
    assert bool(((x >= -math.pi) & (x <= math.pi)).all())
    c = torch.cos(x.double())
    want = special.ive(1, kappa) / special.ive(0, kappa)
    assert abs(c.mean().item() - want) < 4 * c.std().item() / math.sqrt(n) + 1e-7
    if dtype == torch.float64 or kappa <= 1:
        d = dist.VonMises(torch.tensor(0.0, dtype=torch.float64), torch.tensor(kappa,
                                                                              dtype=torch.float64))
        probs = d.log_prob(x.double()).exp()
        assert auto_goodness_of_fit(x.double(), probs) > TEST_FAILURE_RATE


def test_von_mises_rounds_meet_their_bound():
    """The rounds are sized for the envelope's worst acceptance rate, 0.656:
    the chance that a lane of 1e8 draws is unsettled stays below 1e-12."""
    assert 1e8 * (1 - 0.656) ** VON_MISES_ROUNDS < 1e-12
    # the acceptance rate over concentrations, on 200,000 proposals each
    for kappa in (0.5, 5.0, 1e3, 1e5):
        k = torch.tensor(kappa, dtype=torch.float64)
        g = torch.Generator().manual_seed(1)
        u, v = torch.rand((2, 200_000), generator=g, dtype=torch.float64)
        r = 1 + torch.sqrt(1 + 4 * k * k)
        rho = (r - torch.sqrt(2 * r)) / (2 * k)
        env = (1 + rho * rho) / (2 * rho)
        z = torch.cos(math.pi * u)
        w = (1 + env * z) / (env + z)
        y = k * (env - w)
        ok = (y * (2 - y) >= v) | (torch.log((y / v).clamp(min=1e-37)) + 1 >= y)
        assert ok.double().mean() > 0.656


def test_von_mises_draws_under_soft_vmap_differ():
    _, d_t = _von_mises_pair()
    gen = torch.Generator().manual_seed(2)
    x = soft_vmap(lambda _: d_t.sample(gen), torch.arange(4000))
    # float32 ties aside, every element draws its own value
    assert x.shape == (4000, 3) and len(torch.unique(x[:, 0])) > 3980
    c = torch.cos(x - d_t.loc).double()
    want = torch.from_numpy(special.ive(1, d_t.concentration.double().numpy())
                            / special.ive(0, d_t.concentration.double().numpy()))
    assert ((c.mean(0) - want).abs() < 4 * c.std(0) / math.sqrt(4000)).all()


# ---------------------------------------------------------------------------
# log_bessel_i_orders


def test_log_bessel_orders_match_jax_and_scipy():
    kappa = np.array([0.1, 1.0, 4.0, 30.0, 200.0], np.float32)
    """Where the scaled value ``I_m(k) e^-k`` stands above the float32
    quadrature's rounding (above 1e-3), against JAX's and scipy's; below it both
    packages return rounding noise (or the clamp at ``tiny``)."""
    got = log_bessel_i_orders(12, _t(kappa)).numpy()
    want = np.asarray(jdist.directional.log_bessel_i_orders(12, jnp.asarray(kappa)))
    scaled = special.ive(np.arange(13), kappa[:, None].astype(np.float64))
    ok = scaled > 1e-3
    assert ok.sum() > 30
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[ok], (np.log(scaled) + kappa[:, None])[ok], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# ProjectedNormal


@pytest.mark.parametrize("dim", [2, 3, 5])
def test_projected_normal_matches_jax(dim):
    rng = np.random.default_rng(dim)
    conc = rng.normal(0, 1.5, (3, dim)).astype(np.float32)
    d_j, d_t = jdist.ProjectedNormal(jnp.asarray(conc)), dist.ProjectedNormal(_t(conc))
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape
    key = random.PRNGKey(dim)
    x = np.asarray(d_j.sample(key, (4,)))
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x), atol=1e-5)
    _close(d_t.mean, d_j.mean)
    _close(d_t.mode, d_j.mode)
    source = FedDraws([("normals", random.normal(key, (4, 3, dim)))])
    _close(d_t.sample(source, (4,)), x, atol=1e-6)
    assert bool(d_t.support(d_t.sample(torch.Generator().manual_seed(0), (5,))).all())
    # a zero concentration maps to the uniform direction, with a zero gradient
    zero = torch.zeros(dim, requires_grad=True)
    dist.ProjectedNormal(zero).mean.sum().backward()
    assert torch.equal(zero.grad, torch.zeros(dim))


def test_projected_normal_angle_density_fits_its_draws():
    """The JAX package's test in the angle of the circle (unit Jacobian)."""
    d = dist.ProjectedNormal(torch.tensor([1.0, 0.5], dtype=torch.float64))
    x = d.sample(torch.Generator().manual_seed(3), (6000,))
    theta = torch.atan2(x[:, 1], x[:, 0])
    assert auto_goodness_of_fit(theta, d.log_prob(x).exp()) > TEST_FAILURE_RATE


# ---------------------------------------------------------------------------
# SineSkewed


def test_sine_skewed_matches_jax():
    skew = np.array([0.3, -0.2], np.float32)
    base_j = jdist.VonMises(0.0, 2.0).expand((2,)).to_event(1)
    base_t = dist.VonMises(_t(0.0), _t(2.0)).expand((2,)).to_event(1)
    d_j, d_t = jdist.SineSkewed(base_j, jnp.asarray(skew)), dist.SineSkewed(base_t, _t(skew))
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape == (2,)
    key = random.PRNGKey(5)
    x = np.asarray(d_j.sample(key, (6,)))
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x))
    _close(d_t.mean, d_j.mean)
    base_key, skew_key = random.split(key)
    centred = jdist.util.von_mises_centered(base_key, jnp.full((6, 2), 2.0), (6, 2),
                                            dtype=jnp.float32)
    source = FedDraws([("von_mises", centred), ("uniforms", random.uniform(skew_key, (6,)))])
    _close(d_t.sample(source, (6,)), x, atol=1e-6)
    # the skewed density integrates to one on the torus (a 400 x 400 grid)
    g = torch.linspace(-math.pi, math.pi, 401, dtype=torch.float64)[:-1]
    grid = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1)
    dd = dist.SineSkewed(dist.VonMises(torch.tensor(0.0, dtype=torch.float64),
                                       torch.tensor(2.0, dtype=torch.float64)).expand(
        (2,)).to_event(1), torch.from_numpy(skew.astype(np.float64)))
    assert abs(dd.log_prob(grid).exp().sum().item() * (2 * math.pi / 400) ** 2 - 1) < 1e-6


# ---------------------------------------------------------------------------
# SineBivariateVonMises

# the JAX package's cases (tests/test_distributions_sweep.py,
# tests/test_distributions_extra.py); the first has the lowest acceptance
SBVM_CASES = [dict(phi_loc=0.0, psi_loc=0.5, phi_concentration=2.0, psi_concentration=3.0,
                   correlation=0.5),
              dict(phi_loc=0.0, psi_loc=0.0, phi_concentration=2.0, psi_concentration=2.0,
                   correlation=0.5)]


@pytest.mark.parametrize("case", range(len(SBVM_CASES)))
def test_sine_bivariate_von_mises_matches_jax(case):
    params = SBVM_CASES[case]
    d_j = jdist.SineBivariateVonMises(**params)
    d_t = dist.SineBivariateVonMises(**{k: _t(v) for k, v in params.items()})
    x = np.asarray(d_j.sample(random.PRNGKey(1), (5,)))
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x), atol=1e-5)
    _close(d_t.norm_const, d_j.norm_const, atol=1e-5)
    _close(d_t.mean, d_j.mean)
    weighted = dict(params, weighted_correlation=params["correlation"] / math.sqrt(
        params["phi_concentration"] * params["psi_concentration"]))
    weighted.pop("correlation")
    _close(dist.SineBivariateVonMises(**{k: _t(v) for k, v in weighted.items()}).log_prob(_t(x)),
           d_j.log_prob(x), atol=1e-5)
    with pytest.raises(ValueError, match="Exactly one"):
        dist.SineBivariateVonMises(0.0, 0.0, 1.0, 1.0)
    # the normaliser against a float64 grid sum of exp(energy) on the torus
    g = torch.linspace(-math.pi, math.pi, 401, dtype=torch.float64)[:-1]
    grid = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1)
    d64 = dist.SineBivariateVonMises(**{k: torch.tensor(v, dtype=torch.float64)
                                        for k, v in params.items()})
    assert abs(d64.log_prob(grid).exp().sum().item() * (2 * math.pi / 400) ** 2 - 1) < 1e-6


def _acceptance(kappa_phi, kappa_psi, rho, n=200_000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    args = [torch.tensor([v], dtype=torch.float64) for v in (kappa_phi, kappa_psi, rho)]
    gauss = torch.randn((n, 2, 1), generator=gen, dtype=torch.float64)
    _, log_ratio = dist.SineBivariateVonMises._phi_proposals(gauss, *args)
    return log_ratio.exp().clamp(max=1.0).mean().item()


def test_sine_bivariate_rounds_meet_their_bound():
    """The two stages are sized for an acceptance rate of 0.095: below 1e-12
    for any of 1e8 lanes (the slots of the second stage overflow with a
    binomial probability below 1e-40).  JAX's cases accept 0.45; the
    domain's corner (concentrations 1e4 and 0.01, weighted correlation 0.95)
    0.098 (on 1e6 proposals, a standard error of 3e-4)."""
    from scipy.stats import binom

    miss = 0.905 ** SBVM_ROUNDS[0]
    for lanes in (1, 100, 10_000, 10**6, 10**8):
        slots = min(lanes, math.ceil(2 * lanes * miss) + 64)
        assert binom.sf(slots, lanes, miss) < 1e-40
        assert slots * 0.905 ** SBVM_ROUNDS[1] < 1e-12
    for params in SBVM_CASES:
        assert _acceptance(params["phi_concentration"], params["psi_concentration"],
                           params["correlation"]) > 0.45
    assert _acceptance(1e4, 0.01, 0.95 * math.sqrt(1e4 * 0.01), n=10**6) > 0.095


def test_sine_bivariate_draws_settle_and_fit_the_density():
    """At the JAX package's case of the lowest acceptance: no unsettled lane
    in 1e6 float32 draws (in chunks of 100,000), and 20,000 float64 draws
    against the density by Pearson's test on 144 cells of the torus through
    the port's ``gof`` (``gof.torus_goodness_of_fit``; the nearest-neighbour
    test is not calibrated for this density, as
    ``test_torus_test_passes_an_exact_sampler`` and ``dev/torus_gof.py``
    show)."""
    gen = torch.Generator().manual_seed(4)
    d32 = dist.SineBivariateVonMises(**{k: torch.tensor(v) for k, v in SBVM_CASES[0].items()})
    for _ in range(10):
        assert not torch.isnan(d32.sample(gen, (100_000,))).any()
    params = {k: torch.tensor(v, dtype=torch.float64) for k, v in SBVM_CASES[0].items()}
    d = dist.SineBivariateVonMises(**params)
    x = d.sample(gen, (20_000,))
    assert bool(d.support(x).all()) and x.shape == (20_000, 2)
    assert torus_goodness_of_fit(d, x) > TEST_FAILURE_RATE


def test_torus_test_passes_an_exact_sampler():
    """20,000 exact draws of the chip smoke's ``SineBivariateVonMises``
    case pass the torus test (``dev/torus_gof.py`` runs 10 seeds through it
    and through the nearest-neighbour test, which rejects some)."""
    params = dict(phi_loc=0.0, psi_loc=0.5, phi_concentration=2.0, psi_concentration=3.0,
                  correlation=0.5)
    d = dist.SineBivariateVonMises(**{k: torch.tensor(v, dtype=torch.float64)
                                      for k, v in params.items()})
    x = exact_sine_bivariate_draws(params, 20_000, 0)
    assert x.shape == (20_000, 2)
    assert torus_goodness_of_fit(d, x) > TEST_FAILURE_RATE


def test_sine_skewed_own_draws_fit_the_density():
    """20,000 float64 draws of the JAX package's ``SineSkewed`` case on the
    port's generator against its density, by the torus test, and under
    ``soft_vmap`` each element draws its own value."""
    base = dist.VonMises(torch.tensor(0.0, dtype=torch.float64),
                         torch.tensor(2.0, dtype=torch.float64)).expand((2,)).to_event(1)
    d = dist.SineSkewed(base, torch.tensor([0.3, -0.2], dtype=torch.float64))
    x = d.sample(torch.Generator().manual_seed(8), (20_000,))
    assert bool(d.support(x).all())
    assert torus_goodness_of_fit(d, x) > TEST_FAILURE_RATE
    gen = torch.Generator().manual_seed(9)
    y = soft_vmap(lambda _: d.sample(gen), torch.arange(64))
    assert y.shape == (64, 2) and len(torch.unique(y[:, 0])) == 64


def test_sine_bivariate_batched_draws_under_soft_vmap():
    d = dist.SineBivariateVonMises(_t([0.0, 1.0]), _t(0.5), _t([2.0, 5.0]), _t(3.0),
                                   correlation=_t(0.5))
    x = d.sample(torch.Generator().manual_seed(0), (7,))
    assert x.shape == (7, 2, 2) and not torch.isnan(x).any()
    gen = torch.Generator().manual_seed(1)
    y = soft_vmap(lambda _: d.sample(gen), torch.arange(16))
    assert y.shape == (16, 2, 2) and len(torch.unique(y[:, 0, 0])) == 16
