"""A degenerate ensemble (every walker equal in one coordinate) and
degenerate subposteriors in the port against the JAX package: the AIES
moves (``DEMove``, ``StretchMove``), the ESS moves that factor a covariance
(``GaussianMove``, ``KDEMove``), ``gaussian_kde`` and ``parametric``,
``parametric_draws`` and ``consensus``.  Where a covariance is singular the
JAX package's ``cholesky`` and ``inv`` give NaN (and inf), and so does the
port, NaN pattern included, without raising.  One step of each kernel from a
JAX state on JAX's draws (``test_torch_kernels``'s draw queues); finite
values to rtol 1e-5 beside the atol given at each comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.stats as jstats
from jax import random

from numpyro_tpu.infer import AIES as JAIES, ESS as JESS
from numpyro_tpu.infer import hmc_util as jhu
from numpyro_tpu_torch.infer import AIES, ESS
from numpyro_tpu_torch.infer import hmc_util as hu
from numpyro_tpu_torch.infer.ensemble import ensemble_state_from_numpy, gaussian_kde

from test_torch_kernels import D, QueueDraws, _aies_half_draws, _ess_half_draws

torch.set_num_threads(1)

SCALES = (1.0, 4.0, 0.25)


def _same(got, want, atol, what=""):
    """Equal NaN and inf patterns, and the finite entries within rtol 1e-5."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN pattern")
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=f"{what}: inf pattern")
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=atol, err_msg=what)


def _degenerate_ensemble():
    """Eight walkers, all at 0.7 in the second coordinate."""
    z = np.random.default_rng(3).standard_normal((8, D)).astype(np.float32)
    z[:, 1] = 0.7
    return z


def _pe_j(x):
    return 0.5 * jnp.sum(x**2 / jnp.array(SCALES))


def _pe_t(x):
    return 0.5 * (x**2 / torch.tensor(SCALES)).sum()


@pytest.mark.parametrize("moves", ["de", "stretch"])
def test_aies_step_on_a_degenerate_ensemble_matches_jax(moves):
    z0 = _degenerate_ensemble()
    move_j = {"de": JAIES.DEMove, "stretch": JAIES.StretchMove}[moves]()
    move_t = {"de": AIES.DEMove, "stretch": AIES.StretchMove}[moves]()
    k_j = JAIES(potential_fn=_pe_j, moves={move_j: 1.0})
    k_t = AIES(potential_fn=_pe_t, moves={move_t: 1.0})
    s_j = k_j.init(random.split(random.PRNGKey(4), 8), 2, jnp.asarray(z0), (), {})
    k_t.init(torch.Generator().manual_seed(0), 2, torch.from_numpy(z0), (), {}, num_chains=8)
    step_j = jax.jit(lambda s: k_j.sample(s, (), {}))
    for _ in range(2):
        inner = QueueDraws()
        key = s_j.inner_state.rng_key
        for _half in range(2):
            key, items = _aies_half_draws(key, k_j._moves, moves, 4, 4, D)
            inner.items += items
        s_t = ensemble_state_from_numpy(jax.tree.map(np.asarray, s_j), rng_key=QueueDraws(),
                                        inner_rng_key=inner)
        s_j = step_j(s_j)
        s_t = k_t.sample(s_t, (), {})
        assert not inner.items
        _same(s_t.z, s_j.z, 1e-5, "z")
        _same(s_t.inner_state.accept_prob, s_j.inner_state.accept_prob, 1e-6, "accept_prob")
    # the walkers keep their common coordinate: the moves span the differences
    np.testing.assert_array_equal(np.asarray(s_j.z)[:, 1], np.float32(0.7))


@pytest.mark.parametrize("which", ["gaussian", "kde"])
def test_ess_step_on_a_degenerate_ensemble_matches_jax(which):
    """The moves factor a singular covariance: the directions are NaN in
    both packages, and so is every walker the step moves."""
    z0 = _degenerate_ensemble()
    mv_j = {"gaussian": JESS.GaussianMove, "kde": JESS.KDEMove}[which]()
    mv_t = {"gaussian": ESS.GaussianMove, "kde": ESS.KDEMove}[which]()
    k_j = JESS(potential_fn=_pe_j, moves={mv_j: 1.0})
    k_t = ESS(potential_fn=_pe_t, moves={mv_t: 1.0})
    s_j = k_j.init(random.split(random.PRNGKey(5), 8), 2, jnp.asarray(z0), (), {})
    k_t.init(torch.Generator().manual_seed(0), 2, torch.from_numpy(z0), (), {}, num_chains=8)
    _, shuffle_key = random.split(s_j.rng_key)
    perm = random.permutation(shuffle_key, 8)
    panel = np.asarray(s_j.z)[np.asarray(perm)]
    key = s_j.inner_state.rng_key
    key, items1 = _ess_half_draws(key, which, panel[4:], s_j.inner_state.mu, 4)
    refreshed, _ = k_j.update_active_chains(jnp.asarray(panel[:4]), jnp.asarray(panel[4:]),
                                            s_j.inner_state)
    key, items2 = _ess_half_draws(key, which, np.asarray(refreshed), None, 4)
    inner = QueueDraws(items1 + items2)
    s_t = ensemble_state_from_numpy(jax.tree.map(np.asarray, s_j),
                                    rng_key=QueueDraws([("permutations", perm)]),
                                    inner_rng_key=inner)
    s_j = jax.jit(lambda s: k_j.sample(s, (), {}))(s_j)
    s_t = k_t.sample(s_t, (), {})
    assert np.isnan(np.asarray(s_j.z)).any()
    _same(s_t.z, s_j.z, 1e-4, "z")
    for field in ("n_expansions", "n_contractions"):
        assert int(getattr(s_t.inner_state, field)) == int(getattr(s_j.inner_state, field))
    _same(s_t.inner_state.mu, s_j.inner_state.mu, 1e-6, "mu")


def test_gaussian_kde_of_a_degenerate_dataset_matches_jax():
    data = np.random.default_rng(6).standard_normal((3, 40)).astype(np.float32)
    data[1] = 0.0  # an exactly singular covariance
    points = np.random.default_rng(7).standard_normal((3, 5)).astype(np.float32)
    k_j = jstats.gaussian_kde(jnp.asarray(data))
    k_t = gaussian_kde(torch.from_numpy(data))
    _same(k_t.inv_cov, k_j.inv_cov, 1e-4, "inv_cov")
    _same(k_t.logpdf(torch.from_numpy(points)), k_j.logpdf(jnp.asarray(points)), 1e-5, "logpdf")
    key = random.PRNGKey(7)
    ind_key, eps_key = random.split(key)
    draws = QueueDraws([
        ("categorical", random.choice(ind_key, 40, shape=(6,), p=k_j.weights)),
        ("normals", random.normal(eps_key, (6, 3))),
    ])
    _same(k_t.resample(draws, (6,)), k_j.resample(key, (6,)), 1e-5, "resample")


def _degenerate_subposteriors(n_sub=3, n_draw=500):
    subs = []
    for i, k in enumerate(random.split(random.PRNGKey(0), n_sub)):
        w = np.array(jnp.array([1.0 + 0.01 * i, 0.0]) + 0.3 * random.normal(k, (n_draw, 2)))
        w[:, 1] = 0.0  # every draw of every subposterior equal in the second coordinate
        subs.append({"w": w.astype(np.float32)})
    return subs


def test_parametric_and_consensus_of_degenerate_subposteriors_match_jax():
    subs = _degenerate_subposteriors()
    jsubs = [{k: jnp.asarray(v) for k, v in s.items()} for s in subs]
    tsubs = [{k: torch.from_numpy(v) for k, v in s.items()} for s in subs]
    for got, want in zip(hu.parametric(tsubs), jhu.parametric(jsubs)):
        _same(got, want, 1e-6, "parametric")
    key = random.PRNGKey(3)
    want = np.asarray(jhu.parametric_draws(jsubs, 50, rng_key=key)["w"])
    noise = np.asarray(random.normal(key, (50, 2)))
    got = hu.parametric_draws(tsubs, 50, rng_key=QueueDraws([("normals", noise)]))["w"]
    assert np.isnan(want).any()
    _same(got, want, 1e-5, "parametric_draws")
    want = np.asarray(jhu.consensus(jsubs, num_draws=20, rng_key=key)["w"])
    pick = np.asarray(random.randint(key, (20,), 0, 500))
    got = hu.consensus(tsubs, num_draws=20, rng_key=QueueDraws([("randints", pick)]))["w"]
    _same(got, want, 1e-5, "consensus")
