"""``infer/hmc_util.py`` of the port against the JAX package's: each case of
``tests/infer/test_hmc_util.py`` on the same numpy inputs (and JAX's draws
where the function draws), then the one-chain integrator, step-size search
and warmup adapter.  Tolerances: rtol 1e-5 against JAX (the port's dual
averaging and Welford updates are the engine's arithmetic, which differs
from JAX's in the last bits), beside each test's own gate against the
truth."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

from numpyro_tpu.infer import hmc_util as jhu
from numpyro_tpu_torch.infer import hmc_core
from numpyro_tpu_torch.infer import hmc_util as hu

from test_torch_kernels import QueueDraws

torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_dual_averaging_converges_as_jax():
    init_j, update_j = jhu.dual_averaging(gamma=0.5)
    init_t, update_t = hu.dual_averaging(gamma=0.5)
    state_j, state_t = init_j(0.0), init_t(0.0)
    for _ in range(150):
        state_j = update_j(2 * (state_j.x_t - 1.0), state_j)
        state_t = update_t(2 * (state_t.x_t - 1.0), state_t)
        _close(state_t.x_avg, state_j.x_avg)
        _close(state_t.g_avg, state_j.g_avg)
    assert int(state_t.t) == int(state_j.t) == 150
    assert abs(float(state_t.x_avg) - 1.0) < 0.1


@pytest.mark.parametrize("diagonal", [True, False], ids=["diagonal", "dense"])
def test_welford_matches_jax(diagonal):
    rng = np.random.RandomState(0)
    cov = np.array([[1.5, 0.6], [0.6, 0.9]])
    samples = rng.multivariate_normal(np.zeros(2), cov, size=4000).astype(np.float32)
    init_j, update_j, final_j = jhu.welford_covariance(diagonal=diagonal)
    init_t, update_t, final_t = hu.welford_covariance(diagonal=diagonal)
    state_j, state_t = init_j(2), init_t(2)
    update_j = jax.jit(update_j)
    for s in samples:
        state_j = update_j(jnp.asarray(s), state_j)
        state_t = update_t(torch.from_numpy(s), state_t)
    for regularize in (False, True):
        for got, want in zip(final_t(state_t, regularize), final_j(state_j, regularize)):
            _close(got, want, rtol=1e-4)
    estimate = final_t(state_t, regularize=False)[0].numpy()
    np.testing.assert_allclose(estimate, np.diag(cov) if diagonal else cov, rtol=0.1)


def test_welford_dict_blocks_match_jax():
    rng = np.random.default_rng(1)
    init_j, update_j, final_j = jhu.welford_covariance(diagonal=False)
    init_t, update_t, final_t = hu.welford_covariance(diagonal=False)
    sizes = {("a", "b"): (3, 3)}
    state_j, state_t = init_j(sizes), init_t(sizes)
    for _ in range(50):
        a = rng.standard_normal(2).astype(np.float32)
        b = np.float32(rng.standard_normal())
        state_j = update_j({"a": jnp.asarray(a), "b": jnp.asarray(b)}, state_j)
        state_t = update_t({"a": torch.from_numpy(a), "b": torch.tensor(b)}, state_t)
    for got, want in zip(final_t(state_t, True), final_j(state_j, True)):
        _close(got[("a", "b")], want[("a", "b")], rtol=1e-4)


@pytest.mark.parametrize("num_steps", [10, 19, 20, 150, 1000, 2345])
def test_adaptation_schedule_matches_jax(num_steps):
    got = hu.build_adaptation_schedule(num_steps)
    assert got == [tuple(w) for w in jhu.build_adaptation_schedule(num_steps)]
    if num_steps == 1000:
        assert got[0] == (0, 74) and got[-1] == (950, 999)
        widths = [w.end - w.start + 1 for w in got[1:-1]]
        assert all(b == 2 * a for a, b in zip(widths, widths[1:-1]))
    if num_steps == 10:
        assert got == [(0, 9)]


def _subposteriors(key, n_sub=4, n_draw=3000):
    subs = []
    for i, k in enumerate(random.split(key, n_sub)):
        mean = jnp.array([1.0 + 0.01 * i, -0.5 - 0.01 * i])
        subs.append({"w": np.asarray(mean + 0.3 * random.normal(k, (n_draw, 2)))})
    return subs


def _torch_subs(subs):
    return [{k: torch.from_numpy(np.array(v)) for k, v in s.items()} for s in subs]


@pytest.mark.parametrize("diagonal", [False, True], ids=["full", "diagonal"])
def test_consensus_matches_jax(diagonal):
    subs = _subposteriors(random.PRNGKey(0))
    key = random.PRNGKey(1)
    want = np.asarray(jhu.consensus([{k: jnp.asarray(v) for k, v in s.items()} for s in subs],
                                    num_draws=2000, diagonal=diagonal, rng_key=key)["w"])
    pick = np.asarray(random.randint(key, (2000,), 0, 3000))
    got = hu.consensus(_torch_subs(subs), num_draws=2000, diagonal=diagonal,
                       rng_key=QueueDraws([("randints", pick)]))["w"].numpy()
    assert got.shape == (2000, 2)
    _close(got, want, rtol=1e-4, atol=1e-5)
    assert np.allclose(got.mean(0), [1.015, -0.515], atol=0.05)


def test_parametric_merging_and_draws_match_jax():
    subs = _subposteriors(random.PRNGKey(2))
    jsubs = [{k: jnp.asarray(v) for k, v in s.items()} for s in subs]
    for diagonal in (False, True):
        for got, want in zip(hu.parametric(_torch_subs(subs), diagonal=diagonal),
                             jhu.parametric(jsubs, diagonal=diagonal)):
            _close(got, want, rtol=1e-4, atol=1e-6)
    mean, cov = hu.parametric(_torch_subs(subs))
    assert np.allclose(mean.numpy(), [1.015, -0.515], atol=0.05)
    assert np.allclose(np.diag(cov.numpy()), 0.0225, rtol=0.2)
    key = random.PRNGKey(3)
    for diagonal in (False, True):
        want = np.asarray(jhu.parametric_draws(jsubs, 1500, diagonal=diagonal, rng_key=key)["w"])
        noise = np.asarray(random.normal(key, (1500, 2)))
        got = hu.parametric_draws(_torch_subs(subs), 1500, diagonal=diagonal,
                                  rng_key=QueueDraws([("normals", noise)]))["w"].numpy()
        _close(got, want, rtol=1e-4, atol=1e-5)
    assert np.allclose(got.std(0), np.sqrt(0.0225), rtol=0.2)


# ---------------------------------------------------------------------------
# The one-chain integrator, step-size search and warmup adapter

PREC = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.5]], np.float32)


def pe_j(z):
    x = jnp.concatenate([z["a"], z["b"][None]])
    return 0.5 * x @ jnp.asarray(PREC) @ x


def pe_t(z):
    x = torch.cat([z["a"], z["b"][None]])
    return 0.5 * x @ torch.from_numpy(PREC) @ x


Z0 = {"a": np.array([0.4, -1.2], np.float32), "b": np.array(0.7, np.float32)}
R0 = {"a": np.array([-0.3, 0.8], np.float32), "b": np.array(1.1, np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("mass", ["diagonal", "dense", "blocks"])
def test_velocity_verlet_matches_jax(mass):
    inv_np = {
        "diagonal": np.array([1.0, 0.5, 2.0], np.float32),
        "dense": np.array([[1.0, 0.2, 0.0], [0.2, 0.8, 0.1], [0.0, 0.1, 1.5]], np.float32),
    }
    if mass == "blocks":
        inv_j = {("a",): jnp.asarray(inv_np["dense"][:2, :2]), ("b",): jnp.asarray([2.0])}
        inv_t = {("a",): torch.from_numpy(inv_np["dense"][:2, :2]), ("b",): torch.tensor([2.0])}
    else:
        inv_j, inv_t = jnp.asarray(inv_np[mass]), torch.from_numpy(inv_np[mass])
    init_j, update_j = jhu.velocity_verlet(pe_j, jhu.euclidean_kinetic_energy)
    init_t, update_t = hu.velocity_verlet(pe_t, hu.euclidean_kinetic_energy)
    state_j, state_t = init_j(_j(Z0), _j(R0)), init_t(_t(Z0), _t(R0))
    for _ in range(5):
        state_j = update_j(0.3, inv_j, state_j)
        state_t = update_t(0.3, inv_t, state_t)
    for field in ("z", "r", "z_grad"):
        for k in Z0:
            _close(getattr(state_t, field)[k], getattr(state_j, field)[k])
    _close(state_t.potential_energy, state_j.potential_energy)
    _close(hu.euclidean_kinetic_energy(inv_t, state_t.r),
           jhu.euclidean_kinetic_energy(inv_j, state_j.r))


def test_find_reasonable_step_size_matches_jax():
    inv = np.array([1.0, 1.0, 1.0], np.float32)
    key = random.PRNGKey(5)

    def momentum_j(z, inverse_mass_matrix, rng_key):
        return {"a": random.normal(rng_key, (2,)), "b": random.normal(random.fold_in(rng_key, 1))}

    # JAX splits its key once a probe; the port takes the same momenta in order
    momenta, k = [], key
    for _ in range(40):
        k, k_r = random.split(k)
        momenta.append({n: np.asarray(v) for n, v in momentum_j(None, None, k_r).items()})
    queue = iter(momenta)

    def momentum_t(z, inverse_mass_matrix, draws):
        return _t(next(queue))

    for init_step in (1e-3, 0.4, 30.0):
        queue = iter(momenta)
        pe, grad = jax.value_and_grad(pe_j)(_j(Z0))
        want = jhu.find_reasonable_step_size(
            pe_j, jhu.euclidean_kinetic_energy, momentum_j, init_step, jnp.asarray(inv),
            (_j(Z0), None, pe, grad), key)
        grad_t, pe_t_ = torch.func.grad_and_value(pe_t)(_t(Z0))
        got = hu.find_reasonable_step_size(
            pe_t, hu.euclidean_kinetic_energy, momentum_t, init_step, torch.from_numpy(inv),
            (_t(Z0), None, pe_t_, grad_t), torch.Generator().manual_seed(0))
        np.testing.assert_allclose(got, float(want), rtol=RTOL)


@pytest.mark.parametrize("dense_mass", [False, True])
def test_warmup_adapter_matches_jax(dense_mass):
    num_adapt = 60
    init_j, update_j = jhu.warmup_adapter(num_adapt, dense_mass=dense_mass)
    init_t, update_t = hu.warmup_adapter(num_adapt, dense_mass=dense_mass)
    z_info_j = (_j(Z0), None, None, None)
    z_info_t = (_t(Z0), None, None, None)
    state_j = init_j(z_info_j, random.PRNGKey(0), step_size=0.5)
    state_t = init_t(z_info_t, torch.Generator().manual_seed(0), step_size=0.5)
    update_j = jax.jit(update_j)
    rng = np.random.default_rng(0)
    for t in range(num_adapt):
        z = {"a": rng.standard_normal(2).astype(np.float32) * [1.0, 2.0],
             "b": np.float32(rng.standard_normal() * 0.5)}
        z = {k: np.asarray(v, np.float32) for k, v in z.items()}
        accept = np.float32(rng.random())
        state_j = update_j(t, jnp.asarray(accept), (_j(z), None, None, None), state_j)
        state_t = update_t(t, torch.tensor(accept), (_t(z), None, None, None), state_t)
        _close(state_t.step_size, state_j.step_size, rtol=1e-4)
        _close(state_t.inverse_mass_matrix, state_j.inverse_mass_matrix, rtol=1e-4)
        assert int(state_t.window_idx) == int(state_j.window_idx)
    _close(state_t.mass_matrix_sqrt, state_j.mass_matrix_sqrt, rtol=1e-4)
    _close(state_t.mass_matrix_sqrt_inv, state_j.mass_matrix_sqrt_inv, rtol=1e-4)


def test_engine_shares_the_adaptation_arithmetic():
    """``hmc_core.build_warmup``'s dual averaging and Welford updates are
    the functions this module wraps: one copy serves both."""
    g, count = torch.tensor([0.1, -0.2]), torch.tensor([3.0, 3.0])
    x_t, x_avg, g_avg, t = hmc_core.dual_averaging_step(
        g, count, torch.tensor([0.05, 0.0]), torch.tensor([0.2, 0.1]), torch.tensor([0.0, 0.5]))
    state = hu.dual_averaging()[1](g[0], hu.DualAveragingState(
        torch.tensor(0.0), torch.tensor(0.2), torch.tensor(0.05), torch.tensor(3),
        torch.tensor(0.0)))
    assert float(state.x_t) == float(x_t[0]) and float(state.x_avg) == float(x_avg[0])
    assert int(state.t) == 4 and float(t[0]) == 4.0
