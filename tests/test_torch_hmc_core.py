"""The port's NUTS engine against the JAX package's: leapfrog, popcount, one
NUTS tick, one whole transition and the harvest sampling loop fed JAX's own
random draws, the Stan windows and a Welford step."""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax, random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.infer import hmc_core as jc
from numpyro_tpu.infer import util as jutil
from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)

# N close below a multiple of the 32768-column padding (see
# test_torch_infer_util.py); float fields to rtol 1e-5, the potential's
# precision against JAX's f32 sum
N, D, C = 30000, 5, 6
RTOL = 1e-5


def _close(t, j, rtol=RTOL, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32) * 0.05
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, D) * 20))).astype(np.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y))
    td = glm.from_numpy_glm_data(np.asarray(jd.x_t), np.asarray(jd.y_row), N, D, torch.float32)

    def jax_model(data):
        w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
        numpyro_tpu.factor("lik", jglm.bernoulli_logits_loglik(w, data))

    def torch_model(data):
        w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
        npt.factor("lik", glm.bernoulli_logits_loglik(w, data))

    j_layout = jc.FlatLayout({"w": jnp.zeros(D)})
    t_layout = core.FlatLayout({"w": torch.zeros(D)})
    j_pe = jc.batched_potential(partial(jutil.potential_energy, jax_model, (jd,), {}), j_layout)
    t_pe = core.batched_potential(partial(util.potential_energy, torch_model, (td,), {}), t_layout)
    return {
        "j_pe": j_pe, "t_pe": t_pe,
        "j_blocks": jc.build_mass_blocks(j_layout, False),
        "t_blocks": core.build_mass_blocks(t_layout, False),
    }


class JaxDraws:
    """The port's draw-source protocol, fed from JAX per-chain keys split
    exactly as the JAX engine splits them (hmc_core.py:414, :452)."""

    def __init__(self, keys):
        self.keys = keys

    def start(self, like):
        self.keys, k_mom, k_dir = jc.split_keys(self.keys, 3)
        return _t(jc.batch_normal(k_mom, like.shape[1])), _t(jc.batch_rademacher(k_dir))

    def tick(self, like):
        self.keys, k_swap, k_merge, k_dir = jc.split_keys(self.keys, 4)
        return (_t(jc.batch_uniform(k_swap)), _t(jc.batch_uniform(k_merge)),
                _t(jc.batch_rademacher(k_dir)))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _mass(c, seed=5):
    inv = np.random.default_rng(seed).uniform(0.5, 2.0, (c, D)).astype(np.float32)
    return inv, np.sqrt(1 / inv).astype(np.float32)


def _start(c, seed=1):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((c, D))).astype(np.float32)


def test_leapfrog_matches_jax(problem):
    rng = np.random.default_rng(3)
    z = _start(C)
    r = rng.standard_normal((C, D)).astype(np.float32)
    eps = rng.uniform(-0.2, 0.2, C).astype(np.float32)
    inv, _ = _mass(C)
    _, grad = problem["j_pe"](jnp.asarray(z))
    out_j = jc.leapfrog(problem["j_pe"], problem["j_blocks"], jnp.asarray(inv),
                        jnp.asarray(eps), jnp.asarray(z), jnp.asarray(r), grad)
    out_t = core.leapfrog(problem["t_pe"], problem["t_blocks"], torch.from_numpy(inv),
                          torch.from_numpy(eps), torch.from_numpy(z), torch.from_numpy(r),
                          _t(grad))
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-3)


def test_popcount_matches_jax():
    n = np.arange(1 << 11, dtype=np.int32)
    extra = np.array([-1, -2, 2**31 - 1, -(2**31), 0x55555555], np.int32)
    for vals in (n, n ^ (n + 1), extra):
        np.testing.assert_array_equal(
            core.popcount(torch.from_numpy(vals)).numpy(),
            np.asarray(lax.population_count(jnp.asarray(vals))),
        )


def _jax_carry(problem, c, ticks, step_size, max_depth=6):
    """A JAX carry after ``ticks`` ticks, so the compared tick starts mid-tree."""
    inv, sqrt = _mass(c)
    z = jnp.asarray(_start(c))
    pe, grad = problem["j_pe"](z)
    keys = random.split(random.PRNGKey(0), c)
    t = jc._init_nuts_carry(keys, z, pe, grad, problem["j_blocks"], jnp.asarray(inv),
                            jnp.asarray(sqrt), max_depth)
    for _ in range(ticks):
        t = jc._nuts_tick(t, problem["j_blocks"], problem["j_pe"], jnp.asarray(inv),
                          step_size, max_depth, 1000.0)
    return t, inv


@pytest.mark.parametrize("ticks", [0, 3, 6])
def test_one_tick_matches_jax(problem, ticks):
    step_size, max_depth = 0.15, 6
    t_j, inv = _jax_carry(problem, C, ticks, step_size, max_depth)
    t_t = core.carry_from_numpy({k: np.asarray(v) for k, v in t_j._asdict().items()})
    _, k_swap, k_merge, k_dir = jc.split_keys(t_j.key, 4)
    draws = (_t(jc.batch_uniform(k_swap)), _t(jc.batch_uniform(k_merge)),
             _t(jc.batch_rademacher(k_dir)))
    out_j = jc._nuts_tick(t_j, problem["j_blocks"], problem["j_pe"], jnp.asarray(inv),
                          step_size, max_depth, 1000.0)
    out_t = core._nuts_tick(t_t, problem["t_blocks"], problem["t_pe"], torch.from_numpy(inv),
                            step_size, max_depth, 1000.0, *draws)
    for name in core.NutsCarry._fields:
        a, b = getattr(out_t, name), np.asarray(getattr(out_j, name))
        if a.is_floating_point():
            finite = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a.numpy()), finite, err_msg=name)
            _close(a[torch.from_numpy(finite)], b[finite])
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_nuts_transition_matches_jax(problem):
    inv, sqrt = _mass(C)
    z = _start(C)
    pe_j, grad_j = problem["j_pe"](jnp.asarray(z))
    keys = random.split(random.PRNGKey(4), C)
    step_size, max_depth = 0.15, 5
    out_j = jc.nuts_transition(problem["j_pe"], problem["j_blocks"], keys, jnp.asarray(z),
                               pe_j, grad_j, jnp.asarray(inv), jnp.asarray(sqrt),
                               step_size, max_depth)
    out_t = core.nuts_transition(problem["t_pe"], problem["t_blocks"], JaxDraws(keys),
                                 torch.from_numpy(z), _t(pe_j), _t(grad_j),
                                 torch.from_numpy(inv), torch.from_numpy(sqrt),
                                 step_size, max_depth)
    assert int(np.asarray(out_j.num_steps).max()) > 3  # a real tree, not one leaf
    np.testing.assert_array_equal(out_t.num_steps.numpy(), np.asarray(out_j.num_steps))
    np.testing.assert_array_equal(out_t.diverging.numpy(), np.asarray(out_j.diverging))
    for name in ("z", "pe", "grad", "energy", "accept_prob"):
        _close(getattr(out_t, name), getattr(out_j, name), atol=1e-4)


def test_stan_windows_match_jax():
    for n in (0, 10, 19, 20, 50, 100, 150, 200, 300, 1000):
        assert core.stan_windows(n) == jc.stan_windows(n)
        for a, b in zip(core._window_masks(n), jc._window_masks(n)):
            np.testing.assert_array_equal(a, b)


def test_welford_step_and_finalize_match_jax():
    rng = np.random.default_rng(6)
    blocks = jc.build_mass_blocks(jc.FlatLayout({"w": jnp.zeros(D)}), False)
    t_blocks = core.build_mass_blocks(core.FlatLayout({"w": torch.zeros(D)}), False)
    wf_j = jc._welford_init(blocks, C, jnp.float32)
    wf_t = core._welford_init(t_blocks, C, torch.zeros(()))
    for _ in range(7):
        z = rng.standard_normal((C, D)).astype(np.float32)
        wf_j = jc._welford_update(blocks, wf_j, jnp.asarray(z))
        wf_t = core._welford_update(t_blocks, wf_t, torch.from_numpy(z))
    for a, b in zip(wf_t, wf_j):
        _close(a, b, rtol=1e-6)
    for a, b in zip(core._welford_finalize(t_blocks, wf_t), jc._welford_finalize(blocks, wf_j)):
        _close(a, b, rtol=1e-6)


def test_step_size_search_settles(problem):
    inv, sqrt = np.ones((C, D), np.float32), np.ones((C, D), np.float32)
    z = torch.from_numpy(_start(C))
    pe, grad = problem["t_pe"](z)
    ss = core.batched_step_size_search(
        problem["t_pe"], problem["t_blocks"], core.GeneratorDraws(torch.Generator().manual_seed(0)),
        z, pe, grad, torch.from_numpy(inv), torch.from_numpy(sqrt), 1.0,
    )
    assert ss.shape == (C,) and bool((ss > 0).all()) and bool((ss < 1.0).all())


def test_harvest_sampling_matches_jax(problem):
    """The asynchronous harvest loop from the same state and the same draws
    banks the same draws as JAX's (its loop checks every tick, the port's
    every ``CHECK_EVERY`` ticks)."""
    inv, sqrt = _mass(C)
    z = _start(C)
    pe_j, grad_j = problem["j_pe"](jnp.asarray(z))
    keys = random.split(random.PRNGKey(7), C)
    samples, step = 12, np.full(C, 0.15, np.float32)
    zero = np.zeros(C, np.float32)
    run_j = jc.build_fused_run(problem["j_pe"], problem["j_blocks"], algo="NUTS",
                               num_warmup=0, num_samples=samples, max_depth=5)
    adapt_j = jc.AdaptPanel(jnp.asarray(step), jnp.asarray(inv), jnp.asarray(sqrt),
                            jnp.asarray(1 / sqrt), *([jnp.asarray(zero)] * 5),
                            jnp.asarray(inv), jnp.asarray(inv), jnp.asarray(zero), None)
    out_j = run_j.sample(keys, jnp.asarray(z), pe_j, grad_j, adapt_j)
    run_t = core.build_fused_run(problem["t_pe"], problem["t_blocks"], num_warmup=0,
                                 num_samples=samples, max_depth=5)
    adapt_t = core.AdaptPanel(torch.from_numpy(step), torch.from_numpy(inv),
                              torch.from_numpy(sqrt), torch.from_numpy(1 / sqrt),
                              *([torch.from_numpy(zero)] * 5), None, None, None)
    out_t = run_t.sample(JaxDraws(keys), torch.from_numpy(z), _t(pe_j), _t(grad_j), adapt_t)
    assert out_t["samples_z"].shape == (C, samples, D)
    for name in ("num_steps", "diverging"):
        np.testing.assert_array_equal(out_t["extras"][name].numpy(),
                                      np.asarray(out_j["extras"][name]))
    _close(out_t["samples_z"], out_j["samples_z"], atol=1e-4)
    _close(out_t["extras"]["energy"], out_j["extras"]["energy"])
    # accept statistics are exp(-(H - H0)) with H ~ 2e4 here: JAX's f32 sum
    # of the potential carries ~1e-3 of absolute error into H - H0 (2e-3
    # relative on the statistics of this problem)
    for name in ("accept_prob", "mean_accept_prob"):
        _close(out_t["extras"][name], out_j["extras"][name], rtol=1e-2)
