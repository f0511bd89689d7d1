"""Dense and structured mass matrices through the port's samplers: whole
``MCMC`` runs (the fused run and the per-step loop), ``post_warmup_state``,
``init(inverse_mass_matrix=...)``, and one HMCECS transition with a dense inner
NUTS from a JAX state on JAX's draws (float fields to the rtol and atol given
at each comparison)."""

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
from numpyro_tpu.infer import HMCECS as JHMCECS, NUTS as JNUTS
from numpyro_tpu_torch.infer import HMCECS, MCMC, NUTS
from numpyro_tpu_torch.infer import hmc as thmc
from numpyro_tpu_torch.infer.hmc_gibbs import ecs_state_from_numpy

# draw sources fed from JAX's keys, split as the JAX engine splits them
from test_torch_hmc_gibbs import REF, JaxEcsDraws
from test_torch_hmc_step import JaxDraws
from test_torch_dense_mass import C, _close, _close_tree

torch.set_num_threads(1)

D2 = 5
_A = np.random.RandomState(0).randn(D2, D2)
COV = _A @ _A.T + 0.1 * np.eye(D2)  # the target of tests/infer/test_mcmc.py:36-58
PREC = torch.from_numpy(np.linalg.inv(COV).astype(np.float32))


def _gauss(z):
    return 0.5 * z["z"] @ PREC @ z["z"]


def test_dense_mass_recovers_a_correlated_gaussian():
    """The JAX test's target and tolerances (means within 0.3, stds to 15%),
    pooled over 32 chains; the adapted inverse mass is near the covariance."""
    mcmc = MCMC(NUTS(potential_fn=_gauss, dense_mass=True, max_tree_depth=(5, 6)),
                num_warmup=60, num_samples=40, num_chains=32, device="cpu")
    mcmc.run(0, init_params={"z": torch.zeros(32, D2)})
    draws = mcmc.get_samples()["z"].double().numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(D2), atol=0.3)
    np.testing.assert_allclose(draws.std(0), np.sqrt(np.diag(COV)), rtol=0.15)
    inv = mcmc.last_state.adapt_state.inverse_mass_matrix
    assert inv.shape == (32, D2, D2)
    dist_rel = np.linalg.norm(inv.double().mean(0).numpy() - COV) / np.linalg.norm(COV)
    assert dist_rel < 0.5, dist_rel


def _two_site_model():
    x = npt.sample("x", dist.Normal(torch.zeros(3), torch.tensor([1.0, 2.0, 0.5])).to_event(1))
    npt.sample("s", dist.HalfNormal(1.0))
    npt.sample("obs", dist.Normal(x.sum(), 1.0), obs=torch.tensor(0.5))


def _check_dict_mass(adapt, c):
    for field in ("inverse_mass_matrix", "mass_matrix_sqrt", "mass_matrix_sqrt_inv"):
        m = getattr(adapt, field)
        assert set(m) == {("x",), ("s",)}, field
        assert m[("x",)].shape == (c, 3, 3) and m[("s",)].shape == (c, 1), field
    assert set(adapt.wf_m2) == {("x",), ("s",)} and adapt.wf_m2[("x",)].shape == (c, 3, 3)


@pytest.mark.parametrize("api", ["fused", "per-step"])
def test_structured_mass_through_mcmc(api):
    """``dense_mass=[("x",)]``: the exposed mass on ``last_state`` is a dict
    keyed by site tuples, from the fused run and from the per-step loop."""
    extra = ("potential_energy",) if api == "per-step" else ()
    mcmc = MCMC(NUTS(_two_site_model, dense_mass=[("x",)], max_tree_depth=4), num_warmup=40,
                num_samples=20, num_chains=4, device="cpu")
    mcmc.run(1, extra_fields=extra)
    _check_dict_mass(mcmc.last_state.adapt_state, 4)
    assert mcmc.get_samples(group_by_chain=True)["x"].shape == (4, 20, 3)


def test_post_warmup_state_resumes_with_the_dict_mass():
    """``warmup`` then ``run``: the second run starts from
    ``post_warmup_state`` with its dict mass intact, and keeps it."""
    mcmc = MCMC(NUTS(_two_site_model, dense_mass=[("x",)], max_tree_depth=4), num_warmup=40,
                num_samples=20, num_chains=4, device="cpu")
    mcmc.warmup(1)
    warm = mcmc.post_warmup_state.adapt_state
    _check_dict_mass(warm, 4)
    mcmc.run(2)
    assert mcmc.get_samples(group_by_chain=True)["x"].shape == (4, 20, 3)
    resumed = mcmc.last_state.adapt_state
    _check_dict_mass(resumed, 4)
    for k in warm.inverse_mass_matrix:
        assert torch.equal(resumed.inverse_mass_matrix[k], warm.inverse_mass_matrix[k])


def test_init_takes_an_inverse_mass_matrix_as_jax_does():
    """``NUTS(inverse_mass_matrix=...)`` and the factory's
    ``init(inverse_mass_matrix=...)``: a dict keyed by site tuples, a 1-d
    diagonal for a dense block, broadcast over chains."""
    given = {("x",): np.array([1.0, 4.0, 0.25], np.float32), ("s",): np.array([0.5], np.float32)}
    kernel = NUTS(_two_site_model, dense_mass=[("x",)], inverse_mass_matrix=given,
                  adapt_mass_matrix=False)
    state = kernel.init(torch.Generator().manual_seed(0), 5, num_chains=2)
    inv = state.adapt_state.inverse_mass_matrix
    np.testing.assert_array_equal(inv[("x",)][1].numpy(), np.diag(given[("x",)]))
    np.testing.assert_array_equal(inv[("s",)].numpy(), np.full((2, 1), 0.5, np.float32))
    np.testing.assert_allclose(state.adapt_state.mass_matrix_sqrt[("x",)][0].numpy(),
                               np.diag([1.0, 0.5, 2.0]), rtol=1e-6)
    for _ in range(3):
        state = kernel.sample(state, (), {})
    assert torch.equal(state.adapt_state.inverse_mass_matrix[("x",)], inv[("x",)])
    init, sample = thmc.hmc(potential_fn=_gauss)
    s = init({"z": torch.zeros(D2)}, 3, rng_key=torch.Generator().manual_seed(0),
             dense_mass=True, inverse_mass_matrix=COV.astype(np.float32))
    np.testing.assert_allclose(s.adapt_state.inverse_mass_matrix.numpy(), COV, rtol=1e-6)
    assert s.adapt_state.mass_matrix_sqrt.shape == (D2, D2)  # one chain: no chain axis
    s = sample(s)
    assert s.z["z"].shape == (D2,)


# ---------------------------------------------------------------------------
# HMCECS with a dense inner NUTS, from a JAX state on JAX's draws

N, D, M, BLOCKS = 2000, 3, 100, 10


def jax_ecs_model(X, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    b = numpyro_tpu.sample("b", jdist.Normal(0.0, 1.0))
    with numpyro_tpu.plate("N", X.shape[0], subsample_size=M):
        xb = numpyro_tpu.subsample(X, event_dim=1)
        yb = numpyro_tpu.subsample(y, event_dim=0)
        numpyro_tpu.sample("obs", jdist.Bernoulli(logits=xb @ w + b), obs=yb)


def torch_ecs_model(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    b = npt.sample("b", dist.Normal(0.0, 1.0))
    with npt.plate("N", X.shape[0], subsample_size=M):
        xb = npt.subsample(X, event_dim=1)
        yb = npt.subsample(y, event_dim=0)
        npt.sample("obs", dist.Bernoulli(logits=xb @ w + b), obs=yb)


def test_one_hmcecs_transition_with_dense_inner_nuts_matches_jax():
    """The inner NUTS runs under a structured mass (a dense ``w`` block and a
    diagonal ``b`` one) carried in a dict from JAX's state."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ REF - 0.3))).astype(np.float32)
    args_j, args_t = (jnp.asarray(X), jnp.asarray(y)), (torch.from_numpy(X), torch.from_numpy(y))
    ref = {"w": REF, "b": np.float32(0.3)}
    k_j = JHMCECS(JNUTS(jax_ecs_model, dense_mass=[("w",)], max_tree_depth=4), num_blocks=BLOCKS,
                  proxy=JHMCECS.taylor_proxy(ref))
    k_t = HMCECS(NUTS(torch_ecs_model, dense_mass=[("w",)], max_tree_depth=4), num_blocks=BLOCKS,
                 proxy=HMCECS.taylor_proxy(ref))
    # warmup of 20: its one window end (step 17) gives a dense estimate
    s_j = k_j.init(random.split(random.PRNGKey(0), C), 20, None, args_j, {})
    k_t.init(torch.Generator().manual_seed(0), 20, None, args_t, {}, num_chains=C)
    step_j = jax.jit(lambda s: k_j.sample(s, args_j, {}))
    for _ in range(18):
        s_j = step_j(s_j)
    inv_j = s_j.hmc_state.adapt_state.inverse_mass_matrix
    assert set(inv_j) == {("w",), ("b",)} and inv_j[("w",)].shape == (C, D, D)
    s_t = ecs_state_from_numpy(jax.tree.map(np.asarray, s_j), device="cpu")
    inv_t = s_t.hmc_state.adapt_state.inverse_mass_matrix
    assert set(inv_t) == {("w",), ("b",)} and inv_t[("w",)].shape == (C, D, D)
    s_t = s_t._replace(
        rng_key=JaxEcsDraws(s_j.rng_key),
        hmc_state=s_t.hmc_state._replace(rng_key=JaxDraws(s_j.hmc_state.rng_key)),
    )
    s_j = step_j(s_j)
    s_t = k_t.sample(s_t, args_t, {})
    np.testing.assert_array_equal(s_t.z["N"].numpy(), np.asarray(s_j.z["N"]))
    h_t, h_j = s_t.hmc_state, s_j.hmc_state
    np.testing.assert_array_equal(h_t.num_steps.numpy(), np.asarray(h_j.num_steps))
    for name in ("w", "b"):
        _close(h_t.z[name], h_j.z[name], rtol=1e-4, atol=1e-5)
    _close(h_t.potential_energy, h_j.potential_energy, rtol=1e-4)
    for name in ("inverse_mass_matrix", "mass_matrix_sqrt"):
        _close_tree(getattr(h_t.adapt_state, name), getattr(h_j.adapt_state, name), rtol=1e-4,
                    atol=1e-5)


def test_hmcecs_with_forward_mode_inner_nuts_matches_reverse_mode():
    """``HMCECS(NUTS(..., forward_mode_differentiation=True))``: the block
    update's gradient and the inner trajectory take ``jacfwd``, and from one
    generator state two transitions give what reverse mode gives (rtol 1e-5)."""
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    y = torch.from_numpy((rng.random(N) < 0.5).astype(np.float32))
    out = {}
    for forward in (False, True):
        kernel = HMCECS(NUTS(torch_ecs_model, dense_mass=True, max_tree_depth=3,
                             forward_mode_differentiation=forward),
                        num_blocks=BLOCKS, proxy=HMCECS.taylor_proxy({"w": REF, "b": 0.0}))
        state = kernel.init(torch.Generator().manual_seed(0), 4, None, (X, y), {}, num_chains=C)
        for _ in range(2):
            state = kernel.sample(state, (X, y), {})
        out[forward] = state
    rev, fwd = out[False], out[True]
    assert torch.equal(rev.z["N"], fwd.z["N"])
    assert torch.equal(rev.hmc_state.num_steps, fwd.hmc_state.num_steps)
    for name in ("w", "b"):
        torch.testing.assert_close(fwd.hmc_state.z[name], rev.hmc_state.z[name], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(fwd.hmc_state.z_grad[name], rev.hmc_state.z_grad[name],
                                   rtol=1e-5, atol=1e-4)
