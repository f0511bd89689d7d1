"""``HMCGibbs`` and ``HMCECS`` of the port: a conjugate Gibbs conditional,
one ECS transition from a JAX state and on JAX's draws (state fields to rtol
1e-4), and whole runs in every panel and proxy mode against a JAX run and
against full-data NUTS (posterior means within four standard errors)."""

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
from numpyro_tpu.contrib import ecs_proxies as jecs
from numpyro_tpu.infer import HMCECS as JHMCECS, MCMC as JMCMC, NUTS as JNUTS
from numpyro_tpu.infer import hmc_core as jc
from numpyro_tpu_torch.contrib.ecs_proxies import subsample_estimator
from numpyro_tpu_torch.diagnostics import effective_sample_size
from numpyro_tpu_torch.infer import HMC, HMCECS, MCMC, NUTS, HMCGibbs
from numpyro_tpu_torch.infer.hmc_gibbs import HMCECSState, ecs_state_from_numpy

# the inner NUTS kernel's draws from JAX's keys
from test_torch_hmc_step import JaxDraws as JaxInnerDraws

torch.set_num_threads(1)

N, D, M, BLOCKS, C = 2000, 3, 100, 10, 4
BS = M // BLOCKS
REF = np.array([0.7, -0.4, 0.9], np.float32)


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ REF))).astype(np.float32)
    return X, y


def jax_model(X, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    with numpyro_tpu.plate("N", X.shape[0], subsample_size=M):
        xb = numpyro_tpu.subsample(X, event_dim=1)
        yb = numpyro_tpu.subsample(y, event_dim=0)
        numpyro_tpu.sample("obs", jdist.Bernoulli(logits=xb @ w), obs=yb)


def torch_model(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    with npt.plate("N", X.shape[0], subsample_size=M):
        xb = npt.subsample(X, event_dim=1)
        yb = npt.subsample(y, event_dim=0)
        npt.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)


def full_model(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    with npt.plate("N", X.shape[0]):
        npt.sample("obs", dist.Bernoulli(logits=X @ w), obs=y)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# ---------------------------------------------------------------------------
# HMCGibbs


def test_hmc_gibbs_recovers_a_conjugate_posterior():
    """a ~ N(0, 1) by NUTS, b | a ~ N(a, 1) by its exact conditional,
    y | b ~ N(b, 1) observed at 3: a | y ~ N(1, 2/3), b | y ~ N(2, 2/3)."""
    y_obs = torch.tensor(3.0)

    def model():
        a = npt.sample("a", dist.Normal(0.0, 1.0))
        b = npt.sample("b", dist.Normal(a, 1.0))
        npt.sample("y", dist.Normal(b, 1.0), obs=y_obs)

    calls = []

    def gibbs_fn(rng_key, gibbs_sites, hmc_sites):
        a = hmc_sites["a"]
        calls.append(tuple(a.shape))
        noise = torch.randn(a.shape, generator=rng_key)
        return {"b": (a + y_obs) / 2 + noise / 2**0.5}

    kernel = HMCGibbs(NUTS(model, max_tree_depth=4), gibbs_fn=gibbs_fn, gibbs_sites=["b"])
    mcmc = MCMC(kernel, num_warmup=60, num_samples=200, num_chains=C, device="cpu")
    mcmc.run(0)
    draws = mcmc.get_samples(group_by_chain=True)
    assert set(draws) == {"a", "b"} and draws["a"].shape == (C, 200)
    assert calls[0] == (C,)  # all chains in one call
    for name, mean in (("a", 1.0), ("b", 2.0)):
        ess = effective_sample_size(draws[name][..., None]).item()
        se = (2 / 3 / ess) ** 0.5
        assert abs(draws[name].mean().item() - mean) < 4 * se, (name, ess)
        assert abs(draws[name].var().item() - 2 / 3) < 0.2, name
    # one chain: unbatched sites at the boundary
    calls.clear()
    single = MCMC(HMCGibbs(HMC(model, num_steps=3), gibbs_fn=gibbs_fn, gibbs_sites=["b"]),
                  num_warmup=5, num_samples=5, num_chains=1, device="cpu")
    single.run(0)
    assert calls[0] == () and single.last_state.z["b"].shape == ()
    assert "steps of size" in single.sampler.get_diagnostics_str(single.last_state)
    assert single.get_samples(group_by_chain=True)["b"].shape == (1, 5)


def test_hmc_gibbs_constructor_errors():
    from numpyro_tpu_torch.infer import DiscreteHMCGibbs

    # DiscreteHMCGibbs is built and takes one step (its behaviour is in
    # test_torch_discrete_gibbs.py)
    def mixture():
        c = npt.sample("c", dist.Categorical(torch.tensor([0.3, 0.7])))
        npt.sample("x", dist.Normal(torch.tensor([-1.0, 1.0])[c], 1.0))

    kernel = DiscreteHMCGibbs(NUTS(mixture, max_tree_depth=2))
    state = kernel.init(torch.Generator().manual_seed(0), 2, None, (), {}, num_chains=3)
    state = kernel.sample(state, (), {})
    assert state.z["c"].shape == (3,) and state.hmc_state.i == 1
    with pytest.raises(ValueError, match="HMC or NUTS"):
        HMCGibbs(object(), gibbs_fn=lambda **k: {}, gibbs_sites=[])
    with pytest.raises(ValueError, match="callable"):
        HMCGibbs(NUTS(full_model), gibbs_fn=None, gibbs_sites=[])
    with pytest.raises(AssertionError):
        HMCGibbs(NUTS(potential_fn=lambda z: 0.0), gibbs_fn=lambda **k: {}, gibbs_sites=[])


# ---------------------------------------------------------------------------
# One HMCECS transition from JAX's state, on JAX's draws


class JaxEcsDraws:
    """The outer kernel's draws from JAX's keys, split as
    ``HMCECS._sample_batched`` splits them (``hmc_gibbs.py:737``): the block
    refresh from the second of four, the accept uniform from the third."""

    generator = torch.Generator().manual_seed(0)

    def __init__(self, keys):
        _, self.refresh, self.accept, _ = jc.split_keys(keys, 4)

    def block(self, idx, num_blocks, block_size, size):
        site_keys = jax.vmap(lambda k: random.split(k, 1)[0])(self.refresh)
        _, _, repl, start = jax.vmap(
            lambda k, i: jecs.block_refresh(k, i, size, num_blocks)
        )(site_keys, jnp.asarray(idx.numpy()))
        return (torch.from_numpy(np.array(start, dtype=np.int64)) // block_size,
                torch.from_numpy(np.array(repl, dtype=np.int64)))

    def uniform(self, like):
        return _t(jc.batch_uniform(self.accept))


@pytest.mark.parametrize("panel_mode,proxy_mode", [("carry", "stats"), ("lean", "recompute")])
def test_one_ecs_step_from_a_jax_state_matches_jax(panel_mode, proxy_mode):
    X, y = _data()
    args_j = (jnp.asarray(X), jnp.asarray(y))
    args_t = (torch.from_numpy(X), torch.from_numpy(y))
    k_j = JHMCECS(JNUTS(jax_model, max_tree_depth=4), num_blocks=BLOCKS,
                  proxy=JHMCECS.taylor_proxy({"w": REF}, mode=proxy_mode), panel_mode=panel_mode)
    k_t = HMCECS(NUTS(torch_model, max_tree_depth=4), num_blocks=BLOCKS,
                 proxy=HMCECS.taylor_proxy({"w": REF}, mode=proxy_mode), panel_mode=panel_mode)
    s_j = k_j.init(random.split(random.PRNGKey(0), C), 10, None, args_j, {})
    k_t.init(torch.Generator().manual_seed(0), 10, None, args_t, {}, num_chains=C)
    step_j = jax.jit(lambda s: k_j.sample(s, args_j, {}))
    s_j = step_j(s_j)  # a state past init: every chain has indices of its own
    for _ in range(2):
        s_t = ecs_state_from_numpy(jax.tree.map(np.asarray, s_j), device="cpu")
        assert isinstance(s_t, HMCECSState) and s_t.z["N"].dtype == torch.int64
        s_t = s_t._replace(
            rng_key=JaxEcsDraws(s_j.rng_key),
            hmc_state=s_t.hmc_state._replace(rng_key=JaxInnerDraws(s_j.hmc_state.rng_key)),
        )
        before = np.asarray(s_j.z["N"])
        s_j = step_j(s_j)
        s_t = k_t.sample(s_t, args_t, {})
        # the accepted mask and the index panels
        np.testing.assert_array_equal(s_t.z["N"].numpy(), np.asarray(s_j.z["N"]))
        changed = (np.asarray(s_j.z["N"]) != before).any(-1)
        np.testing.assert_allclose(s_t.accept_prob.numpy(), np.asarray(s_j.accept_prob),
                                   rtol=1e-3, atol=1e-4)
        assert changed.any()
        # carried statistics and data panels of the selected index sets
        if proxy_mode == "stats":
            for part in ("value", "grad"):
                np.testing.assert_allclose(
                    getattr(s_t.gibbs_state, part)["N"].numpy(),
                    np.asarray(getattr(s_j.gibbs_state, part)["N"]), rtol=1e-4, atol=1e-5)
        else:
            assert s_t.gibbs_state == ()
        assert len(s_t.panels) == len(s_j.panels) == (2 if panel_mode == "carry" else 0)
        for a, b in zip(s_t.panels, s_j.panels):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the inner transition ran from the selected potential and gradient
        h_t, h_j = s_t.hmc_state, s_j.hmc_state
        assert int(h_t.i) == int(h_j.i)
        np.testing.assert_array_equal(h_t.num_steps.numpy(), np.asarray(h_j.num_steps))
        np.testing.assert_allclose(h_t.potential_energy.numpy(), np.asarray(h_j.potential_energy),
                                   rtol=1e-4)
        g_j = np.asarray(h_j.z_grad["w"])
        np.testing.assert_allclose(h_t.z_grad["w"].numpy(), g_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(g_j).max())
        np.testing.assert_allclose(h_t.z["w"].numpy(), np.asarray(h_j.z["w"]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(s_t.z["w"].numpy(), h_t.z["w"].numpy())
        np.testing.assert_allclose(h_t.adapt_state.step_size.numpy(),
                                   np.asarray(h_j.adapt_state.step_size), rtol=1e-4)


# ---------------------------------------------------------------------------
# Whole runs

WARMUP, SAMPLES, DEPTH = 30, 50, 2


def _mean_and_se(draws):
    """Posterior mean per coefficient and its standard error from the ESS."""
    ess = effective_sample_size(draws).clamp(min=4.0)
    return draws.mean((0, 1)).numpy(), (draws.var((0, 1)) / ess).sqrt().numpy()


@pytest.fixture(scope="module")
def references():
    """A JAX HMCECS run and the port's full-data NUTS run on the same data."""
    X, y = _data()
    jm = JMCMC(
        JHMCECS(JNUTS(jax_model, max_tree_depth=DEPTH), num_blocks=BLOCKS,
                proxy=JHMCECS.taylor_proxy({"w": REF})),
        num_warmup=WARMUP, num_samples=SAMPLES, num_chains=C, chain_method="vectorized",
        progress_bar=False,
    )
    jm.run(random.PRNGKey(1), jnp.asarray(X), jnp.asarray(y))
    w_j = torch.from_numpy(np.array(jm.get_samples(group_by_chain=True)["w"]))
    nuts = MCMC(NUTS(full_model, max_tree_depth=5), num_warmup=100, num_samples=200,
                num_chains=C, device="cpu")
    nuts.run(2, torch.from_numpy(X), torch.from_numpy(y))
    return _mean_and_se(w_j), _mean_and_se(nuts.get_samples(group_by_chain=True)["w"])


@pytest.mark.parametrize(
    "panel_mode,proxy_mode",
    [("carry", "stats"), ("bf16", "stats"), ("lean", "stats"), ("carry", "recompute"),
     ("lean", "recompute")],
)
def test_ecs_run_agrees_with_jax_and_full_data_nuts(references, panel_mode, proxy_mode):
    X, y = _data()
    kernel = HMCECS(NUTS(torch_model, max_tree_depth=DEPTH), num_blocks=BLOCKS,
                    proxy=HMCECS.taylor_proxy({"w": REF}, mode=proxy_mode), panel_mode=panel_mode)
    mcmc = MCMC(kernel, num_warmup=WARMUP, num_samples=SAMPLES, num_chains=C, device="cpu")
    mcmc.run(1, torch.from_numpy(X), torch.from_numpy(y), extra_fields=("accept_prob",))
    assert kernel.resolved_modes == {"proxy": proxy_mode, "panel": panel_mode}
    draws = mcmc.get_samples(group_by_chain=True)
    assert set(draws) == {"w"} and draws["w"].shape == (C, SAMPLES, D)
    assert bool(torch.isfinite(draws["w"]).all())
    mean, se = _mean_and_se(draws["w"])
    for ref_mean, ref_se in references:
        assert (np.abs(mean - ref_mean) < 4 * np.sqrt(se**2 + ref_se**2)).all(), (
            mean, ref_mean, se, ref_se)
    accept = mcmc.get_extra_fields()["accept_prob"]
    assert 0.0 < accept.mean().item() < 1.0
    # every chain carries index panels of its own; in bf16 mode its data
    # panels are carried at half width
    last = mcmc.last_state
    assert last.z["N"].shape == (C, M) and not torch.equal(last.z["N"][0], last.z["N"][1])
    if panel_mode == "lean":
        assert last.panels == ()
    else:
        want = torch.bfloat16 if panel_mode == "bf16" else torch.float32
        assert [p.dtype for p in last.panels] == [want, want]
        np.testing.assert_array_equal(
            last.panels[0].float().numpy(),
            torch.from_numpy(X)[last.z["N"]].to(want).float().numpy())
    if proxy_mode == "stats":
        assert last.gibbs_state.grad["N"].shape == (C, M, D)


def test_carry_and_lean_give_the_same_potential_for_the_same_state():
    X, y = _data()
    args = (torch.from_numpy(X), torch.from_numpy(y))
    out = {}
    for mode in ("carry", "lean"):
        kernel = HMCECS(NUTS(torch_model, max_tree_depth=3), num_blocks=BLOCKS,
                        proxy=HMCECS.taylor_proxy({"w": REF}), panel_mode=mode)
        state = kernel.init(torch.Generator().manual_seed(3), 5, None, args, {}, num_chains=C)
        for _ in range(3):
            state = kernel.sample(state, args, {})
        out[mode] = state
    for field in ("potential_energy", "accept_prob"):
        a = getattr(out["carry"].hmc_state, field)
        b = getattr(out["lean"].hmc_state, field)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["carry"].z["N"].numpy(), out["lean"].z["N"].numpy())


def test_auto_resolves_carry_and_stats_at_small_scale():
    """As tests/infer/test_ecs_modes.py:115."""
    X, y = _data()
    kernel = HMCECS(NUTS(torch_model), num_blocks=BLOCKS, proxy=HMCECS.taylor_proxy({"w": REF}))
    kernel.init(torch.Generator().manual_seed(0), 5, None,
                (torch.from_numpy(X), torch.from_numpy(y)), {}, num_chains=2)
    assert kernel._panel_mode_resolved == "carry"
    assert kernel.resolved_modes == {"proxy": "stats", "panel": "carry"}


def test_collect_subsample_indices():
    X, y = _data()
    args = (torch.from_numpy(X), torch.from_numpy(y))
    shapes = {}
    for collect in (False, True):
        kernel = HMCECS(NUTS(torch_model, max_tree_depth=2), num_blocks=BLOCKS,
                        proxy=HMCECS.taylor_proxy({"w": REF}, degree=1),
                        collect_subsample_indices=collect)
        mcmc = MCMC(kernel, num_warmup=3, num_samples=4, num_chains=2, device="cpu")
        mcmc.run(0, *args)
        shapes[collect] = {k: tuple(v.shape) for k, v in mcmc.get_samples(True).items()}
        assert mcmc.last_state.z["N"].shape == (2, M)  # always on the last state
    assert shapes[False] == {"w": (2, 4, D)}
    assert shapes[True] == {"w": (2, 4, D), "N": (2, 4, M)}
    # the JAX package collects the index panels and then drops them in its
    # postprocess_fn (numpyro_tpu/infer/hmc_gibbs.py:480-488); the port hands
    # them over, which is what the argument asks for
    jm = JMCMC(JHMCECS(JNUTS(jax_model, max_tree_depth=1), num_blocks=BLOCKS,
                       collect_subsample_indices=True),
               num_warmup=1, num_samples=2, num_chains=2, progress_bar=False)
    jm.run(random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y))
    assert set(jm.get_samples()) == {"w"}
    assert jm.last_state.z["N"].shape == (2, M)


def test_reinitialisation_is_idempotent():
    """``init`` layers the estimator on the pristine model every time: a
    second ``init`` gives the same potential, not an estimator of an estimator."""
    X, y = _data()
    args = (torch.from_numpy(X), torch.from_numpy(y))
    kernel = HMCECS(NUTS(torch_model, max_tree_depth=2), num_blocks=BLOCKS,
                    proxy=HMCECS.taylor_proxy({"w": REF}))
    params = {"w": torch.from_numpy(REF).expand(2, D).clone()}
    states = [
        kernel.init(torch.Generator().manual_seed(0), 3, dict(params), args, {}, num_chains=2)
        for _ in range(2)
    ]
    model = kernel.inner_kernel._model
    assert isinstance(model, subsample_estimator) and model.fn is kernel._base_inner_model
    np.testing.assert_allclose(states[0].hmc_state.potential_energy.numpy(),
                               states[1].hmc_state.potential_energy.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(states[0].z["N"].numpy(), states[1].z["N"].numpy())
    kernel.sample(states[1], args, {})


def test_constructor_arguments_and_errors_match_jax():
    for cls, inner in ((HMCECS, NUTS(torch_model)), (JHMCECS, JNUTS(jax_model))):
        with pytest.raises(ValueError, match="auto\\|carry\\|bf16\\|lean"):
            cls(inner, panel_mode="fp8")
    X, y = _data()
    with pytest.raises(AssertionError, match="subsample statements"):
        HMCECS(NUTS(full_model)).init(
            torch.Generator().manual_seed(0), 1, None,
            (torch.from_numpy(X), torch.from_numpy(y)), {}, num_chains=2)
    # without a proxy the block update still runs
    kernel = HMCECS(NUTS(torch_model, max_tree_depth=2), num_blocks=BLOCKS)
    mcmc = MCMC(kernel, num_warmup=2, num_samples=2, num_chains=2, device="cpu")
    mcmc.run(0, torch.from_numpy(X), torch.from_numpy(y))
    assert kernel.resolved_modes == {"panel": "carry"} and mcmc.last_state.gibbs_state == ()
