"""The whole slice, ``MCMC(NUTS)`` on a small Bernoulli GLM, against the
JAX package's; the diagnostics against JAX's; and the port's import
hygiene."""

import subprocess
import sys

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
from numpyro_tpu import diagnostics as jdiag
from numpyro_tpu.infer import MCMC as JMCMC, NUTS as JNUTS
from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch import diagnostics
from numpyro_tpu_torch.infer import MCMC, NUTS
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)

N, D, C = 500, 4, 4
WARMUP, SAMPLES = 100, 100


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, D)))).astype(np.float32)
    return X, y


def jax_model(data):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    numpyro_tpu.factor("lik", jglm.bernoulli_logits_loglik(w, data))


def torch_model(data):
    w = npt.sample("w", dist.Normal(torch.zeros(D, device=data.device), 1.0).to_event(1))
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


@pytest.fixture(scope="module")
def runs():
    X, y = _data()
    jm = JMCMC(JNUTS(jax_model), num_warmup=WARMUP, num_samples=SAMPLES, num_chains=C,
               chain_method="vectorized", progress_bar=False)
    jm.run(random.PRNGKey(1), jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y)))
    tm = MCMC(NUTS(torch_model), num_warmup=WARMUP, num_samples=SAMPLES, num_chains=C,
              chain_method="vectorized", device="cpu")
    glm.reset_launch_counts()
    tm.run(torch.Generator().manual_seed(1),
           glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y)),
           extra_fields=("num_steps", "accept_prob"))
    return jm, tm, dict(glm.launch_counts)


def test_posterior_matches_jax(runs):
    jm, tm, _ = runs
    w_j = np.asarray(jm.get_samples()["w"])
    w_t = tm.get_samples()["w"].numpy()
    assert w_t.shape == w_j.shape == (C * SAMPLES, D)
    # as at tests/test_ops_glm.py:108-113: two chains of draws of the same
    # posterior, with different random numbers
    np.testing.assert_allclose(w_t.mean(0), w_j.mean(0), atol=0.05)
    np.testing.assert_allclose(w_t.std(0), w_j.std(0), atol=0.03)


def test_run_bookkeeping(runs):
    _, tm, launches = runs
    stats = tm.last_run_stats
    by_chain = tm.get_samples(group_by_chain=True)["w"]
    extra = tm.get_extra_fields(group_by_chain=True)
    assert by_chain.shape == (C, SAMPLES, D)
    assert extra["num_steps"].shape == (C, SAMPLES) and bool((extra["num_steps"] >= 1).all())
    assert extra["diverging"].dtype == torch.bool
    # every batched potential evaluation is one GLM call for all chains,
    # plus the one unbatched trace that finds the latent sites
    assert launches["plain"] == stats["potential_evals"] + stats["init_traces"]
    assert stats["potential_evals_init"] == 1
    assert 0.5 < extra["accept_prob"].mean().item() < 1.0
    assert tm.last_state.z["w"].shape == (C, D)


def test_effective_sample_size_matches_jax():
    rng = np.random.default_rng(3)
    x = np.zeros((4, 300, 2), np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    for i in range(1, 300):  # AR(1) chains, rho = 0.7
        x[:, i] = 0.7 * x[:, i - 1] + noise[:, i]
    np.testing.assert_allclose(
        diagnostics.effective_sample_size(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jdiag.effective_sample_size)(jnp.asarray(x))),
        rtol=1e-4,
    )
    np.testing.assert_allclose(
        diagnostics.split_gelman_rubin(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jdiag.split_gelman_rubin)(jnp.asarray(x))),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        diagnostics.autocorrelation(torch.from_numpy(x), axis=1).numpy(),
        np.asarray(jax.jit(jdiag.autocorrelation, static_argnums=1)(jnp.asarray(x), 1)),
        rtol=1e-4, atol=1e-5,
    )


def test_unported_options_raise():
    """An unknown ``chain_method`` raises; a callable one and the progress
    bar are ported (``tests/test_torch_mcmc_tail.py``), and a callable
    ``chain_method`` refuses ``post_warmup_state``, as the JAX package's."""
    mcmc = MCMC(NUTS(torch_model), num_warmup=1, num_samples=1, num_chains=2,
                chain_method=lambda f: f, progress_bar=True, device="cpu")
    assert callable(mcmc.chain_method) and mcmc.progress_bar
    mcmc.post_warmup_state = object()
    with pytest.raises(ValueError, match="post_warmup_state"):
        mcmc.run(0)
    with pytest.raises(ValueError, match="sequential"):
        MCMC(NUTS(torch_model), num_warmup=1, num_samples=1, chain_method="pmap")


def _small_model():
    a = npt.sample("a", dist.Normal(0.0, 1.0))
    npt.sample("b", dist.Normal(a, 0.5).expand([2]).to_event(1))


@pytest.mark.parametrize("kernel", ["nuts", "barker"])
def test_sequential_chains_equal_one_chain_runs_on_their_generators(kernel):
    """Chain i of a ``"sequential"`` run equals a one-chain run on the i-th
    generator of ``chain_generators``, on the fused path (NUTS) and on the
    per-step path (BarkerMH)."""
    from numpyro_tpu_torch.infer import BarkerMH
    from numpyro_tpu_torch.infer.mcmc import chain_generators

    make = (lambda: NUTS(_small_model, max_tree_depth=3)) if kernel == "nuts" else (
        lambda: BarkerMH(_small_model))
    seq = MCMC(make(), num_warmup=15, num_samples=10, num_chains=3, chain_method="sequential",
               device="cpu")
    seq.run(7, extra_fields=("potential_energy",) if kernel == "barker" else ())
    draws = seq.get_samples(group_by_chain=True)
    assert draws["b"].shape == (3, 10, 2)
    gens = chain_generators(7, torch.device("cpu"), 3)
    for i, gen in enumerate(gens):
        one = MCMC(make(), num_warmup=15, num_samples=10, num_chains=1, device="cpu")
        one.run(gen, extra_fields=("potential_energy",) if kernel == "barker" else ())
        for name in ("a", "b"):
            np.testing.assert_array_equal(draws[name][i].numpy(),
                                          one.get_samples(group_by_chain=True)[name][0].numpy())
    assert not torch.equal(draws["a"][0], draws["a"][1])
    stats = seq.last_run_stats
    assert stats["potential_evals"] > 0 and stats["total_s"] > 0
    assert seq.last_state.z["a"].shape[0] == 3
    # warmup alone, then a run that resumes from its state, chain by chain
    seq.warmup(8)
    assert seq.post_warmup_state.z["a"].shape == (3,)
    seq.run(9)
    assert seq.get_samples(group_by_chain=True)["b"].shape == (3, 10, 2)


@pytest.mark.parametrize("kernel", ["nuts", "barker"])
def test_parallel_equals_vectorized(kernel):
    """On one card ``"parallel"`` runs the vectorized program: the same seed
    gives the same draws."""
    from numpyro_tpu_torch.infer import BarkerMH

    out = {}
    for method in ("vectorized", "parallel"):
        k = NUTS(_small_model, max_tree_depth=3) if kernel == "nuts" else BarkerMH(_small_model)
        m = MCMC(k, num_warmup=10, num_samples=10, num_chains=4, chain_method=method,
                 device="cpu")
        m.run(3)
        out[method] = m.get_samples(group_by_chain=True)
    for name in ("a", "b"):
        np.testing.assert_array_equal(out["parallel"][name].numpy(),
                                      out["vectorized"][name].numpy())


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the fault on a machine without CUDA")
def test_default_device_is_cuda_and_never_falls_back_to_the_cpu():
    """``MCMC`` without ``device`` runs on ``cuda``: where there is none it
    raises, and a generator on the CPU does not move the run there."""
    X, y = _data()
    data = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y))
    mcmc = MCMC(NUTS(torch_model), num_warmup=2, num_samples=2, num_chains=2)
    assert mcmc.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        mcmc.run(0, data)
    with pytest.raises(ValueError, match="lives on cpu and the run on cuda"):
        mcmc.run(torch.Generator().manual_seed(0), data)
    assert mcmc.last_state is None and mcmc.last_run_stats == {}


def test_generator_on_another_device_raises():
    X, y = _data()
    data = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y))
    for device in ("cuda", "cuda:0"):
        on_card = MCMC(NUTS(torch_model), num_warmup=2, num_samples=2, num_chains=2,
                       device=device)
        with pytest.raises(ValueError, match="lives on cpu and the run on cuda"):
            on_card.run(torch.Generator(device="cpu").manual_seed(0), data)
    mcmc = MCMC(NUTS(torch_model), num_warmup=2, num_samples=2, num_chains=2, device="cpu")
    with pytest.raises(TypeError, match="int seed or a torch.Generator"):
        mcmc.run(1.5, data)
    # an int seed makes the generator on the run's device; the same seed, the same run
    mcmc.run(3, data)
    first = mcmc.get_samples()["w"].clone()
    mcmc.run(torch.Generator(device="cpu").manual_seed(3), data)
    assert torch.equal(first, mcmc.get_samples()["w"])


def test_import_leaves_jax_out():
    """Every module of the port, imported in a fresh process, loads neither
    JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, numpyro_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(numpyro_tpu_torch.__path__, "
        "'numpyro_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'numpyro_tpu_torch.nn.auto_reg_nn' in names, names\n"
        "assert 'numpyro_tpu_torch.distributions.flows' in names, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'numpyro_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, text=True)
    assert int(out.stdout) >= 40
