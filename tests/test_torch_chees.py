"""``CheesHMC`` of the port against the JAX package's: ``_halton`` bit for
bit, ``_adam_ascent`` and ``_welford_batch_merge``, one transition from a
JAX state on JAX's draws (every state field to rtol 1e-5 beside the atol
given), with a ``potential_fn`` and with a model, at a warmup index and after
warmup; then the port alone under ``tests/infer/test_chees.py``'s gates and
its chain methods."""

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
from numpyro_tpu.infer import CheesHMC as JCheesHMC
from numpyro_tpu.infer import chees as jchees
from numpyro_tpu_torch.infer import MCMC, CheesHMC
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer import chees
from numpyro_tpu_torch.infer.chees import chees_state_from_numpy

from test_torch_kernels import QueueDraws

torch.set_num_threads(1)

RTOL = 1e-5


def test_halton_equals_jax_bit_for_bit():
    idx = np.concatenate([
        np.arange(4096), np.arange(2**31 - 4, 2**31 + 4), np.arange(2**32 - 3, 2**32),
    ]).astype(np.uint32)
    want = np.asarray(jchees._halton(jnp.asarray(idx)))
    got = chees._halton(torch.from_numpy(idx.astype(np.int64))).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert float(chees._halton(7)) == float(jchees._halton(jnp.asarray(7)))


def test_adam_ascent_and_welford_merge_match_jax():
    rng = np.random.default_rng(0)
    state_j = jchees._AdamState(jnp.float32(0.3), jnp.float32(0.0), jnp.float32(0.0),
                                jnp.int32(0))
    state_t = chees._AdamState(torch.tensor(0.3), torch.tensor(0.0), torch.tensor(0.0),
                               torch.tensor(0))
    for g in rng.standard_normal(20).astype(np.float32):
        state_j = jchees._adam_ascent(state_j, jnp.float32(g), 0.025)
        state_t = chees._adam_ascent(state_t, torch.tensor(g), 0.025)
    for a, b in zip(state_t, state_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL)

    mean_j, m2_j, n_j = jnp.zeros(3), jnp.zeros(3), jnp.float32(0.0)
    mean_t, m2_t, n_t = torch.zeros(3), torch.zeros(3), torch.tensor(0.0)
    for _ in range(4):
        batch = (rng.standard_normal((16, 3)) * [1.0, 2.0, 0.5] + 3.0).astype(np.float32)
        mean_j, m2_j, n_j = jchees._welford_batch_merge(mean_j, m2_j, n_j, jnp.asarray(batch))
        mean_t, m2_t, n_t = chees._welford_batch_merge(mean_t, m2_t, n_t, torch.from_numpy(batch))
    for a, b in ((mean_t, mean_j), (m2_t, m2_j), (n_t, n_j)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL)


# ---------------------------------------------------------------------------
# One transition from a JAX state on JAX's draws

C = 8
COV = np.array([[1.0, 0.6, 0.1], [0.6, 2.0, 0.3], [0.1, 0.3, 0.5]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
MU = np.array([0.5, -1.0, 0.25], np.float32)


def pe_j(z):
    x = jnp.concatenate([z["a"], z["b"][None]]) - jnp.asarray(MU)
    return 0.5 * x @ jnp.asarray(PREC) @ x


def pe_t(z):
    x = torch.cat([z["a"], z["b"][None]]) - torch.from_numpy(MU)
    return 0.5 * x @ torch.from_numpy(PREC) @ x


X_GLM = np.random.default_rng(1).standard_normal((40, 3)).astype(np.float32)
Y_GLM = (np.random.default_rng(2).random(40) < 0.4).astype(np.float32)


def model_j(x, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(3), 1.0).to_event(1))
    s = numpyro_tpu.sample("s", jdist.HalfNormal(1.0))
    with numpyro_tpu.plate("N", x.shape[0]):
        numpyro_tpu.sample("y", jdist.Bernoulli(logits=s * (x @ w)), obs=y)


def model_t(x, y):
    w = npt.sample("w", dist.Normal(torch.zeros(3), 1.0).to_event(1))
    s = npt.sample("s", dist.HalfNormal(1.0))
    with npt.plate("N", x.shape[0]):
        npt.sample("y", dist.Bernoulli(logits=s * (x @ w)), obs=y)


def _jax_kernel(kind, num_warmup):
    if kind == "potential_fn":
        kernel = JCheesHMC(potential_fn=pe_j, step_size=0.3, max_num_steps=8)
        init = {"a": jnp.zeros((C, 2)), "b": jnp.zeros(C)}
        state = kernel.init(random.split(random.PRNGKey(0), C), num_warmup, init_params=init)
        args = ()
    else:
        kernel = JCheesHMC(model_j, step_size=0.3, max_num_steps=8)
        args = (jnp.asarray(X_GLM), jnp.asarray(Y_GLM))
        state = kernel.init(random.split(random.PRNGKey(0), C), num_warmup, model_args=args)
    return kernel, state, args


def _port_kernel(kind, num_warmup):
    if kind == "potential_fn":
        kernel = CheesHMC(potential_fn=pe_t, step_size=0.3, max_num_steps=8)
        kernel.init(torch.Generator().manual_seed(0), num_warmup,
                    init_params={"a": torch.zeros(C, 2), "b": torch.zeros(C)}, num_chains=C)
    else:
        kernel = CheesHMC(model_t, step_size=0.3, max_num_steps=8)
        kernel.init(torch.Generator().manual_seed(0), num_warmup,
                    model_args=(torch.from_numpy(X_GLM), torch.from_numpy(Y_GLM)), num_chains=C)
    return kernel


def _close_tree(got, want, atol, path="state"):
    if isinstance(want, dict) or hasattr(want, "_fields"):
        items = want.items() if isinstance(want, dict) else zip(want._fields, want)
        for k, v in items:
            if k == "rng_key":
                continue
            g = got[k] if isinstance(got, dict) else getattr(got, k)
            _close_tree(g, v, atol, f"{path}.{k}")
        return
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=atol, err_msg=path)


@pytest.mark.parametrize("kind", ["potential_fn", "model"])
@pytest.mark.parametrize("steps_before, num_warmup", [(14, 30), (30, 30)],
                         ids=["warmup", "sampling"])
def test_one_transition_from_a_jax_state_matches_jax(kind, steps_before, num_warmup):
    kernel_j, state_j, args = _jax_kernel(kind, num_warmup)
    step_j = jax.jit(lambda s: kernel_j.sample(s, args, {}))
    for _ in range(steps_before):
        state_j = step_j(state_j)
    # JAX's draws of the next transition
    _, key_mom, key_mh = random.split(state_j.rng_key, 3)
    d = sum(int(np.prod(v.shape[1:])) for v in jax.tree.leaves(state_j.z))
    draws = QueueDraws([("normals", np.asarray(random.normal(key_mom, (C, d)))),
                        ("uniforms", np.asarray(random.uniform(key_mh, (C,))))])
    want = jax.tree.map(np.asarray, step_j(state_j))

    kernel_t = _port_kernel(kind, num_warmup)
    state_t = chees_state_from_numpy(jax.tree.map(np.asarray, state_j), rng_key=draws)
    evals0 = infer_util.potential_evals
    got = kernel_t.sample(state_t)
    assert draws.done()
    # num_steps leapfrog evaluations and the first gradient: the proposal's
    # potential is the last step's value, where JAX evaluates it once more
    assert infer_util.potential_evals - evals0 == int(want.num_steps) + 1
    assert got.i == int(want.i) and int(got.num_steps) == int(want.num_steps)
    _close_tree(got._asdict(), want, atol=1e-5)


def test_single_chain_and_sequential_raise():
    kernel = CheesHMC(potential_fn=lambda z: 0.5 * (z["x"] ** 2).sum())
    with pytest.raises(ValueError, match="num_chains"):
        kernel.init(torch.Generator().manual_seed(0), 10, init_params={"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="num_chains"):
        JCheesHMC(potential_fn=lambda z: 0.5 * jnp.sum(z["x"] ** 2)).init(
            random.PRNGKey(0), 10, init_params={"x": jnp.zeros(2)})
    mcmc = MCMC(kernel, num_warmup=5, num_samples=5, num_chains=2, chain_method="sequential",
                device="cpu")
    with pytest.raises(ValueError, match="num_chains"):
        mcmc.run(0, init_params={"x": torch.zeros(2, 2)})


def _gaussian_run(chain_method, seed=0):
    cov = torch.tensor([[2.0, 1.2], [1.2, 4.0]])
    prec = torch.linalg.inv(cov)
    mu = torch.tensor([1.0, -2.0])

    def pot(z):
        d = z["x"] - mu
        return 0.5 * d @ prec @ d

    m = MCMC(CheesHMC(potential_fn=pot), num_warmup=500, num_samples=500, num_chains=64,
             chain_method=chain_method, device="cpu")
    m.run(seed, init_params={"x": torch.zeros(64, 2)})
    return m, cov, mu


def test_gaussian_moments_under_the_jax_tests_gates():
    m, cov, mu = _gaussian_run("vectorized")
    xs = m.get_samples()["x"].reshape(-1, 2).numpy()
    assert np.allclose(xs.mean(0), mu.numpy(), atol=0.15)
    assert np.allclose(np.cov(xs.T), cov.numpy(), rtol=0.15, atol=0.25)
    assert abs(float(m.last_state.mean_accept_prob.mean()) - 0.651) < 0.05


def test_parallel_equals_vectorized():
    def run(method):
        def pot(z):
            return 0.5 * ((z["x"] - torch.arange(4.0)) ** 2).sum()

        m = MCMC(CheesHMC(potential_fn=pot), num_warmup=30, num_samples=20, num_chains=16,
                 chain_method=method, device="cpu")
        m.run(3, init_params={"x": torch.zeros(16, 4)})
        return m.get_samples()["x"]

    torch.testing.assert_close(run("parallel"), run("vectorized"), rtol=0, atol=0)
