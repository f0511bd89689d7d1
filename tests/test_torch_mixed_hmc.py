"""``MixedHMC`` of the port against the JAX package's: one transition from a
JAX state on JAX's draws (discrete values equal; positions, potentials and
accept probabilities to rtol 1e-5 beside the atol given, the f32 sums of the
model's terms and of a leapfrog segment in another order), the two models of
``tests/infer/test_mixed_hmc.py`` under its gates, and the raise on NUTS."""

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
from numpyro_tpu.infer.hmc import HMC as JHMC
from numpyro_tpu.infer.hmc_gibbs import _split_keys
from numpyro_tpu.infer.mixed_hmc import MixedHMC as JMixedHMC
from numpyro_tpu_torch.infer import HMC, MCMC, NUTS, MixedHMC
from numpyro_tpu_torch.infer.mixed_hmc import MixedHMCState, mixed_state_from_numpy

from test_torch_kernels import QueueDraws

torch.set_num_threads(1)

RTOL = 1e-5
C = 6
PROBS = np.array([0.2, 0.5, 0.3], np.float32)
LOCS = np.array([-1.0, 0.5, 2.0], np.float32)


def jax_model():
    c = numpyro_tpu.sample("c", jdist.Categorical(jnp.asarray(PROBS)))
    d = numpyro_tpu.sample("d", jdist.Bernoulli(0.4))
    numpyro_tpu.sample("x", jdist.Normal(jnp.asarray(LOCS)[c] + 0.5 * d, 0.8).expand([2])
                       .to_event(1))


def torch_model():
    c = npt.sample("c", dist.Categorical(torch.from_numpy(PROBS)))
    d = npt.sample("d", dist.Bernoulli(0.4))
    npt.sample("x", dist.Normal(torch.from_numpy(LOCS)[c] + 0.5 * d, 0.8).expand([2])
               .to_event(1))


def _proposal(key, mode, size, smax):
    if mode in ("gibbs", "modified-gibbs"):
        return "gumbels", random.gumbel(key, (smax,))
    return "randints", random.randint(key, (), 0, size if mode == "rw" else size - 1)


@pytest.mark.parametrize("random_walk,modified", [(False, False), (False, True), (True, False),
                                                  (True, True)])
def test_one_transition_from_a_jax_state_matches_jax(random_walk, modified):
    k_j = JMixedHMC(JHMC(jax_model, trajectory_length=1.5), num_discrete_updates=3,
                    random_walk=random_walk, modified=modified)
    k_t = MixedHMC(HMC(torch_model, trajectory_length=1.5), num_discrete_updates=3,
                   random_walk=random_walk, modified=modified)
    s_j = k_j.init(random.split(random.PRNGKey(0), C), 3, None, (), {})
    k_t.init(torch.Generator().manual_seed(0), 3, None, (), {}, num_chains=C)
    step_j = jax.jit(lambda s: k_j.sample(s, (), {}))
    s_j = step_j(s_j)
    mode = k_j._mode
    sizes = {"c": 3, "d": 2}
    names = sorted(sizes)
    for _ in range(3):  # two warmup transitions (adaptation), then a draw
        keys, k_ke, k_time, k_mom, k_mh = _split_keys(s_j.rng_key, 5)
        items = [("exponentials", jax.vmap(lambda k: random.exponential(k, (2,)))(k_ke)),
                 ("uniforms", jax.vmap(lambda k: random.uniform(k, (2,)))(k_time)),
                 ("normals", jax.vmap(lambda k: random.normal(k, (2,)))(k_mom))]
        # the element of each event follows JAX's clock: replay it on the host
        arrival = np.array(jax.vmap(lambda k: random.uniform(k, (2,)))(k_time))
        for _event in range(3):
            keys, k_prop = _split_keys(keys, 2)
            idx = arrival.argmin(1)
            wait = arrival[np.arange(C), idx]
            arrival = arrival - wait[:, None]
            arrival[np.arange(C), idx] = 1.0
            draws = [_proposal(k, mode, sizes[names[i]], 3) for k, i in zip(k_prop, idx)]
            items.append((draws[0][0], np.stack([np.asarray(v) for _, v in draws])))
        items.append(("uniforms", jax.vmap(random.uniform)(k_mh)))
        outer = QueueDraws(items)
        s_t = mixed_state_from_numpy(jax.tree.map(np.asarray, s_j), rng_key=outer)
        assert isinstance(s_t, MixedHMCState) and s_t.z["c"].dtype == torch.int64
        s_j = step_j(s_j)
        s_t = k_t.sample(s_t, (), {})
        assert not outer.items
        for name in ("c", "d"):
            np.testing.assert_array_equal(s_t.z[name].numpy(), np.asarray(s_j.z[name]), name)
        np.testing.assert_allclose(s_t.z["x"].numpy(), np.asarray(s_j.z["x"]), rtol=RTOL,
                                   atol=1e-4)
        h_t, h_j = s_t.hmc_state, s_j.hmc_state
        np.testing.assert_array_equal(h_t.num_steps.numpy(), np.asarray(h_j.num_steps))
        for field in ("potential_energy", "energy", "accept_prob", "mean_accept_prob"):
            np.testing.assert_allclose(getattr(h_t, field).numpy(), np.asarray(getattr(h_j, field)),
                                       rtol=RTOL, atol=1e-4, err_msg=field)
        np.testing.assert_allclose(h_t.adapt_state.step_size.numpy(),
                                   np.asarray(h_j.adapt_state.step_size), rtol=1e-4)
        assert h_t.i == int(h_j.i)


@pytest.mark.parametrize("modified", [False, True])
def test_mixed_hmc_gaussian_mixture(modified):
    """``tests/infer/test_mixed_hmc.py``'s first model and gates; JAX runs one
    chain of 800 + 6,000, here 64 chains of 200 + 250."""
    probs, locs = torch.tensor([0.3, 0.7]), torch.tensor([-0.5, 1.0])

    def model():
        c = npt.sample("c", dist.Categorical(probs))
        npt.sample("x", dist.Normal(locs[c], 0.8))

    kernel = MixedHMC(HMC(model, trajectory_length=1.2), num_discrete_updates=4,
                      modified=modified)
    m = MCMC(kernel, num_warmup=200, num_samples=250, num_chains=64, device="cpu")
    m.run(0)
    s = m.get_samples()
    c, x = s["c"].numpy(), s["x"].numpy()
    true_mean = float(probs @ locs)
    np.testing.assert_allclose(np.bincount(c, minlength=2) / len(c), probs.numpy(), atol=0.06)
    assert abs(x.mean() - true_mean) < 0.1
    true_var = float(probs @ (locs - true_mean) ** 2 + 0.8**2)
    assert abs(x.var() - true_var) < 0.2


def test_mixed_hmc_vectorized_chains():
    """The second model of that file and its gate; 4 chains of 500 + 2,000
    there, 8 of 300 + 1,000 here."""
    probs, locs = torch.tensor([0.4, 0.6]), torch.tensor([0.0, 1.0])

    def model():
        c = npt.sample("c", dist.Categorical(probs))
        npt.sample("x", dist.Normal(locs[c], 1.0))

    m = MCMC(MixedHMC(HMC(model, trajectory_length=1.2), num_discrete_updates=3),
             num_warmup=300, num_samples=1000, num_chains=8, device="cpu")
    m.run(1)
    s = m.get_samples(group_by_chain=True)
    assert s["x"].shape == (8, 1000)
    c = s["c"].reshape(-1).numpy()
    np.testing.assert_allclose(np.bincount(c, minlength=2) / len(c), probs.numpy(), atol=0.06)


def test_nuts_inner_kernel_raises():
    with pytest.raises(ValueError, match="does not support NUTS"):
        MixedHMC(NUTS(torch_model))
