"""``DiscreteHMCGibbs`` of the port against the JAX package's:
``_element_proposal`` in its four modes and one ``_discrete_sweep`` exactly on
JAX's draws (values equal, potentials to rtol 1e-5, the f32 sums of a model's
terms in another order), one transition from a JAX state, the mixture of
``tests/infer/test_hmc_gibbs.py`` under its gates, a model with one
enumerated and one Gibbs site, and the HMM's ``markov`` form with its states
Gibbs-sampled against the enumerated posterior."""

import sys
from pathlib import Path

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
from numpyro_tpu.infer import DiscreteHMCGibbs as JDiscreteHMCGibbs, NUTS as JNUTS
from numpyro_tpu.infer import hmc_gibbs as jhg
from numpyro_tpu_torch.diagnostics import effective_sample_size
from numpyro_tpu_torch.infer import MCMC, NUTS, DiscreteHMCGibbs
from numpyro_tpu_torch.infer import hmc_gibbs as thg
from numpyro_tpu_torch.infer.hmc_gibbs import HMCGibbsState, gibbs_state_from_numpy

from test_torch_hmc_step import JaxDraws as JaxInnerDraws
from test_torch_kernels import QueueDraws

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import HMM_LOCS, hmm_data, hmm_model  # noqa: E402
from numpyro_tpu_torch.contrib.enum import markov  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-5
MODES = ["gibbs", "modified-gibbs", "rw", "modified-rw"]

# ---------------------------------------------------------------------------
# The proposal and the sweep, on JAX's draws

C = 5
SIZES = np.array([3, 2, 4, 3], np.int32)  # four discrete elements
SMAX = int(SIZES.max())
W = np.array([0.7, -1.2, 0.4, 0.9], np.float32)


def pe_flat_j(flat, x):
    v = flat.astype(jnp.float32)
    return jnp.sum((v - x) ** 2 * jnp.asarray(W) ** 2) + 0.3 * v[0] * v[2] - 0.1 * v[1]


def pe_flat_t(flat, x):
    v = flat.to(torch.float32)
    return ((v - x) ** 2 * torch.from_numpy(W) ** 2).sum() + 0.3 * v[0] * v[2] - 0.1 * v[1]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    flat = np.stack([rng.integers(0, SIZES) for _ in range(C)]).astype(np.int32)
    x = (2 * rng.standard_normal(C)).astype(np.float32)
    pe = np.array([float(pe_flat_j(jnp.asarray(f), xx)) for f, xx in zip(flat, x)], np.float32)
    return flat, x, pe


def _port_pe(x_t):
    one = torch.func.vmap(pe_flat_t)
    cand = torch.func.vmap(torch.func.vmap(pe_flat_t, in_dims=(0, None)))
    return (lambda z: cand(z, x_t)), (lambda f: one(f, x_t))


def _proposal_draw(key, mode, size):
    """The draw ``_element_proposal`` makes from its key, for one chain."""
    if mode in ("gibbs", "modified-gibbs"):
        return "gumbels", random.gumbel(key, (SMAX,))
    high = size if mode == "rw" else size - 1
    return "randints", random.randint(key, (), 0, high)


@pytest.mark.parametrize("mode", MODES)
def test_element_proposal_matches_jax(mode):
    flat, x, pe = _inputs()
    idx = np.array([0, 1, 2, 3, 2], np.int32)
    keys = random.split(random.PRNGKey(1), C)

    def one(key, f, xx, p, i):
        return jhg._element_proposal(lambda ff: pe_flat_j(ff, xx), key, f, p, i,
                                     jnp.asarray(SIZES)[i], SMAX, mode)

    want = jax.vmap(one)(keys, jnp.asarray(flat), jnp.asarray(x), jnp.asarray(pe),
                         jnp.asarray(idx))
    kinds = [_proposal_draw(k, mode, SIZES[i]) for k, i in zip(keys, idx)]
    draws = QueueDraws([(kinds[0][0], np.stack([np.asarray(v) for _, v in kinds]))])
    pe_cand, pe_one = _port_pe(torch.from_numpy(x))
    got = thg._element_proposal(
        pe_cand, pe_one, draws, torch.from_numpy(flat).long(), torch.from_numpy(pe),
        torch.from_numpy(idx).long(), torch.from_numpy(SIZES[idx]).long(), SMAX, mode,
    )
    assert not draws.items
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b, name in zip(got[1:], want[1:], ("pe_prop", "log_ratio")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-5, err_msg=name)


def _sweep_draws(keys, mode):
    """JAX's draws of ``_discrete_sweep`` (``hmc_gibbs.py``): a permutation,
    then per element a proposal and an accept key, for every chain."""
    perms, chain_keys = [], []
    for key in keys:
        key, perm_key = random.split(key)
        perms.append(np.asarray(random.permutation(perm_key, len(SIZES))))
        chain_keys.append(key)
    items = [("permutations", np.stack(perms))]
    for j in range(len(SIZES)):
        props, accepts = [], []
        for c in range(len(keys)):
            chain_keys[c], k_prop, k_accept = random.split(chain_keys[c], 3)
            size = SIZES[perms[c][j]]
            kind, value = _proposal_draw(k_prop, mode, size)
            props.append(np.asarray(value))
            accepts.append(np.asarray(random.uniform(k_accept)))
        items += [(kind, np.stack(props)), ("uniforms", np.stack(accepts))]
    return items


@pytest.mark.parametrize("mode", MODES)
def test_discrete_sweep_matches_jax(mode):
    flat, x, pe = _inputs(1)
    keys = random.split(random.PRNGKey(2), C)

    def one(key, f, xx, p):
        return jhg._discrete_sweep(lambda ff: pe_flat_j(ff, xx), key, f, lambda ff: ff, p, SIZES,
                                   mode=mode, smax=SMAX)

    want_flat, want_pe = jax.vmap(one)(keys, jnp.asarray(flat), jnp.asarray(x), jnp.asarray(pe))
    draws = QueueDraws(_sweep_draws(keys, mode))
    pe_cand, pe_one = _port_pe(torch.from_numpy(x))
    got_flat, got_pe = thg._discrete_sweep(
        pe_cand, pe_one, draws, torch.from_numpy(flat).long(), torch.from_numpy(pe),
        torch.from_numpy(SIZES).long(), mode=mode, smax=SMAX,
    )
    assert not draws.items
    np.testing.assert_array_equal(got_flat.numpy(), np.asarray(want_flat))
    np.testing.assert_allclose(got_pe.numpy(), np.asarray(want_pe), rtol=RTOL, atol=1e-5)
    assert not np.array_equal(np.asarray(want_flat), flat)


# ---------------------------------------------------------------------------
# One DiscreteHMCGibbs transition from a JAX state

PROBS = np.array([0.15, 0.3, 0.3, 0.25], np.float32)
LOCS = np.array([-1.0, 0.0, 1.0, 2.0], np.float32)


def jax_mixture(probs, locs):
    c = numpyro_tpu.sample("c", jdist.Categorical(probs))
    numpyro_tpu.sample("x", jdist.Normal(locs[c], 0.5))


def torch_mixture(probs, locs):
    c = npt.sample("c", dist.Categorical(probs))
    npt.sample("x", dist.Normal(locs[c], 0.5))


@pytest.mark.parametrize("modified", [False, True])
def test_one_transition_from_a_jax_state_matches_jax(modified):
    args_j = (jnp.asarray(PROBS), jnp.asarray(LOCS))
    args_t = (torch.from_numpy(PROBS), torch.from_numpy(LOCS))
    k_j = JDiscreteHMCGibbs(JNUTS(jax_mixture, max_tree_depth=3), modified=modified)
    k_t = DiscreteHMCGibbs(NUTS(torch_mixture, max_tree_depth=3), modified=modified)
    s_j = k_j.init(random.split(random.PRNGKey(0), C), 4, None, args_j, {})
    k_t.init(torch.Generator().manual_seed(0), 4, None, args_t, {}, num_chains=C)
    step_j = jax.jit(lambda s: k_j.sample(s, args_j, {}))
    s_j = step_j(s_j)  # a state past init: the chains' c differ
    for _ in range(3):
        _, gibbs_keys = jhg._split_keys(s_j.rng_key, 2)
        perm_items, props, accepts = [], [], []
        for key in gibbs_keys:
            key, perm_key = random.split(key)
            perm_items.append(np.asarray(random.permutation(perm_key, 1)))
            key, k_prop, k_accept = random.split(key, 3)
            props.append(np.asarray(random.gumbel(k_prop, (4,))))
            accepts.append(np.asarray(random.uniform(k_accept)))
        outer = QueueDraws([("permutations", np.stack(perm_items)),
                            ("gumbels", np.stack(props)), ("uniforms", np.stack(accepts))])
        s_t = gibbs_state_from_numpy(jax.tree.map(np.asarray, s_j))
        assert isinstance(s_t, HMCGibbsState) and s_t.z["c"].dtype == torch.int64
        s_t = s_t._replace(rng_key=outer, hmc_state=s_t.hmc_state._replace(
            rng_key=JaxInnerDraws(s_j.hmc_state.rng_key)))
        s_j = step_j(s_j)
        s_t = k_t.sample(s_t, args_t, {})
        assert not outer.items
        np.testing.assert_array_equal(s_t.z["c"].numpy(), np.asarray(s_j.z["c"]))
        h_t, h_j = s_t.hmc_state, s_j.hmc_state
        np.testing.assert_array_equal(h_t.num_steps.numpy(), np.asarray(h_j.num_steps))
        for field in ("potential_energy", "accept_prob"):
            np.testing.assert_allclose(getattr(h_t, field).numpy(), np.asarray(getattr(h_j, field)),
                                       rtol=RTOL, atol=1e-5, err_msg=field)
        np.testing.assert_allclose(s_t.z["x"].numpy(), np.asarray(s_j.z["x"]), rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(h_t.z_grad["x"].numpy(), np.asarray(h_j.z_grad["x"]),
                                   rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(h_t.adapt_state.step_size.numpy(),
                                   np.asarray(h_j.adapt_state.step_size), rtol=1e-4)


# ---------------------------------------------------------------------------
# Whole runs


@pytest.mark.parametrize("modified", [False, True])
def test_discrete_hmc_gibbs_mixture(modified):
    """``tests/infer/test_hmc_gibbs.py``'s mixture and gates (mean 0.1, var
    0.3); JAX runs one chain of 1,000 + 15,000, here 64 chains of 200 + 300
    at depth 4."""
    probs, locs = torch.from_numpy(PROBS), torch.from_numpy(LOCS)
    true_mean = float(PROBS @ LOCS)
    true_var = float(PROBS @ (LOCS - true_mean) ** 2 + 0.25)
    m = MCMC(DiscreteHMCGibbs(NUTS(torch_mixture, max_tree_depth=4), modified=modified),
             num_warmup=200, num_samples=300, num_chains=64, device="cpu")
    m.run(0, probs, locs)
    x = m.get_samples()["x"]
    assert m.get_samples()["c"].shape == x.shape == (64 * 300,)
    assert abs(x.mean().item() - true_mean) < 0.1
    assert abs(x.var().item() - true_var) < 0.3


@pytest.mark.parametrize("mode", [(True, False), (True, True)], ids=["rw", "modified-rw"])
def test_random_walk_modes_on_the_mixture(mode):
    random_walk, modified = mode
    probs, locs = torch.from_numpy(PROBS), torch.from_numpy(LOCS)
    m = MCMC(DiscreteHMCGibbs(NUTS(torch_mixture, max_tree_depth=4), random_walk=random_walk,
                              modified=modified),
             num_warmup=200, num_samples=300, num_chains=64, device="cpu")
    m.run(1, probs, locs)
    c = m.get_samples()["c"].numpy()
    np.testing.assert_allclose(np.bincount(c, minlength=4) / c.size, PROBS, atol=0.05)


def test_one_enumerated_and_one_gibbs_site():
    """``a`` is marked for parallel enumeration and stays with NUTS, which
    sums it out; ``b`` is Gibbs-sampled.  The exact posterior of (a, b) and
    the mean of x come from a grid."""
    pa = torch.tensor([0.4, 0.6])
    pb = torch.tensor([0.2, 0.5, 0.3])
    shift = torch.tensor([[-1.0, 0.0, 1.5], [0.5, 1.0, 2.0]])
    y = torch.tensor([0.8, 1.4])

    def model():
        a = npt.sample("a", dist.Categorical(pa), infer={"enumerate": "parallel"})
        b = npt.sample("b", dist.Categorical(pb))
        x = npt.sample("x", dist.Normal(shift[a, b], 1.0))
        npt.sample("y", dist.Normal(x, 0.7).expand([2]).to_event(1), obs=y)

    kernel = DiscreteHMCGibbs(NUTS(model, max_tree_depth=4))
    m = MCMC(kernel, num_warmup=150, num_samples=250, num_chains=32, device="cpu")
    m.run(2)
    assert kernel._gibbs_sites == ["b"]
    s = m.get_samples()
    assert set(s) == {"b", "x"}
    # exact: x | a, b, y is Gaussian; p(a, b | y) from the marginal of y
    import scipy.stats as st
    post, means = np.zeros((2, 3)), np.zeros((2, 3))
    ybar, var_y = y.mean().item(), 0.7**2 / 2
    for i in range(2):
        for j in range(3):
            mu = shift[i, j].item()
            post[i, j] = pa[i] * pb[j] * st.norm.pdf(ybar, mu, np.sqrt(1 + var_y))
            means[i, j] = (mu / 1 + ybar / var_y) / (1 + 1 / var_y)
    post /= post.sum()
    b_share = np.bincount(s["b"].numpy(), minlength=3) / s["b"].numel()
    np.testing.assert_allclose(b_share, post.sum(0), atol=0.05)
    assert abs(s["x"].mean().item() - (post * means).sum()) < 0.1


def hmm_gibbs_model(ys):
    """``chip_smoke.hmm_model`` (the ``markov`` form) with its states left
    unmarked, so that ``DiscreteHMCGibbs`` samples them."""
    probs = npt.sample("trans", dist.Dirichlet(torch.ones((2, 2))).to_event(1))
    locs = torch.tensor(HMM_LOCS)
    sigma = npt.sample("sigma", dist.HalfNormal(torch.tensor(1.0)))
    z = npt.sample("z_0", dist.Categorical(torch.tensor([0.5, 0.5])))
    npt.sample("y_0", dist.Normal(locs[z], sigma), obs=ys[0])
    for t in markov(range(1, ys.shape[0]), history=1):
        z = npt.sample(f"z_{t}", dist.Categorical(probs[z]))
        npt.sample(f"y_{t}", dist.Normal(locs[z], sigma), obs=ys[t])


def test_hmm_markov_form_gibbs_sampled_against_the_enumerated_posterior():
    """The HMM's ``markov`` form at T = 8: its states Gibbs-sampled (eight
    elements, eight batched evaluations a sweep) against NUTS on the form
    whose states are summed out; the posterior means of trans[0, 0],
    trans[1, 1] and sigma within 4 combined standard errors."""
    ys_np, _ = hmm_data(8)
    ys = torch.from_numpy(ys_np)

    def stats(mcmc):
        z = mcmc.get_samples(group_by_chain=True)
        out = []
        for v in (z["trans"][..., 0, 0], z["trans"][..., 1, 1], z["sigma"]):
            ess = effective_sample_size(v[..., None]).clamp(min=4.0).item()
            out.append((v.mean().item(), (v.var().item() / ess) ** 0.5))
        return out

    gibbs = MCMC(DiscreteHMCGibbs(NUTS(hmm_gibbs_model, max_tree_depth=3)), num_warmup=60,
                 num_samples=100, num_chains=16, device="cpu")
    gibbs.run(3, ys)
    z = gibbs.get_samples()
    assert sorted(k for k in z if k.startswith("z_")) == [f"z_{t}" for t in range(8)]
    enumerated = MCMC(NUTS(hmm_model, max_tree_depth=3), num_warmup=60, num_samples=150,
                      num_chains=16, device="cpu")
    enumerated.run(4, ys)
    for (m1, se1), (m2, se2) in zip(stats(gibbs), stats(enumerated)):
        assert abs(m1 - m2) < 4 * np.hypot(se1, se2), (m1, m2, se1, se2)


def test_one_step_and_diagnostics():
    """The kernel builds and steps on one chain (unbatched state)."""
    kernel = DiscreteHMCGibbs(NUTS(torch_mixture, max_tree_depth=2))
    args = (torch.from_numpy(PROBS), torch.from_numpy(LOCS))
    state = kernel.init(torch.Generator().manual_seed(0), 2, None, args, {})
    state = kernel.sample(state, args, {})
    assert state.z["c"].shape == () and state.z["x"].shape == ()
    assert state.hmc_state.i == 1
    with pytest.raises(AssertionError, match="discrete"):
        DiscreteHMCGibbs(NUTS(lambda: npt.sample("x", dist.Normal(0.0, 1.0)))).init(
            torch.Generator().manual_seed(0), 2, None, (), {})
