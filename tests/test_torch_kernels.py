"""``BarkerMH``, ``SA``, ``AIES`` and ``ESS`` of the port and
``distributions.util.cholesky_update``: one panel transition of each kernel
from a JAX state on JAX's draws (state fields to rtol 1e-5 beside the atol
given at each comparison), every ensemble move, ``gaussian_kde`` against
``jax.scipy.stats.gaussian_kde``, and whole runs of
``tests/infer/test_kernels.py``'s cases under that file's gates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.stats as jstats
from jax import random

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.distributions.util import cholesky_update as jcholesky_update
from numpyro_tpu.infer import AIES as JAIES, ESS as JESS, BarkerMH as JBarkerMH, SA as JSA
from numpyro_tpu.infer import hmc_core as jc
from numpyro_tpu_torch.distributions.util import cholesky_update
from numpyro_tpu_torch.infer import AIES, ESS, MCMC, SA, BarkerMH
from numpyro_tpu_torch.infer.barker import barker_state_from_numpy
from numpyro_tpu_torch.infer.ensemble import ensemble_state_from_numpy, gaussian_kde
from numpyro_tpu_torch.infer.sa import sa_state_from_numpy

torch.set_num_threads(1)

RTOL = 1e-5


def _t(x, dtype=None):
    x = np.array(x)
    if dtype is None and x.dtype == np.float64:
        dtype = np.float32
    return torch.from_numpy(x if dtype is None else x.astype(dtype))


class QueueDraws:
    """The port's draw-source protocol, fed JAX's draws in the order in which
    the port's kernel asks for them (each kernel's module docstring gives the
    order).  An item is ``(kind, value)`` or ``(kind, iterator)``; an iterator
    serves every call of its kind until the port asks for another kind."""

    generator = torch.Generator().manual_seed(0)

    def __init__(self, items=()):
        self.items = list(items)

    def push(self, kind, value):
        self.items.append((kind, value))
        return self

    def _pop(self, kind, shape=None):
        assert self.items, f"no draw left for {kind}"
        head_kind, value = self.items[0]
        if hasattr(value, "__next__"):
            if head_kind != kind:
                self.items.pop(0)
                return self._pop(kind, shape)
            out = next(value)
        else:
            assert head_kind == kind, (head_kind, kind)
            self.items.pop(0)
            out = value
        if isinstance(out, int):
            return out
        out = _t(out, np.int64 if np.issubdtype(np.asarray(out).dtype, np.integer) else None)
        if shape is not None:
            assert tuple(out.shape) == tuple(shape), (kind, tuple(out.shape), shape)
        return out

    def normals(self, shape, like):
        return self._pop("normals", shape)

    def uniforms(self, shape, like):
        return self._pop("uniforms", shape)

    def exponentials(self, shape, like):
        return self._pop("exponentials", shape)

    def gumbels(self, shape, like):
        return self._pop("gumbels", shape)

    def randints(self, low, high, shape, like):
        return self._pop("randints", shape)

    def permutations(self, shape, like):
        return self._pop("permutations", shape)

    def choice(self, weights):
        return self._pop("choice")

    def categorical(self, weights, shape):
        return self._pop("categorical", shape)

    def fork(self):
        return self

    def done(self):
        return all(hasattr(v, "__next__") for _, v in self.items)


def _close(a, b, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# cholesky_update


@pytest.mark.parametrize("coef", [0.7, -0.05])
def test_cholesky_update_matches_jax(coef):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 6, 6)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2) + 6 * np.eye(6, dtype=np.float32)
    L = np.linalg.cholesky(cov).astype(np.float32)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    want = np.asarray(jcholesky_update(jnp.asarray(L), jnp.asarray(x), coef))
    got = cholesky_update(torch.from_numpy(L), torch.from_numpy(x), coef).numpy()
    assert got.shape == want.shape == (3, 5, 6, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = np.linalg.cholesky(cov + coef * x[..., :, None] * x[..., None, :])
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# One panel transition from a JAX state, on JAX's draws

C, D = 6, 3
COV = np.array([[1.0, 0.5, 0.2], [0.5, 2.0, 0.3], [0.2, 0.3, 0.5]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def pe_j(z):
    x = jnp.concatenate([z["a"], z["b"][None]])
    return 0.5 * x @ jnp.asarray(PREC) @ x


def pe_t(z):
    x = torch.cat([z["a"], z["b"][None]])
    return 0.5 * x @ torch.from_numpy(PREC) @ x


def _init_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((C, 2)).astype(np.float32),
            "b": rng.standard_normal(C).astype(np.float32)}


def _tree_t(tree):
    return {k: _t(v) for k, v in tree.items()}


@pytest.mark.parametrize("dense_mass", [False, True])
def test_one_barker_transition_from_a_jax_state_matches_jax(dense_mass):
    z0 = _init_params()
    k_j = JBarkerMH(potential_fn=pe_j, dense_mass=dense_mass, step_size=0.7)
    k_t = BarkerMH(potential_fn=pe_t, dense_mass=dense_mass, step_size=0.7)
    s_j = k_j.init(random.split(random.PRNGKey(0), C), 3,
                   {k: jnp.asarray(v) for k, v in z0.items()}, (), {})
    k_t.init(torch.Generator().manual_seed(0), 3, _tree_t(z0), (), {}, num_chains=C)
    step_j = jax.jit(lambda s: k_j.sample(s, (), {}))
    partial_accept = False
    for step in range(4):  # three warmup steps (adaptation) and one draw
        _, k_mag, k_flip, k_mh = jc.split_keys(s_j.rng_key, 4)
        draws = QueueDraws([
            ("normals", jax.vmap(lambda k: random.normal(k, (D,)))(k_mag)),
            ("uniforms", jax.vmap(lambda k: random.uniform(k, (D,)))(k_flip)),
            ("uniforms", jc.batch_uniform(k_mh)),
        ])
        s_t = barker_state_from_numpy(jax.tree.map(np.asarray, s_j), rng_key=draws)
        s_j = step_j(s_j)
        s_t = k_t.sample(s_t, (), {})
        assert not draws.items and s_t.i == int(s_j.i) == step + 1
        for name in ("a", "b"):
            _close(s_t.z[name], s_j.z[name], 1e-5, name)
            _close(s_t.z_grad[name], s_j.z_grad[name], 1e-4, name)
        for field in ("potential_energy", "accept_prob", "mean_accept_prob"):
            _close(getattr(s_t, field), getattr(s_j, field), 1e-5, field)
        a = np.asarray(s_j.accept_prob)
        partial_accept = partial_accept or bool(((a > 0) & (a < 1)).any())
        _close(s_t.adapt_state.step_size, s_j.adapt_state.step_size, 1e-5, "step_size")
        _close(s_t.adapt_state.mass_matrix_sqrt_inv, s_j.adapt_state.mass_matrix_sqrt_inv, 1e-5)
    assert partial_accept


@pytest.mark.parametrize("dense_mass", [True, False])
def test_one_sa_transition_from_a_jax_state_matches_jax(dense_mass):
    z0 = _init_params(1)
    n_pool = 8
    k_j = JSA(potential_fn=pe_j, adapt_state_size=n_pool, dense_mass=dense_mass)
    k_t = SA(potential_fn=pe_t, adapt_state_size=n_pool, dense_mass=dense_mass)
    s_j = k_j.init(random.split(random.PRNGKey(2), C), 5,
                   {k: jnp.asarray(v) for k, v in z0.items()}, (), {})
    k_t.init(torch.Generator().manual_seed(0), 5, _tree_t(z0), (), {}, num_chains=C)
    step_j = jax.jit(lambda s: k_j.sample(s, (), {}))
    changed = False
    for _ in range(3):
        keys = jax.vmap(lambda k: random.split(k, 4))(s_j.rng_key)
        draws = QueueDraws([
            ("normals", jax.vmap(lambda k: random.normal(k, (D,)))(keys[:, 1])),
            ("gumbels", jax.vmap(lambda k: random.gumbel(k, (n_pool + 1,)))(keys[:, 2])),
            ("randints", jax.vmap(lambda k: random.randint(k, (), 0, n_pool))(keys[:, 3])),
        ])
        s_t = sa_state_from_numpy(jax.tree.map(np.asarray, s_j), rng_key=draws)
        before = np.asarray(s_j.adapt_state.zs)
        s_j = step_j(s_j)
        s_t = k_t.sample(s_t, (), {})
        assert not draws.items and s_t.i == int(s_j.i)
        changed = changed or not np.array_equal(before, np.asarray(s_j.adapt_state.zs))
        np.testing.assert_array_equal(s_t.diverging.numpy(), np.asarray(s_j.diverging))
        for name in ("a", "b"):
            _close(s_t.z[name], s_j.z[name], 1e-5, name)
        for field in ("potential_energy", "accept_prob", "mean_accept_prob"):
            _close(getattr(s_t, field), getattr(s_j, field), 1e-4, field)
        for field in ("zs", "pes", "loc", "inv_mass_matrix_sqrt"):
            _close(getattr(s_t.adapt_state, field), getattr(s_j.adapt_state, field), 1e-4, field)
    assert changed  # a pool point was traded


def _ensemble_problem():
    rng = np.random.default_rng(3)
    return rng.standard_normal((8, D)).astype(np.float32)


def _distinct_pair_draws(key, n, m):
    ki, kd = random.split(key)
    return [("randints", random.randint(ki, (m,), 0, n)), ("randints", random.randint(kd, (m,), 1, n))]


def _aies_half_draws(key, moves_j, which_name, m, n, d):
    """JAX's draws of one AIES half step (``ensemble.py`` ``update_active_chains``)."""
    key, k_move, k_prop, k_mh = random.split(key, 4)
    items = []
    if len(moves_j) > 1:
        weights = jnp.ones(len(moves_j)) / len(moves_j)
        which = int(random.choice(k_move, len(moves_j), p=weights))
        items.append(("choice", which))
        which_name = ["de", "stretch"][which]
    if which_name == "de":
        k_pair, k_gamma = random.split(k_prop)
        items += _distinct_pair_draws(k_pair, n, m)
        items.append(("normals", random.normal(k_gamma, (m, 1))))
    else:
        k_z, k_pick = random.split(k_prop)
        items.append(("uniforms", random.uniform(k_z, (m,))))
        items.append(("randints", random.randint(k_pick, (m,), 0, n)))
    items.append(("uniforms", random.uniform(k_mh, (m,))))
    return key, items


@pytest.mark.parametrize("moves", ["de", "stretch", "both"])
def test_one_aies_step_from_a_jax_state_matches_jax(moves):
    z0 = _ensemble_problem()
    spec_j = {"de": {JAIES.DEMove(): 1.0}, "stretch": {JAIES.StretchMove(): 1.0},
              "both": {JAIES.DEMove(): 0.5, JAIES.StretchMove(): 0.5}}[moves]
    spec_t = {"de": {AIES.DEMove(): 1.0}, "stretch": {AIES.StretchMove(): 1.0},
              "both": {AIES.DEMove(): 0.5, AIES.StretchMove(): 0.5}}[moves]
    k_j = JAIES(potential_fn=lambda x: 0.5 * jnp.sum(x**2 / jnp.array([1.0, 4.0, 0.25])),
                moves=spec_j)
    k_t = AIES(potential_fn=lambda x: 0.5 * (x**2 / torch.tensor([1.0, 4.0, 0.25])).sum(),
               moves=spec_t)
    s_j = k_j.init(random.split(random.PRNGKey(4), 8), 2, jnp.asarray(z0), (), {})
    k_t.init(torch.Generator().manual_seed(0), 2, torch.from_numpy(z0), (), {}, num_chains=8)
    step_j = jax.jit(lambda s: k_j.sample(s, (), {}))
    for _ in range(3):
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
        _close(s_t.z, s_j.z, 1e-5, "z")
        assert s_t.inner_state.i == float(s_j.inner_state.i)
        _close(s_t.inner_state.accept_prob, s_j.inner_state.accept_prob, 1e-6)
        _close(s_t.inner_state.mean_accept_prob, s_j.inner_state.mean_accept_prob, 1e-6)


def _uniform_stream(key, shape):
    while True:
        key, k_u = random.split(key)
        yield random.uniform(k_u, shape)


def _ess_half_draws(key, which, inactive, mu, m):
    """JAX's draws of one ESS half step (``ensemble.py`` ``update_active_chains``)."""
    key, k_move, k_dir, k_h, k_out, k_in = random.split(key, 6)
    n, d = inactive.shape
    if which == "differential":
        items = _distinct_pair_draws(k_dir, m, m)
    elif which in ("random", "gaussian"):
        items = [("normals", random.normal(k_dir, (m, d)))]
    else:  # kde
        kde = jstats.gaussian_kde(jnp.asarray(inactive).T)
        ind_key, eps_key = random.split(k_dir)
        items = [("categorical", random.choice(ind_key, kde.n, shape=(2 * m,), p=kde.weights)),
                 ("normals", random.normal(eps_key, (2 * m, d)))]
    k_pos, k_split = random.split(k_out)
    items += [("uniforms", random.uniform(k_h, (m, 1))),
              ("uniforms", random.uniform(k_pos, (m, 1))),
              ("uniforms", random.uniform(k_split, (m, 1))),
              ("uniforms", _uniform_stream(k_in, (m, 1)))]
    return key, items


@pytest.mark.parametrize("which", ["differential", "random", "gaussian", "kde"])
def test_one_ess_step_from_a_jax_state_matches_jax(which):
    z0 = _ensemble_problem()
    mv_j = {"differential": JESS.DifferentialMove, "random": JESS.RandomMove,
            "gaussian": JESS.GaussianMove, "kde": JESS.KDEMove}[which]()
    mv_t = {"differential": ESS.DifferentialMove, "random": ESS.RandomMove,
            "gaussian": ESS.GaussianMove, "kde": ESS.KDEMove}[which]()
    k_j = JESS(potential_fn=lambda x: 0.5 * jnp.sum(x**2 / jnp.array([1.0, 4.0, 0.25])),
               moves={mv_j: 1.0})
    k_t = ESS(potential_fn=lambda x: 0.5 * (x**2 / torch.tensor([1.0, 4.0, 0.25])).sum(),
              moves={mv_t: 1.0})
    s_j = k_j.init(random.split(random.PRNGKey(5), 8), 2, jnp.asarray(z0), (), {})
    k_t.init(torch.Generator().manual_seed(0), 2, torch.from_numpy(z0), (), {}, num_chains=8)
    step_j = jax.jit(lambda s: k_j.sample(s, (), {}))
    for _ in range(2):
        _, shuffle_key = random.split(s_j.rng_key)
        perm = random.permutation(shuffle_key, 8)
        panel = np.asarray(s_j.z)[np.asarray(perm)]
        # the first half's draws depend on the second half only; the second
        # half's on the refreshed first, so JAX's own first half gives them
        key = s_j.inner_state.rng_key
        key, items1 = _ess_half_draws(key, which, panel[4:], s_j.inner_state.mu, 4)
        refreshed, _ = k_j.update_active_chains(jnp.asarray(panel[:4]), jnp.asarray(panel[4:]),
                                                s_j.inner_state)
        key, items2 = _ess_half_draws(key, which, np.asarray(refreshed), None, 4)
        inner = QueueDraws(items1 + items2)
        s_t = ensemble_state_from_numpy(jax.tree.map(np.asarray, s_j),
                                        rng_key=QueueDraws([("permutations", perm)]),
                                        inner_rng_key=inner)
        s_j = step_j(s_j)
        s_t = k_t.sample(s_t, (), {})
        assert inner.done()
        _close(s_t.z, s_j.z, 1e-4, "z")
        for field in ("n_expansions", "n_contractions"):
            assert int(getattr(s_t.inner_state, field)) == int(getattr(s_j.inner_state, field))
        _close(s_t.inner_state.mu, s_j.inner_state.mu, 1e-6, "mu")


def test_gaussian_kde_matches_jax():
    rng = np.random.default_rng(6)
    data = rng.standard_normal((3, 40)).astype(np.float32) * np.array([[1.0], [3.0], [0.5]],
                                                                       np.float32)
    points = rng.standard_normal((3, 7)).astype(np.float32)
    for bw in (None, "silverman", 0.4):
        k_j = jstats.gaussian_kde(jnp.asarray(data), bw_method=bw)
        k_t = gaussian_kde(torch.from_numpy(data), bw_method=bw)
        _close(k_t.covariance, k_j.covariance, 1e-6, "covariance")
        _close(k_t.inv_cov, k_j.inv_cov, 1e-4, "inv_cov")
        _close(k_t.logpdf(torch.from_numpy(points)), k_j.logpdf(jnp.asarray(points)), 1e-5)
    # weighted, and resampling on JAX's draws
    w = rng.random(40).astype(np.float32)
    k_j = jstats.gaussian_kde(jnp.asarray(data), weights=jnp.asarray(w))
    k_t = gaussian_kde(torch.from_numpy(data), weights=torch.from_numpy(w))
    _close(k_t.covariance, k_j.covariance, 1e-6, "weighted covariance")
    key = random.PRNGKey(7)
    ind_key, eps_key = random.split(key)
    draws = QueueDraws([
        ("categorical", random.choice(ind_key, 40, shape=(10,), p=k_j.weights)),
        ("normals", random.normal(eps_key, (10, 3))),
    ])
    _close(k_t.resample(draws, (10,)), k_j.resample(key, (10,)), 1e-5, "resample")
    # a one-dimensional dataset, and its draws from a generator
    one = gaussian_kde(torch.from_numpy(data[0]))
    assert one.resample(torch.Generator().manual_seed(0), (11,)).shape == (1, 11)


def test_ensemble_asserts_an_even_vectorized_chain_count():
    def normal_model():
        x = npt.sample("x", dist.Normal(0.0, 1.0).expand([3]))
        npt.sample("obs", dist.Normal(x, 1.0), obs=torch.ones(3))

    g = torch.Generator().manual_seed(0)
    with pytest.raises(AssertionError, match="even"):
        AIES(normal_model).init(g, 10, None, (), {}, num_chains=7)
    with pytest.raises(AssertionError, match="vectorized"):
        ESS(normal_model).init(g, 10, None, (), {})
    # as the driver hands them over: one chain, and sequential chains
    for method, chains in (("vectorized", 1), ("sequential", 4)):
        m = MCMC(AIES(normal_model), num_warmup=2, num_samples=2, num_chains=chains,
                 chain_method=method, device="cpu")
        with pytest.raises(AssertionError):
            m.run(0)
    assert AIES(normal_model).is_ensemble_kernel and not BarkerMH(normal_model).is_ensemble_kernel


# ---------------------------------------------------------------------------
# Whole runs: tests/infer/test_kernels.py's cases and gates

TRUE_MEAN, TRUE_STD = 1.0, 2.0


def gaussian_potential(z):
    return 0.5 * (((z - TRUE_MEAN) / TRUE_STD) ** 2).sum()


def normal_model():
    x = npt.sample("x", dist.Normal(0.0, 1.0).expand([3]))
    npt.sample("obs", dist.Normal(x, 1.0), obs=torch.ones(3))


@pytest.mark.parametrize("chains", [1, 4])
def test_barker_gaussian(chains):
    """JAX's cases: one chain 1,000 + 6,000 and four chains 1,000 + 2,000
    (here 500 + 1,000 on four)."""
    warmup, samples = (1000, 6000) if chains == 1 else (500, 1000)
    m = MCMC(BarkerMH(potential_fn=gaussian_potential), num_warmup=warmup, num_samples=samples,
             num_chains=chains, device="cpu")
    m.run(0, init_params=torch.zeros(chains) if chains > 1 else torch.tensor(0.0))
    s = m.get_samples()
    assert s.shape == (chains * samples,)
    assert abs(s.mean().item() - TRUE_MEAN) < 0.15
    assert abs(s.std().item() - TRUE_STD) < 0.15


def test_sa_gaussian():
    """JAX's case: one chain, 2,000 + 12,000, pool 20; here four chains of
    1,000 + 3,000."""
    m = MCMC(SA(potential_fn=gaussian_potential, adapt_state_size=20), num_warmup=1000,
             num_samples=3000, num_chains=4, device="cpu")
    m.run(0, init_params=torch.zeros(4))
    s = m.get_samples()
    assert abs(s.mean().item() - TRUE_MEAN) < 0.15
    assert abs(s.std().item() - TRUE_STD) < 0.2


@pytest.mark.parametrize("dense_mass", [True, False])
def test_sa_vectorized_chains(dense_mass):
    m = MCMC(SA(potential_fn=gaussian_potential, adapt_state_size=16, dense_mass=dense_mass),
             num_warmup=1000, num_samples=2000, num_chains=4, device="cpu")
    m.run(0, init_params=torch.zeros((4, 2)))
    s = m.get_samples()
    assert s.shape == (8000, 2)
    assert abs(s.mean().item() - TRUE_MEAN) < 0.2
    assert abs(s.std().item() - TRUE_STD) < 0.3


@pytest.mark.parametrize("kernel_cls", [AIES, ESS])
def test_ensemble_gaussian(kernel_cls):
    """JAX's case: 10 chains, 1,000 + 3,000; here 500 + 1,500 (ESS 300 +
    1,000)."""
    warmup, samples = (500, 1500) if kernel_cls is AIES else (300, 1000)
    m = MCMC(kernel_cls(potential_fn=gaussian_potential), num_warmup=warmup, num_samples=samples,
             num_chains=10, device="cpu")
    m.run(0, init_params=torch.from_numpy(np.random.default_rng(9).standard_normal(10)
                                          .astype(np.float32)))
    s = m.get_samples()
    assert abs(s.mean().item() - TRUE_MEAN) < 0.2
    assert abs(s.std().item() - TRUE_STD) < 0.2


@pytest.mark.parametrize(
    "kernel_factory,n_chains,method,warmup,samples",
    [
        (lambda: BarkerMH(normal_model), 2, "sequential", 500, 1000),
        (lambda: SA(normal_model), 2, "sequential", 500, 1000),
        (lambda: AIES(normal_model), 12, "vectorized", 500, 500),
        (lambda: ESS(normal_model), 12, "vectorized", 300, 300),
    ],
    ids=["barker", "sa", "aies", "ess"],
)
def test_model_posterior(kernel_factory, n_chains, method, warmup, samples):
    """JAX's cases at 1,000 + 2,000 (one sequential chain for BarkerMH and
    SA); here two sequential chains and shorter runs.  The posterior is
    N(0.5, 1/sqrt(2)) per coordinate."""
    m = MCMC(kernel_factory(), num_warmup=warmup, num_samples=samples, num_chains=n_chains,
             chain_method=method, device="cpu")
    m.run(1)
    x = m.get_samples()["x"]
    assert x.shape == (n_chains * samples, 3)
    assert abs(x.mean().item() - 0.5) < 0.12


def test_multichain_inits_are_dispersed():
    kernel = BarkerMH(normal_model)
    state = kernel.init(torch.Generator().manual_seed(3), 10, None, (), {}, num_chains=4)
    assert torch.unique(state.z["x"][:, 0]).numel() == 4
