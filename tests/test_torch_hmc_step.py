"""The per-step kernel API of the port (``hmc()``'s ``init_kernel`` and
``sample_kernel``, ``HMC.init``/``HMC.sample``, the ``_per_chain`` channel
and ``MCMC``'s loop over ``sample``) against the JAX package's, on the
same numpy inputs and fed JAX's own random draws (state fields to rtol 1e-5
beside the atol given at each comparison)."""

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
from numpyro_tpu.infer import MCMC as JMCMC, NUTS as JNUTS
from numpyro_tpu.infer import hmc as jhmc
from numpyro_tpu.infer import hmc_core as jc
from numpyro_tpu_torch.infer import HMC, MCMC, NUTS
from numpyro_tpu_torch.infer import hmc as thmc
from numpyro_tpu_torch.infer import hmc_core as core

torch.set_num_threads(1)

N, D, C = 200, 4, 3
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


class JaxDraws:
    """The port's draw-source protocol, fed from JAX per-chain keys that are
    split exactly as the JAX engine splits them (``hmc_core.py:414``, ``:452``,
    ``:658``, ``:764`` and ``hmc.py:297``)."""

    generator = torch.Generator().manual_seed(0)

    def __init__(self, keys):
        self.keys = keys

    def normal(self, like):
        self.keys, k = jc.split_keys(self.keys, 2)
        return _t(jc.batch_normal(k, like.shape[1]))

    def start(self, like):
        self.keys, k_mom, k_dir = jc.split_keys(self.keys, 3)
        return _t(jc.batch_normal(k_mom, like.shape[1])), _t(jc.batch_rademacher(k_dir))

    def tick(self, like):
        self.keys, k_swap, k_merge, k_dir = jc.split_keys(self.keys, 4)
        return (_t(jc.batch_uniform(k_swap)), _t(jc.batch_uniform(k_merge)),
                _t(jc.batch_rademacher(k_dir)))

    def hmc_start(self, like):
        self.keys, k_mom, k_acc = jc.split_keys(self.keys, 3)
        return _t(jc.batch_normal(k_mom, like.shape[1])), _t(jc.batch_uniform(k_acc))

    def fork(self):
        self.keys, adapt_keys = jc.split_keys(self.keys, 2)
        return JaxDraws(adapt_keys)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, D)))).astype(np.float32)
    Xj, yj, Xt, yt = jnp.asarray(X), jnp.asarray(y), torch.from_numpy(X), torch.from_numpy(y)

    def pe_j(z):
        logits = Xj @ z["w"] + z["b"]
        ll = -(jnp.logaddexp(0.0, -jnp.abs(logits)) + jnp.maximum(logits, 0.0) - logits * yj)
        return -ll.sum() + 0.5 * (z["w"] ** 2).sum() + 0.5 * z["b"] ** 2

    def pe_t(z):
        logits = Xt @ z["w"] + z["b"]
        ll = -(torch.logaddexp(torch.zeros_like(logits), -logits.abs())
               + logits.clamp(min=0.0) - logits * yt)
        return -ll.sum() + 0.5 * (z["w"] ** 2).sum() + 0.5 * z["b"] ** 2

    z0 = {"w": (0.3 * rng.standard_normal((C, D))).astype(np.float32),
          "b": (0.3 * rng.standard_normal(C)).astype(np.float32)}
    return pe_j, pe_t, z0


def _compare_states(s_t, s_j, atol=1e-4):
    assert int(s_t.i) == int(s_j.i)
    for field in ("num_steps", "diverging"):
        np.testing.assert_array_equal(
            getattr(s_t, field).numpy(), np.asarray(getattr(s_j, field)), err_msg=field
        )
    for field in ("potential_energy", "energy", "accept_prob", "mean_accept_prob"):
        np.testing.assert_allclose(
            getattr(s_t, field).numpy(), np.asarray(getattr(s_j, field)),
            rtol=RTOL, atol=atol, err_msg=field,
        )
    for field in ("z", "z_grad"):
        for name in ("w", "b"):
            np.testing.assert_allclose(
                getattr(s_t, field)[name].numpy(), np.asarray(getattr(s_j, field)[name]),
                rtol=RTOL, atol=atol, err_msg=f"{field}.{name}",
            )
    for field in core.AdaptPanel._fields:
        np.testing.assert_allclose(
            getattr(s_t.adapt_state, field).numpy(), np.asarray(getattr(s_j.adapt_state, field)),
            rtol=1e-4, atol=atol, err_msg=f"adapt_state.{field}",
        )
    assert s_t.r is None and s_j.r is None
    assert s_t.trajectory_length == s_j.trajectory_length


def _run_both(algo, batched, steps=5, num_warmup=3, **options):
    """``init`` and ``steps`` transitions in both packages; before every call
    the port's state is handed JAX's keys of that moment."""
    pe_j, pe_t, z0 = _problem()
    if not batched:
        z0 = {k: v[0] for k, v in z0.items()}
    keys = random.split(random.PRNGKey(3), C) if batched else random.PRNGKey(3)
    init_j, sample_j = jhmc.hmc(potential_fn=pe_j, algo=algo)
    init_t, sample_t = thmc.hmc(potential_fn=pe_t, algo=algo)
    s_j = init_j({k: jnp.asarray(v) for k, v in z0.items()}, num_warmup, rng_key=keys, **options)
    s_t = init_t(
        {k: torch.from_numpy(np.asarray(v)) for k, v in z0.items()}, num_warmup,
        rng_key=JaxDraws(keys if batched else keys[None]),
        num_chains=C if batched else None, **options,
    )
    pairs = [(s_t, s_j)]
    step_j = jax.jit(sample_j)
    for _ in range(steps):
        k = s_j.rng_key
        s_t = s_t._replace(rng_key=JaxDraws(k if batched else k[None]))
        s_j = step_j(s_j)
        s_t = sample_t(s_t)
        pairs.append((s_t, s_j))
    return pairs


def test_nuts_steps_match_jax_batched():
    pairs = _run_both("NUTS", True, max_tree_depth=(3, 5))
    assert pairs[0][0].z["w"].shape == (C, D) and pairs[0][0].potential_energy.shape == (C,)
    for s_t, s_j in pairs:
        _compare_states(s_t, s_j)
    assert int(np.asarray(pairs[-1][1].num_steps).max()) > 3  # real trees
    # the depth cap of warmup held while i < num_warmup, the other after
    assert max(int(s_j.num_steps.max()) for _, s_j in pairs[1:4]) <= 7


def test_nuts_steps_match_jax_single_chain():
    pairs = _run_both("NUTS", False, max_tree_depth=4)
    assert pairs[0][0].z["w"].shape == (D,) and pairs[0][0].potential_energy.shape == ()
    assert pairs[-1][0].adapt_state.step_size.shape == ()
    for s_t, s_j in pairs:
        _compare_states(s_t, s_j)


@pytest.mark.parametrize("batched", [True, False])
def test_hmc_steps_match_jax(batched):
    pairs = _run_both("HMC", batched, trajectory_length=1.0)
    for s_t, s_j in pairs:
        _compare_states(s_t, s_j)
    steps = np.asarray(pairs[-1][1].num_steps)
    assert steps.min() >= 2  # ceil(trajectory_length / step_size) leapfrogs


def test_hmc_fixed_num_steps_and_fused_agree():
    """``num_steps`` fixes the leapfrog count, and the per-step API and the
    fused run, drawing from generators in the same state, give the same draws."""

    def model():
        npt.sample("x", dist.Normal(torch.tensor([1.0, -2.0]), torch.tensor([0.5, 2.0])).to_event(1))

    runs = []
    for extra in ((), ("potential_energy",)):  # fused; per-step
        mcmc = MCMC(HMC(model, num_steps=4, step_size=0.3), num_warmup=20, num_samples=30,
                    num_chains=3, device="cpu")
        mcmc.run(5, extra_fields=("num_steps",) + extra)
        assert bool((mcmc.get_extra_fields()["num_steps"] == 4).all())
        runs.append(mcmc.get_samples(group_by_chain=True)["x"])
    assert runs[0].shape == (3, 30, 2)
    np.testing.assert_allclose(runs[0].numpy(), runs[1].numpy(), rtol=1e-6)


def test_per_chain_channel_gives_each_chain_its_own_conditioning():
    """``model_kwargs["_per_chain"]`` is sliced per chain beside the position
    panel: with a per-chain target location every chain samples its own."""
    locs = torch.tensor([-5.0, 0.0, 5.0, 10.0])

    def gen(*args, loc=None, scale=1.0):
        return lambda z: 0.5 * (((z["x"] - loc) / scale) ** 2).sum()

    init, sample = thmc.hmc(potential_fn_gen=gen, algo="NUTS")
    gen_t = torch.Generator().manual_seed(0)
    kwargs = {"scale": 0.5, "_per_chain": {"loc": locs}}
    state = init({"x": torch.zeros(4, 2)}, 30, rng_key=gen_t, num_chains=4, model_kwargs=kwargs)
    # at x = 0 the potential of chain c is |loc_c|^2 / scale^2
    np.testing.assert_allclose(state.potential_energy.numpy(), (4 * locs**2).numpy(), rtol=1e-6)
    draws = []
    for i in range(80):
        state = sample(state, (), kwargs)
        if i >= 30:
            draws.append(state.z["x"])
    mean = torch.stack(draws).mean((0, 2))
    np.testing.assert_allclose(mean.numpy(), locs.numpy(), atol=0.4)
    # the same through JAX's channel, for the meaning of the argument
    def jgen(*args, loc=None, scale=1.0):
        return lambda z: 0.5 * (((z["x"] - loc) / scale) ** 2).sum()

    jinit, _ = jhmc.hmc(potential_fn_gen=jgen, algo="NUTS")
    s_j = jinit({"x": jnp.zeros((4, 2))}, 30, rng_key=random.split(random.PRNGKey(0), 4),
                model_kwargs={"scale": 0.5, "_per_chain": {"loc": jnp.asarray(locs.numpy())}})
    np.testing.assert_allclose(np.asarray(s_j.potential_energy), (4 * locs**2).numpy(), rtol=1e-6)


def jax_model(X, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    numpyro_tpu.sample("obs", jdist.Bernoulli(logits=X @ w), obs=y)


def torch_model(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    npt.sample("obs", dist.Bernoulli(logits=X @ w), obs=y)


def test_per_step_loop_collects_the_same_fields_as_jax():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, D)))).astype(np.float32)
    extra = ("potential_energy", "adapt_state.step_size", "num_steps")
    warmup, samples, thin = 30, 40, 3
    jm = JMCMC(JNUTS(jax_model, max_tree_depth=5), num_warmup=warmup, num_samples=samples,
               num_chains=C, thinning=thin, chain_method="vectorized", progress_bar=False)
    jm.run(random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), extra_fields=extra)
    tm = MCMC(NUTS(torch_model, max_tree_depth=5), num_warmup=warmup, num_samples=samples,
              num_chains=C, thinning=thin, device="cpu")
    tm.run(0, torch.from_numpy(X), torch.from_numpy(y), extra_fields=extra)
    for grouped in (True, False):
        f_j, f_t = jm.get_extra_fields(group_by_chain=grouped), tm.get_extra_fields(group_by_chain=grouped)
        assert set(f_t) == set(f_j) == set(extra) | {"diverging"}
        for name in f_j:
            assert tuple(f_t[name].shape) == tuple(f_j[name].shape), name
        s_j, s_t = jm.get_samples(group_by_chain=grouped), tm.get_samples(group_by_chain=grouped)
        assert tuple(s_t["w"].shape) == tuple(s_j["w"].shape)
    assert tm.get_samples(group_by_chain=True)["w"].shape == (C, 13, D)
    stats = tm.last_run_stats
    assert {"init_s", "warmup_s", "sample_s", "total_s", "potential_evals"} <= set(stats)
    assert stats["potential_evals"] == (
        stats["potential_evals_init"] + stats["potential_evals_warmup"]
        + stats["potential_evals_sample"]
    )
    assert int(tm.last_state.i) == int(jm.last_state.i) == warmup + samples
    # two posteriors of the same model, with different random numbers
    w_j = np.asarray(jm.get_samples()["w"])
    w_t = tm.get_samples()["w"].numpy()
    np.testing.assert_allclose(w_t.mean(0), w_j.mean(0), atol=0.15)
    # the step size stops adapting after warmup
    ss = tm.get_extra_fields(group_by_chain=True)["adapt_state.step_size"]
    assert bool((ss == ss[:, :1]).all())


def test_warmup_then_run_resumes_from_post_warmup_state():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    args = (torch.from_numpy(X), torch.from_numpy(y))
    tm = MCMC(NUTS(torch_model, max_tree_depth=4), num_warmup=15, num_samples=10, num_chains=2,
              device="cpu")
    gen = torch.Generator().manual_seed(0)
    tm.warmup(gen, *args, collect_warmup=True)
    assert tm.get_samples(group_by_chain=True)["w"].shape == (2, 15, D)
    warm = tm.post_warmup_state
    assert int(warm.i) == 15
    tm.run(gen, *args)
    assert tm.get_samples(group_by_chain=True)["w"].shape == (2, 10, D)
    assert int(tm.last_state.i) == 25
    np.testing.assert_array_equal(
        tm.last_state.adapt_state.step_size.numpy(), warm.adapt_state.step_size.numpy()
    )
    assert "init_s" not in tm.last_run_stats and "warmup_s" not in tm.last_run_stats


def test_single_chain_through_the_per_step_loop():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    kernel = NUTS(torch_model, max_tree_depth=4)
    tm = MCMC(kernel, num_warmup=10, num_samples=8, num_chains=1, device="cpu")
    tm.run(0, torch.from_numpy(X), torch.from_numpy(y), extra_fields=("potential_energy",))
    assert tm.get_samples(group_by_chain=True)["w"].shape == (1, 8, D)
    assert tm.last_state.z["w"].shape == (D,)  # one chain: unbatched state
    assert "steps of size" in kernel.get_diagnostics_str(tm.last_state)


def test_unported_options_of_the_factory_raise():
    with pytest.raises(NotImplementedError):
        thmc.hmc(potential_fn=lambda z: 0.0, kinetic_fn=lambda *a: 0.0)
    with pytest.raises(ValueError):
        thmc.hmc(potential_fn=lambda z: 0.0, algo="SA")
    with pytest.raises(ValueError):
        thmc.hmc()
