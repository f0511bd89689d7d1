"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``).

    python tests/torch_parallel_worker.py JOB RANK WORLD STORE OUT

joins a gloo process group of ``WORLD`` ranks through the file store
``STORE``, runs every scenario of ``JOB`` (``two``: a chain mesh of two
ranks; ``four``: a 2 x 2 chains x data mesh) and writes what each gives to
``OUT/JOB_RANK.pt``.  The test holds those results against the port's
one-process runs and the JAX package; the problems of both sides are made
here, from numpy seeds, and imported by the test.  Only the scenario fed
the JAX package's draws imports JAX (its keys come from the test, through
``OUT/jax_pooled.pt``).
"""

import datetime
import os
import sys
import time
import traceback
import warnings

import numpy as np
import torch

torch.set_num_threads(1)

import numpyro_tpu_torch as npt  # noqa: E402
import numpyro_tpu_torch.distributions as dist  # noqa: E402
from numpyro_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from numpyro_tpu_torch.infer import AIES, ESS, HMCECS, MCMC, NUTS, SMC, CheesHMC  # noqa: E402
from numpyro_tpu_torch.infer import hmc as thmc  # noqa: E402
from numpyro_tpu_torch.infer import hmc_core as core  # noqa: E402
from numpyro_tpu_torch.ops import glm  # noqa: E402
from numpyro_tpu_torch.parallel import (  # noqa: E402
    chain_data_mesh, chain_mesh, cross_chain_diagnostics, initialize_distributed,
    pooled_step_size, shard_chain_state, shard_data,
)
from numpyro_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from numpyro_tpu_torch.util import tree_leaves  # noqa: E402

# the covtype-shape problem: rows, coefficients with the intercept, chains
GLM_SHAPE = (2000, 9, 8)
# warmup, samples and tree depth of the NUTS runs (20 warmup transitions
# have one middle window, so the pooled Welford merge runs once)
NUTS_RUN = (20, 10, 4)
# the data-sharded GLM: rows (odd, so the two data shards differ by one)
SHARDED_ROWS = 2001
# HMCECS: rows, coefficients, subsample, blocks, chains, warmup, samples
ECS_RUN = (64, 4, 16, 4, 8, 5, 5)
# the per-step run on the JAX package's draws: chains, warmup, steps, depths
JAX_RUN = (8, 20, 22, (3, 4))
JAX_PROBLEM = (200, 4)  # rows, coefficients of the logistic potential
CKPT_STEPS = 3


def covtype_like(n=GLM_SHAPE[0], d=GLM_SHAPE[1], seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, d - 1)), np.ones((n, 1))], 1).astype(np.float32)
    w0 = (0.5 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w0))).astype(np.float32)
    return X, y, w0


def glm_model(data):
    w = npt.sample("w", dist.Normal(torch.zeros(data.d), 1.0).to_event(1))
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


def glm_data(mesh=None, n=GLM_SHAPE[0]):
    X, y, _ = covtype_like(n)
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    if mesh is not None:
        X, y = shard_data(X, mesh), shard_data(y, mesh)
    return glm.prepare_glm_data(X, y, dtype="split")


def nuts_mcmc(chains, pooled, chain_method, mesh=None, device="cpu"):
    warmup, samples, depth = NUTS_RUN
    return MCMC(NUTS(glm_model, max_tree_depth=depth, pooled_adaptation=pooled),
                num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method=chain_method, mesh=mesh, device=device)


def fused_run(chains, pooled, chain_method, mesh=None, data=None):
    """A fused NUTS run: its draws, divergences and step sizes."""
    m = nuts_mcmc(chains, pooled, chain_method, mesh)
    m.run(1, glm_data() if data is None else data, extra_fields=("adapt_state.step_size",))
    fields = m.get_extra_fields(group_by_chain=True)
    return {"w": m.get_samples(group_by_chain=True)["w"], "diverging": fields["diverging"],
            "step_size": fields["adapt_state.step_size"],
            "num_divergent_warmup": m.last_run_stats["num_divergent_warmup"],
            "last_z": m.last_state.z["w"], "last_adapt": m.last_state.adapt_state}


def per_step_run(chains, chain_method, mesh=None):
    """Warmup, then sampling resumed from ``post_warmup_state`` through the
    per-step loop (``potential_energy`` is not a fused field), with the
    warnings the run gave."""
    m = nuts_mcmc(chains, True, chain_method, mesh)
    data = glm_data()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m.warmup(2, data)
        warm = m.post_warmup_state
        m.run(2, data, extra_fields=("potential_energy",))
    return {"w": m.get_samples(group_by_chain=True)["w"],
            "pe": m.get_extra_fields(group_by_chain=True)["potential_energy"],
            "warm_z": warm.z["w"], "warm_step_size": warm.adapt_state.step_size,
            "generator_state": m.last_state.rng_key.get_state(),
            "warnings": [str(c.message) for c in caught]}


def ecs_problem():
    n, d, sub = ECS_RUN[:3]
    rng = np.random.default_rng(5)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, d)))).astype(np.float32)

    def model(X, y):
        w = npt.sample("w", dist.Normal(torch.zeros(d), 1.0).to_event(1))
        with npt.plate("N", X.shape[0], subsample_size=sub):
            xb = npt.subsample(X, event_dim=1)
            yb = npt.subsample(y, event_dim=0)
            npt.sample("y", dist.Bernoulli(logits=xb @ w), obs=yb)

    return model, torch.from_numpy(X), torch.from_numpy(y)


def ecs_run(chain_method, mesh=None):
    model, X, y = ecs_problem()
    _, _, _, blocks, chains, warmup, samples = ECS_RUN
    m = MCMC(HMCECS(NUTS(model, max_tree_depth=3), num_blocks=blocks), num_warmup=warmup,
             num_samples=samples, num_chains=chains, chain_method=chain_method, mesh=mesh,
             device="cpu")
    m.run(3, X, y, extra_fields=("accept_prob",))
    return {"w": m.get_samples(group_by_chain=True)["w"],
            "accept_prob": m.get_extra_fields(group_by_chain=True)["accept_prob"],
            "idx": m.last_state.z["N"]}


def logistic_problem(chains=JAX_RUN[0], seed=0):
    """The logistic potential of ``test_torch_hmc_step`` (sites ``b`` and
    ``w``) at ``chains`` chains: the numpy data, the port's potential and
    the starting points."""
    n, d = JAX_PROBLEM
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, d)))).astype(np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)

    def pe_t(z):
        logits = Xt @ z["w"] + z["b"]
        ll = -(torch.logaddexp(torch.zeros_like(logits), -logits.abs())
               + logits.clamp(min=0.0) - logits * yt)
        return -ll.sum() + 0.5 * (z["w"] ** 2).sum() + 0.5 * z["b"] ** 2

    z0 = {"w": (0.3 * rng.standard_normal((chains, d))).astype(np.float32),
          "b": (0.3 * rng.standard_normal(chains)).astype(np.float32)}
    return X, y, pe_t, z0


def diagnostics_panel():
    return np.random.default_rng(7).standard_normal((8, 50, 3)).astype(np.float32).cumsum(1)


def step_sizes():
    return np.random.default_rng(8).uniform(0.05, 0.5, 8).astype(np.float32)


def glm_weights():
    d, c = GLM_SHAPE[1], GLM_SHAPE[2]
    return (0.3 * np.random.default_rng(9).standard_normal((c, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# Scenarios of the two-rank job


def mesh_facts(mesh):
    return {"shape": dict(mesh.shape), "axis_names": mesh.axis_names, "coords": mesh.coords,
            "ranks": mesh.ranks.tolist(), "device": str(mesh.device),
            "group_sizes": {k: None if g is None else torch.distributed.get_world_size(g)
                            for k, g in mesh.groups.items()}}


def raises(fn, kind):
    try:
        fn()
    except kind as e:
        return str(e)
    return None


def checkpoint_resume(mesh, path):
    """Per-step NUTS on a state from ``shard_chain_state``: a sharded
    checkpoint after ``CKPT_STEPS`` transitions, then the same transitions
    from memory and from the file."""
    chains = GLM_SHAPE[2]
    kernel = NUTS(glm_model, max_tree_depth=3)
    data = glm_data()
    full = kernel.init(torch.Generator().manual_seed(4), 5, None, (data,), {}, num_chains=chains)
    state = shard_chain_state(full, mesh)
    for _ in range(CKPT_STEPS):
        state = kernel.sample(state, (data,), {})
    save_checkpoint(path, state)
    memory = [state]
    for _ in range(CKPT_STEPS):
        memory.append(kernel.sample(memory[-1], (data,), {}))
    restored = shard_chain_state(restore_checkpoint(path, full), mesh)
    resumed = [restored]
    for _ in range(CKPT_STEPS):
        resumed.append(kernel.sample(resumed[-1], (data,), {}))
    same = all(torch.equal(a, b) for m, r in zip(memory, resumed)
               for a, b in zip(tree_leaves(m), tree_leaves(r)))
    gathered = [core.gather_state(s) for s in memory]
    return {"same": same, "rows": state.z["w"].shape[0],
            "z": torch.stack([g.z["w"] for g in gathered]),
            "pe": torch.stack([g.potential_energy for g in gathered])}


class ShardedJaxDraws:
    """The draw-source protocol fed from the JAX package's per-chain keys
    (split as its engine splits them, as ``test_torch_hmc_step.JaxDraws``
    does), every draw made for the full panel and this rank's rows kept."""

    generator = torch.Generator().manual_seed(0)

    def __init__(self, keys, shard):
        self.keys, self.shard = keys, shard

    def _rows(self, x):
        return torch.from_numpy(np.array(x, dtype=np.float32))[self.shard.start:self.shard.stop]

    def normal(self, like):
        from numpyro_tpu.infer import hmc_core as jc

        self.keys, k = jc.split_keys(self.keys, 2)
        return self._rows(jc.batch_normal(k, like.shape[1]))

    def start(self, like):
        from numpyro_tpu.infer import hmc_core as jc

        self.keys, k_mom, k_dir = jc.split_keys(self.keys, 3)
        return self._rows(jc.batch_normal(k_mom, like.shape[1])), \
            self._rows(jc.batch_rademacher(k_dir))

    def tick(self, like):
        from numpyro_tpu.infer import hmc_core as jc

        self.keys, k_swap, k_merge, k_dir = jc.split_keys(self.keys, 4)
        return (self._rows(jc.batch_uniform(k_swap)), self._rows(jc.batch_uniform(k_merge)),
                self._rows(jc.batch_rademacher(k_dir)))

    def fork(self):
        from numpyro_tpu.infer import hmc_core as jc

        self.keys, adapt_keys = jc.split_keys(self.keys, 2)
        return ShardedJaxDraws(adapt_keys, self.shard)


def pooled_on_jax_draws(mesh, out):
    """The port's pooled warmup through the per-step API, each transition
    fed the JAX package's keys of that step (``OUT/jax_pooled.pt``)."""
    import jax.numpy as jnp

    path = os.path.join(out, "jax_pooled.pt")
    deadline = time.time() + 240
    while not os.path.exists(path):
        if time.time() > deadline or os.path.exists(path + ".failed"):
            raise RuntimeError("the test did not write the JAX package's keys")
        time.sleep(0.2)
    keys = torch.load(path, weights_only=False)["keys"]
    chains, num_warmup, steps, depths = JAX_RUN
    _, _, pe_t, z0 = logistic_problem()
    shard = mesh.chain_shard(chains)
    init_t, sample_t = thmc.hmc(potential_fn=pe_t, algo="NUTS")
    state = init_t({k: torch.from_numpy(v)[shard.start:shard.stop] for k, v in z0.items()},
                   num_warmup, rng_key=ShardedJaxDraws(jnp.asarray(keys[0]), shard),
                   num_chains=shard.size, pooled_adaptation=True, max_tree_depth=depths)
    states = [core.gather_state(state)]
    for i in range(steps):
        state = sample_t(state._replace(rng_key=ShardedJaxDraws(jnp.asarray(keys[i + 1]), shard)))
        states.append(core.gather_state(state))
    return [s._replace(rng_key=None) for s in states]


def job_two(rank, out):
    mesh = chain_mesh(device="cpu")
    res = {"backend": torch.distributed.get_backend(), "mesh": mesh_facts(mesh)}
    res["mismatch"] = raises(lambda: chain_data_mesh(3, 1, device="cpu"), ValueError)
    res["rows"] = chain_data_mesh(device="cpu").chain_shard(7, 8).size
    for name, chains, pooled in (("plain", 8, False), ("pooled", 8, True), ("padded", 7, False)):
        res[name] = fused_run(chains, pooled, "parallel", mesh)
    res["per_step"] = per_step_run(8, "parallel", mesh)
    res["per_step_padded"] = per_step_run(7, "parallel", mesh)
    res["ecs"] = ecs_run("parallel", mesh)
    shard = mesh.chain_shard(8)
    panel = torch.from_numpy(diagnostics_panel())
    res["diagnostics"] = cross_chain_diagnostics({"x": shard.take(panel)}, mesh)["x"]
    adapt = core.AdaptPanel(*([shard.take(torch.from_numpy(step_sizes()))]
                              + [None] * (len(core.AdaptPanel._fields) - 1)))
    res["pooled_step_size"] = pooled_step_size(adapt, mesh)
    res["checkpoint"] = checkpoint_resume(mesh, os.path.join(out, "ckpt.pt"))
    kernels = {"CheesHMC": CheesHMC(model=glm_model), "AIES": AIES(model=glm_model),
               "ESS": ESS(model=glm_model)}
    res["coupled"] = {
        name: raises(lambda k=k: MCMC(k, num_warmup=2, num_samples=2, num_chains=8,
                                      chain_method="parallel", mesh=mesh).run(0, glm_data()),
                     NotImplementedError)
        for name, k in kernels.items()
    }
    res["coupled"]["SMC"] = raises(lambda: SMC(glm_model, device="cpu").run(0, glm_data()),
                                   NotImplementedError)
    res["jax_pooled"] = pooled_on_jax_draws(mesh, out)
    return res


def job_four(rank, out):
    mesh = chain_data_mesh(2, 2, device="cpu")
    res = {"backend": torch.distributed.get_backend(), "mesh": mesh_facts(mesh)}
    res["mismatch"] = raises(lambda: chain_data_mesh(3, None, device="cpu"), ValueError)
    X, y, _ = covtype_like(SHARDED_ROWS)
    Xs, ys = shard_data(torch.from_numpy(X), mesh), shard_data(torch.from_numpy(y), mesh)
    data = glm.prepare_glm_data(Xs, ys, dtype="split")
    shard = mesh.chain_shard(GLM_SHAPE[2])
    w = shard.take(torch.from_numpy(glm_weights()))
    mesh_lib.reset_collective_counts()
    glm.reset_launch_counts()
    g, ll = torch.func.vmap(torch.func.grad_and_value(glm.bernoulli_logits_loglik),
                            in_dims=(0, None))(w, data)
    res["glm"] = {"rows": (Xs.data_shard.start, Xs.data_shard.stop), "n": data.n,
                  "all_reduce": mesh_lib.collective_counts["all_reduce"],
                  "plain": glm.launch_counts["plain"],
                  "ll": shard.gather(ll), "grad": shard.gather(g)}
    res["nuts"] = fused_run(8, True, "parallel", mesh, glm_data(mesh))
    return res


def main():
    job, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    initialize_distributed(f"file://{store}", world, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=120))
    try:
        res = {"two": job_two, "four": job_four}[job](rank, out)
        torch.save(res, os.path.join(out, f"{job}_{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # a rank that fails must not wait for the others
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
