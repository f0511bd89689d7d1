"""Chains and data across processes in the port (``parallel/mesh.py``,
``MCMC(chain_method="parallel")``, pooled adaptation over ranks, the
data-sharded GLM op, sharded checkpoints and HMCECS), held against the
port's own one-process runs and the JAX package.

Two jobs run once per module, as subprocesses of gloo ranks on the CPU that
meet through a file store in a temporary directory
(``tests/torch_parallel_worker.py``): ``two`` (a chain mesh of two ranks)
and ``four`` (a 2 x 2 chains x data mesh).  Each job is killed and fails the
tests if it does not end within ``JOB_TIMEOUT`` seconds, or as soon as one
rank fails, so a hung collective cannot hang the suite.

Tolerances:

- a chain-sharded run (fused or per-step, pooled or not, padded or not, a
  resumed one, HMCECS, a checkpoint resumed from its file) against the
  one-process run of the same seed: bit for bit.  Every rank draws the full
  panel and keeps its rows, the loops end when every rank's chains are done,
  pooled statistics are computed on the gathered panel, and each chain's
  arithmetic here does not depend on how many chains share its panel (the
  plain GLM's ``X @ w`` included, at 4 against 8 chains).
- the pooled warmup on the JAX package's draws against the JAX package's
  pooled warmup with its chain axis sharded over 2 of 8 virtual devices:
  the adaptation state to rtol 1e-4 and atol 1e-5, the tolerance of
  ``test_torch_dense_mass.py``'s window end; the other float fields to
  ``test_torch_hmc_step.py``'s (rtol 1e-5, atol 1e-4), but the gradient,
  to atol ``GRAD_ATOL``: the two packages' float32 sums of the gradient
  differ in their last bits from the first evaluation (3e-5), the
  positions drift apart by up to 2.4e-5 over the 22 transitions, and the
  gradient moves by the potential's curvature (its Hessian's largest
  eigenvalue is at most 56 at this data) times that; integer and boolean
  fields exactly.
- the data-sharded GLM against a float64 sum over the whole data (of the
  same bf16 X and hi + lo w): loglik rtol 1e-6, and against the port's
  one-process op: ``glm.kernel_tolerances``.  The two data shards' float32
  partials add in float32, where one process sums every row's term in
  float64 and rounds once.  Against the JAX package's op on the whole data:
  the gradient to ``test_torch_glm.py``'s rtol 1e-3 and atol 1e-3, the
  loglik to ``JAX_LL_RTOL``: the JAX op sums the 32,768 padded terms in
  float32 and stands 1.2e-5 relative off the float64 sum at this shape
  (the port, sharded or not, 1e-7).
- a data-sharded NUTS run against the one-process run: the posterior means
  within 4 combined Monte-Carlo standard errors.  The sums above move the
  potential's last bits, and NUTS trajectories carry that apart within a
  few transitions (draws 0.11 apart at the end), so the two runs are two
  samples of one posterior.
- the diagnostics and the pooled step size over ranks against the JAX
  package's on the full panel: rtol 1e-5.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu.parallel as jparallel
from numpyro_tpu.infer import hmc as jhmc
from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch.diagnostics import effective_sample_size
from numpyro_tpu_torch.infer import NUTS
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.ops import glm
from numpyro_tpu_torch.parallel import chain_data_mesh, chain_mesh, initialize_distributed

import torch_parallel_worker as w

torch.set_num_threads(1)

JOB_TIMEOUT = 300
RTOL, ATOL = 1e-4, 1e-5
STATE_RTOL, STATE_ATOL, GRAD_ATOL = 1e-5, 1e-4, 5e-3
G_RTOL, G_ATOL, JAX_LL_RTOL = 1e-3, 1e-3, 2e-5
WORKER = Path(w.__file__)
REPO = WORKER.parent.parent


class Job:
    """The ranks of one job, started at once."""

    def __init__(self, name, world, out):
        self.name, self.world, self.out = name, world, out
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), str(WORKER.parent),
                                               os.environ.get("PYTHONPATH", "")]))
        store = out / f"{name}.store"
        self.logs = [open(out / f"{name}_{r}.log", "w") for r in range(world)]
        self.procs = [
            subprocess.Popen([sys.executable, str(WORKER), name, str(r), str(world), str(store),
                              str(out)], cwd=REPO, env=env, stdout=log, stderr=log)
            for r, log in enumerate(self.logs)
        ]
        self.start = time.time()
        self._results = None

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def results(self):
        """Every rank's results; fails if a rank fails or the job runs past
        its time."""
        if self._results is None:
            while any(p.poll() is None for p in self.procs):
                failed = [p for p in self.procs if p.poll() not in (None, 0)]
                if failed or time.time() - self.start > JOB_TIMEOUT:
                    break
                time.sleep(0.1)
            rcs = [p.poll() for p in self.procs]
            self.kill()
            if rcs != [0] * self.world:
                tails = "\n".join((self.out / f"{self.name}_{r}.log").read_text()[-3000:]
                                  for r in range(self.world))
                pytest.fail(f"job {self.name}: exit codes {rcs} after "
                            f"{time.time() - self.start:.0f} s\n{tails}")
            self._results = [torch.load(self.out / f"{self.name}_{r}.pt", weights_only=False)
                             for r in range(self.world)]
        return self._results


def _jax_pooled_run(out):
    """The JAX package's per-step pooled warmup on ``logistic_problem`` with
    its chain axis sharded over 2 of the 8 virtual devices; writes the keys
    of every step for the ranks and returns the states."""
    X, y, _, z0 = w.logistic_problem()
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def pe_j(z):
        logits = Xj @ z["w"] + z["b"]
        ll = -(jnp.logaddexp(0.0, -jnp.abs(logits)) + jnp.maximum(logits, 0.0) - logits * yj)
        return -ll.sum() + 0.5 * (z["w"] ** 2).sum() + 0.5 * z["b"] ** 2

    chains, num_warmup, steps, depths = w.JAX_RUN
    keys = random.split(random.PRNGKey(3), chains)
    init_j, sample_j = jhmc.hmc(potential_fn=pe_j, algo="NUTS")
    state = init_j({k: jnp.asarray(v) for k, v in z0.items()}, num_warmup, rng_key=keys,
                   pooled_adaptation=True, max_tree_depth=depths)
    state = jparallel.shard_chain_state(state, jparallel.chain_mesh(jax.devices()[:2]))
    step = jax.jit(sample_j)
    all_keys, states = [np.asarray(keys)], [state]
    for _ in range(steps):
        all_keys.append(np.asarray(state.rng_key))
        state = step(state)
        states.append(state)
    path = out / "jax_pooled.pt"
    torch.save({"keys": all_keys}, str(path) + ".partial")
    os.replace(str(path) + ".partial", path)
    assert len(states[-1].rng_key.sharding.device_set) == 2  # the chains stayed sharded
    return [jax.tree.map(np.asarray, s) for s in states]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    started = {"two": Job("two", 2, out), "four": Job("four", 4, out)}
    try:
        jax_states = _jax_pooled_run(out)
    except BaseException:
        (out / "jax_pooled.pt.failed").touch()
        for job in started.values():
            job.kill()
        raise
    yield {"jax_pooled": jax_states, **started}
    for job in started.values():
        job.kill()


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process runs of the scenarios, on this process."""
    return {
        "plain": w.fused_run(8, False, "vectorized"),
        "pooled": w.fused_run(8, True, "vectorized"),
        "padded": w.fused_run(7, False, "vectorized"),
        "per_step": w.per_step_run(8, "vectorized"),
        "per_step_padded": w.per_step_run(7, "vectorized"),
        "ecs": w.ecs_run("vectorized"),
    }


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and torch.equal(a, b)
    else:
        assert a == b


def test_initialize_distributed_is_a_no_op_in_one_process():
    assert jparallel.initialize_distributed() is None
    assert initialize_distributed() is None
    assert not torch.distributed.is_initialized()


def test_mesh_in_one_process():
    mesh = chain_mesh(device="cpu")
    assert mesh.shape == {"chains": 1} and mesh.groups == {"chains": None}
    grid = chain_data_mesh(device="cpu")
    assert grid.shape == {"chains": 1, "data": 1} and grid.coords == {"chains": 0, "data": 0}
    # a shape that does not match the world: JAX's assert, a ValueError here
    with pytest.raises(AssertionError):
        jparallel.chain_data_mesh(2, 1, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        chain_data_mesh(2, 1, device="cpu")


@pytest.mark.parametrize("job", ["two", "four"])
def test_mesh_helpers_on_ranks(jobs, job):
    res = jobs[job].results()
    for rank, r in enumerate(res):
        facts = r["mesh"]
        assert r["backend"] == "gloo" and facts["device"] == "cpu"
        if job == "two":
            assert facts["shape"] == {"chains": 2} and facts["axis_names"] == ("chains",)
            assert facts["coords"] == {"chains": rank} and facts["group_sizes"] == {"chains": 2}
            assert r["mismatch"] == "mesh 3x1 != 2 devices"
            assert r["rows"] == 4  # 7 chains padded to 8, four a rank
        else:
            assert facts["shape"] == {"chains": 2, "data": 2}
            assert facts["ranks"] == [[0, 1], [2, 3]]
            assert facts["coords"] == {"chains": rank // 2, "data": rank % 2}
            assert facts["group_sizes"] == {"chains": 2, "data": 2}
            assert r["mismatch"] == "mesh 3x1 != 4 devices"


@pytest.mark.parametrize("name", ["plain", "pooled", "padded"])
def test_chain_sharded_nuts_equals_vectorized(jobs, one_process, name):
    """Fused NUTS on covtype-shape data in split mode (the plain version),
    with and without pooled adaptation, and 7 chains padded to 8."""
    ref = one_process[name]
    chains = 7 if name == "padded" else 8
    assert ref["w"].shape == (chains, w.NUTS_RUN[1], w.GLM_SHAPE[1])
    for r in jobs["two"].results():
        _equal_trees(r[name], ref)
    if name == "pooled":  # one step size for every chain
        assert torch.equal(ref["step_size"], ref["step_size"][:1].expand_as(ref["step_size"]))


@pytest.mark.parametrize("name", ["per_step", "per_step_padded"])
def test_per_step_sharded_run_resumes_as_vectorized(jobs, one_process, name):
    """``MCMC.warmup`` then a run from ``post_warmup_state`` through the
    per-step loop, pooled: both sharded for 8 chains; for 7 the warmup is
    padded to 8 and the resumed run, which cannot be padded, runs unsharded
    with a warning, as in the JAX package."""
    ref = one_process[name]
    assert ref["warnings"] == []
    for r in jobs["two"].results():
        got = dict(r[name])
        said = got.pop("warnings")
        _equal_trees(got, {k: v for k, v in ref.items() if k != "warnings"})
        if name == "per_step":
            assert said == []
        else:
            assert any("padding the chain axis to 8" in m for m in said)
            assert any("running unsharded" in m for m in said)


def test_hmcecs_chain_sharded_equals_one_process(jobs, one_process):
    ref = one_process["ecs"]
    assert ref["idx"].shape == (w.ECS_RUN[4], w.ECS_RUN[2])
    for r in jobs["two"].results():
        _equal_trees(r["ecs"], ref)


def test_cross_chain_diagnostics_and_pooled_step_size_match_jax(jobs):
    panel = w.diagnostics_panel()
    r_hat, ess = jparallel.cross_chain_diagnostics({"x": jnp.asarray(panel)})["x"]
    pooled = jparallel.pooled_step_size(jnp.asarray(w.step_sizes()))
    for r in jobs["two"].results():
        got_r, got_ess = r["diagnostics"]
        np.testing.assert_allclose(got_r.numpy(), np.asarray(r_hat), rtol=1e-5)
        np.testing.assert_allclose(got_ess.numpy(), np.asarray(ess), rtol=1e-5)
        np.testing.assert_allclose(r["pooled_step_size"].numpy(), np.asarray(pooled), rtol=1e-5)


def test_sharded_checkpoint_resumes_bit_for_bit(jobs):
    """A state from ``shard_chain_state`` saved after three transitions,
    restored onto the full panel and sharded again, steps as the state in
    memory does; both equal the one-process per-step run."""
    kernel = NUTS(w.glm_model, max_tree_depth=3)
    data = w.glm_data()
    state = kernel.init(torch.Generator().manual_seed(4), 5, None, (data,), {}, num_chains=8)
    states = []
    for i in range(2 * w.CKPT_STEPS):
        state = kernel.sample(state, (data,), {})
        if i >= w.CKPT_STEPS - 1:
            states.append(state)
    for r in jobs["two"].results():
        ck = r["checkpoint"]
        assert ck["same"] and ck["rows"] == 4
        assert torch.equal(ck["z"], torch.stack([s.z["w"] for s in states]))
        assert torch.equal(ck["pe"], torch.stack([s.potential_energy for s in states]))


@pytest.mark.parametrize("kernel", ["CheesHMC", "AIES", "ESS", "SMC"])
def test_coupled_kernels_raise_under_two_chain_shards(jobs, kernel):
    for r in jobs["two"].results():
        message = r["coupled"][kernel]
        assert message is not None and "ROADMAP.md" in message


def test_pooled_warmup_on_jax_draws_matches_sharded_jax(jobs):
    """Warmup through the first window end (the pooled Welford merge) and
    two sampling transitions."""
    want = jobs["jax_pooled"]
    for r in jobs["two"].results():
        got = r["jax_pooled"]
        assert len(got) == len(want) == w.JAX_RUN[2] + 1
        for s_t, s_j in zip(got, want):
            assert int(s_t.i) == int(s_j.i)
            for field in ("num_steps", "diverging"):
                np.testing.assert_array_equal(getattr(s_t, field).numpy(), getattr(s_j, field))
            for field in ("potential_energy", "energy", "accept_prob", "mean_accept_prob"):
                np.testing.assert_allclose(getattr(s_t, field).numpy(), getattr(s_j, field),
                                           rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=field)
            for field, atol in (("z", STATE_ATOL), ("z_grad", GRAD_ATOL)):
                for site in ("w", "b"):
                    np.testing.assert_allclose(getattr(s_t, field)[site].numpy(),
                                               getattr(s_j, field)[site], rtol=STATE_RTOL,
                                               atol=atol, err_msg=f"{field}.{site}")
            for field in core.AdaptPanel._fields:
                np.testing.assert_allclose(
                    getattr(s_t.adapt_state, field).numpy(), getattr(s_j.adapt_state, field),
                    rtol=RTOL, atol=ATOL, err_msg=field)
        # the pooled step size is one for every chain
        ss = got[-1].adapt_state.step_size
        assert torch.equal(ss, ss[:1].expand_as(ss))


def test_data_sharded_glm_matches_jax(jobs):
    """2 x 2 mesh: each rank holds 4 of 8 chains and 1,000 or 1,001 of 2,001
    rows; one evaluation of every chain's loglik and gradient is one plain
    call and one all_reduce, and the gathered values are the whole data's."""
    X, y, _ = w.covtype_like(w.SHARDED_ROWS)
    W = w.glm_weights()
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype="split")
    ll_j, g_j = jax.vmap(jax.value_and_grad(jglm.bernoulli_logits_loglik),
                         in_axes=(0, None))(jnp.asarray(W), jd)
    td = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y), dtype="split")
    g_t, ll_t = torch.func.vmap(torch.func.grad_and_value(glm.bernoulli_logits_loglik),
                                in_dims=(0, None))(torch.from_numpy(W), td)
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances("split", w.SHARDED_ROWS)
    hi, lo = glm.split_hi_lo(torch.from_numpy(W))
    logits = (hi.double() + lo.double()) @ td.x_t[: td.d, : td.n].double()
    exact = -(torch.nn.functional.softplus(logits) - td.y_row[0, : td.n].double() * logits).sum(-1)
    for rank, r in enumerate(jobs["four"].results()):
        got = r["glm"]
        assert got["rows"] == ((0, 1000), (1000, 2001))[rank % 2]
        assert got["n"] == got["rows"][1] - got["rows"][0]
        assert got["all_reduce"] == 1 and got["plain"] == 1
        np.testing.assert_allclose(got["ll"].numpy(), exact.numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["ll"].numpy(), np.asarray(ll_j), rtol=JAX_LL_RTOL)
        np.testing.assert_allclose(got["grad"].numpy(), np.asarray(g_j), rtol=G_RTOL,
                                   atol=G_ATOL)
        np.testing.assert_allclose(got["ll"].numpy(), ll_t.detach().numpy(), rtol=ll_rtol)
        np.testing.assert_allclose(got["grad"].numpy(), g_t.numpy(), rtol=g_rtol, atol=g_atol)


def _mean_and_error(draws):
    """Posterior means of ``(C, n, D)`` draws and their Monte-Carlo errors."""
    flat = draws.reshape(-1, draws.shape[-1]).double()
    ess = effective_sample_size(draws.double())
    return flat.mean(0), flat.std(0) / ess.sqrt()


def test_data_sharded_pooled_nuts_on_a_2x2_mesh(jobs, one_process):
    """Pooled NUTS with its chains over the mesh's chains and its rows over
    its data: every rank gathers the same panel, a sample of the posterior
    that the one-process run samples."""
    res = [r["nuts"] for r in jobs["four"].results()]
    for r in res[1:]:
        _equal_trees(r, res[0])
    ref = one_process["pooled"]
    assert res[0]["w"].shape == ref["w"].shape and torch.isfinite(res[0]["w"]).all()
    (m1, e1), (m2, e2) = _mean_and_error(res[0]["w"]), _mean_and_error(ref["w"])
    assert ((m1 - m2).abs() <= 4 * (e1**2 + e2**2).sqrt()).all()
    assert not torch.equal(res[0]["w"], ref["w"])  # two samples, not one


# ---------------------------------------------------------------------------
# One process: the sharded draw source, chain shards, backend choice


def _shards(chains, padded, parts=2):
    from numpyro_tpu_torch.parallel.mesh import ChainShard

    return [ChainShard(i * padded // parts, (i + 1) * padded // parts, chains, padded, None)
            for i in range(parts)]


def _rows(*parts):
    """Draws with a leading chain axis side by side, one row a chain."""
    return torch.cat([p.reshape(p.shape[0], -1).double() for p in parts], 1)


def _idx(z):
    return torch.zeros(z.shape[0], 6, dtype=torch.int64)


DRAWS = {
    "normal": lambda d, z: d.normal(z),
    "start": lambda d, z: _rows(*d.start(z)),
    "tick": lambda d, z: _rows(*d.tick(z)),
    "uniform": lambda d, z: d.uniform(z),
    "hmc_start": lambda d, z: _rows(*d.hmc_start(z)),
    "block": lambda d, z: _rows(*d.block(_idx(z), 3, 2, 100)),
    "fork": lambda d, z: d.fork().normal(z),
    "normals": lambda d, z: _rows(d.normals((z.shape[0], 3, 2), z)),
    "randints": lambda d, z: d.randints(0, 9, (z.shape[0], 4), z),
    "gumbels": lambda d, z: d.gumbels((z.shape[0], 5), z),
    "exponentials": lambda d, z: d.exponentials((z.shape[0],), z),
}


@pytest.mark.parametrize("kind", list(DRAWS))
def test_sharded_draws_are_rows_of_the_full_panel(kind):
    """Each rank's draws are its rows of the one-process draws of the same
    seed, for every draw with a leading chain axis, twice in a row (the
    generators stay in step)."""
    z = torch.zeros(8, 3)
    full = core.GeneratorDraws(torch.Generator().manual_seed(11))
    ranks = [core.ShardedDraws(torch.Generator().manual_seed(11), s) for s in _shards(8, 8)]
    for _ in range(2):
        want = DRAWS[kind](full, z)
        got = torch.cat([DRAWS[kind](r, z[r.shard.start:r.shard.stop]) for r in ranks])
        assert torch.equal(got, want)
    assert all(torch.equal(r.generator.get_state(), full.generator.get_state()) for r in ranks)


def test_pad_rows_draw_from_a_generator_of_their_own():
    """7 chains padded to 8: the real rows are the 7-chain draws, and the
    main generator goes through the 7-chain run's states."""
    z = torch.zeros(4, 3)
    full = core.GeneratorDraws(torch.Generator().manual_seed(5))
    first, last = _shards(7, 8)
    ranks = [core.ShardedDraws(torch.Generator().manual_seed(5), first),
             core.ShardedDraws(torch.Generator().manual_seed(5), last,
                               torch.Generator().manual_seed(99))]
    got = torch.cat([r.normal(z) for r in ranks])
    assert torch.equal(got[:7], full.normal(torch.zeros(7, 3)))
    assert torch.equal(ranks[1].generator.get_state(), full.generator.get_state())
    assert first.num_real == 4 and last.num_real == 3
    assert torch.equal(last.take(torch.arange(7)), torch.tensor([4, 5, 6, 0]))
    assert torch.equal(last.gather(torch.arange(4)), torch.arange(4))  # no group: as it is
    with pytest.raises(ValueError, match="pad generator"):
        core.ShardedDraws(torch.Generator(), last).normal(z)


def test_draws_without_a_chain_axis_raise_under_sharding():
    d = core.ShardedDraws(torch.Generator().manual_seed(0), _shards(8, 8)[0])
    z = torch.zeros(4, 2)
    with pytest.raises(NotImplementedError, match="leading axis"):
        d.uniforms((3,), z)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        d.choice(torch.ones(3))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        d.categorical(torch.ones(3), (2,))


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda:0", 2, 1, "gloo"), ("cuda:0", 2, 2, "nccl"),
    ("cuda:0", 4, 2, "gloo"),
])
def test_backend_choice(monkeypatch, device, local_world, cards, want):
    from numpyro_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh_lib._backend_for(torch.device(device), local_world) == want


def test_glm_data_rows_must_be_sharded_alike():
    X, y, _ = w.covtype_like(64)
    mesh = chain_data_mesh(device="cpu")
    from numpyro_tpu_torch.parallel import shard_data

    Xs = shard_data(torch.from_numpy(X), mesh)
    assert Xs.data_shard.group is None and Xs.shape == X.shape
    with pytest.raises(ValueError, match="same rows"):
        glm.prepare_glm_data(Xs, torch.from_numpy(y), dtype="split")
    data = glm.prepare_glm_data(Xs, shard_data(torch.from_numpy(y), mesh), dtype="split")
    assert data.group is None and data.n == 64
