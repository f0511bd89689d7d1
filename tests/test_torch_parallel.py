"""Chains and data across processes in the port (``parallel/mesh.py``,
``MCMC(chain_method="parallel")``, pooled adaptation over ranks, the
data-sharded GLM op in its three modes, sharded checkpoints, HMCECS with its
chains and its data sharded, the shard-aware ``subsample``, ChEES and the
ensembles), held against the port's own one-process runs and the JAX
package.

Two jobs run once per module, as subprocesses of gloo ranks on the CPU that
meet through a file store in a temporary directory
(``tests/torch_parallel_worker.py``): ``two`` (a chain mesh of two ranks)
and ``four`` (a 2 x 2 chains x data mesh).  Each job is killed and fails the
tests if it does not end within ``JOB_TIMEOUT`` seconds, or as soon as one
rank fails, so a hung collective cannot hang the suite.

Tolerances:

- a chain-sharded run (fused or per-step, pooled or not, padded or not, a
  resumed one, HMCECS, a checkpoint resumed from its file, ChEES, AIES, ESS)
  against the one-process run of the same seed: bit for bit.  So is HMCECS
  without a proxy with its data sharded as well, and a data shard's
  subsample panels against the whole data's: each rank writes its rows of
  a panel into zeros and the panels are summed as integers of their bits.  Every rank draws the full
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
- HMCECS with the Taylor proxy and its data sharded against the one-process
  run: the proxy's whole-data sums (value, gradient, Hessian at the
  reference) are float32 sums of each rank's rows added over the group, in
  another order than one process's, so the potential and its gradient
  differ in their last bits (1.3e-7 relative here): ``ECS_PROXY_RTOL``.
  Everything else (indices, panels, per-point statistics) is exact.
- one HMCECS transition from the JAX package's state on its draws (the
  configuration of ``tests/parallel/test_ecs_sharded_data.py``): the
  sharded step against the port's one-process step on the same draws bit
  for bit, and against JAX's step as ``test_torch_hmc_gibbs.py`` holds one
  transition (potential rtol 1e-4, positions rtol 1e-4 and atol 1e-5, the
  gradient rtol 1e-4 and atol 1e-4 of its largest component, the accept
  probability rtol 1e-3 and atol 1e-4; indices and panels exactly).
- models over data shards that cut a whole latent to the rows (a latent a
  row) or gather the rows (lag slices, ``scan``, ``logsumexp`` and ``max``
  over them) against the JAX package on all 2,001 rows: potential rtol
  1e-5, gradient rtol 1e-4 and atol 1e-4 of its largest component, as
  above; ``Predictive`` of 16 draws over the rows against the port's
  one-process draws of the same generator bit for bit, and its mean
  against the JAX package's draws within 4 Monte-Carlo errors (the
  binomial spread of the draws' mean at the draws' probabilities).
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
import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu.infer import HMCECS as JHMCECS, NUTS as JNUTS
from numpyro_tpu.infer import hmc as jhmc
from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch.diagnostics import effective_sample_size
from numpyro_tpu_torch.infer import NUTS
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer.hmc_gibbs import ecs_state_from_numpy
from numpyro_tpu_torch.ops import glm
from numpyro_tpu_torch.parallel import chain_data_mesh, chain_mesh, initialize_distributed

import torch_parallel_worker as w
from test_torch_glm import MODES as GLM_MODES, _jax_reference
from test_torch_hmc_gibbs import JaxEcsDraws
from test_torch_hmc_step import JaxDraws as JaxInnerDraws

torch.set_num_threads(1)

JOB_TIMEOUT = 300
RTOL, ATOL = 1e-4, 1e-5
STATE_RTOL, STATE_ATOL, GRAD_ATOL = 1e-5, 1e-4, 5e-3
G_RTOL, G_ATOL, JAX_LL_RTOL = 1e-3, 1e-3, 2e-5
ECS_PROXY_RTOL = 1e-5
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


def _plain(tree):
    """A JAX state as nested dicts and tuples of numpy arrays, which a rank
    unpickles without the JAX package."""
    if hasattr(tree, "_fields"):
        return {k: _plain(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_plain(v) for v in tree)
    return None if tree is None else np.asarray(tree)


def _jax_ecs_step(out):
    """The JAX package's HMCECS in ``tests/parallel/test_ecs_sharded_data.py``'s
    configuration on ``w.ecs_data()``: init and one transition, so that every
    chain holds indices of its own, then one more transition.  The port
    steps from the same state on JAX's draws of that transition, recording
    them for the ranks (``OUT/ecs_jax.pt``).  Returns the port's state and
    JAX's, both after the compared transition."""
    X, y = w.ecs_data()
    n, d, sub = w.ECS_RUN[:3]
    chains, depth, warmup = w.ECS_JAX

    def jax_model(X, y):
        wv = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(d), 1.0).to_event(1))
        with numpyro_tpu.plate("N", n, subsample_size=sub):
            xb = numpyro_tpu.subsample(X, event_dim=1)
            yb = numpyro_tpu.subsample(y, event_dim=0)
            numpyro_tpu.sample("y", jdist.Bernoulli(logits=xb @ wv), obs=yb)

    args = (jnp.asarray(X), jnp.asarray(y))
    k_j = JHMCECS(JNUTS(jax_model, max_tree_depth=depth), num_blocks=w.ECS_RUN[3])
    step = jax.jit(lambda s: k_j.sample(s, args, {}))
    s_j = step(k_j.init(random.split(random.PRNGKey(5), chains), warmup, None, args, {}))
    state = _plain(jax.tree.map(np.asarray, s_j))
    model, Xt, yt = w.ecs_problem()
    k_t = w.ecs_jax_kernel(model)
    k_t.init(torch.Generator().manual_seed(0), warmup, None, (Xt, yt), {}, num_chains=chains)
    outer, inner = [], []
    s_t = ecs_state_from_numpy(state)
    s_t = s_t._replace(
        rng_key=w.RecordedDraws(JaxEcsDraws(s_j.rng_key), outer),
        hmc_state=s_t.hmc_state._replace(
            rng_key=w.RecordedDraws(JaxInnerDraws(s_j.hmc_state.rng_key), inner)))
    s_t = k_t.sample(s_t, (Xt, yt), {})
    path = out / "ecs_jax.pt"
    torch.save({"state": state, "outer": outer, "inner": inner}, str(path) + ".partial")
    os.replace(str(path) + ".partial", path)
    return s_t, jax.tree.map(np.asarray, step(s_j))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    started = {"two": Job("two", 2, out), "four": Job("four", 4, out)}
    try:
        jax_states = _jax_pooled_run(out)
    except BaseException:
        (out / "jax_pooled.pt.failed").touch()
        (out / "ecs_jax.pt.failed").touch()
        for job in started.values():
            job.kill()
        raise
    try:
        ecs_steps = _jax_ecs_step(out)
    except BaseException:
        (out / "ecs_jax.pt.failed").touch()
        for job in started.values():
            job.kill()
        raise
    yield {"jax_pooled": jax_states, "ecs_jax": ecs_steps, **started}
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
        "ecs_proxy": w.ecs_proxy_steps(),
        **{name: w.coupled_run(name, "vectorized") for name in w.COUPLED},
        "parity": {case: w.parity_potential(case) for case in w.PARITY},
        "shard_nuts": w.shard_nuts_run("vectorized"),
        "row_nuts": w.row_nuts_run("vectorized"),
        "row_predictive": w.row_predictive(),
        "ecs_carry": w.ecs_lean_run(None, "carry"),
        **{"padded_" + name: w.padded_ensemble_run(name) for name in w.PADDED},
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


@pytest.mark.parametrize("kernel", ["SMC"])
def test_coupled_kernels_raise_under_two_chain_shards(jobs, kernel):
    """SMC has no sharded path in the JAX package either."""
    for r in jobs["two"].results():
        message = r["smc"]
        assert message is not None and "ROADMAP.md" in message


@pytest.mark.parametrize("kernel", w.COUPLED)
def test_coupled_kernels_sharded_equal_one_process(jobs, one_process, kernel):
    """ChEES (8 chains, and 7 padded to 8) and AIES and ESS (20 walkers) with
    their chains over two ranks: the draws and the last state (the adapted
    step size, trajectory length and mass; the ensembles' accept and slice
    statistics) equal the one-process run's bit for bit."""
    ref = one_process[kernel]
    chains = (w.CHEES_RUN if kernel.startswith("CheesHMC") else w.ENSEMBLE_RUN)[0]
    assert ref["w"].shape[0] == chains - kernel.endswith("_padded")
    for r in jobs["two"].results():
        _equal_trees(r["coupled"][kernel], ref)


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


@pytest.mark.parametrize("mode", list(GLM_MODES))
def test_data_sharded_glm_matches_jax(jobs, mode):
    """2 x 2 mesh: each rank holds 4 of 8 chains and 1,000 or 1,001 of 2,001
    rows; one evaluation of every chain's loglik and gradient is one plain
    call and one all_reduce, and the gathered values are the whole data's,
    in each of the op's modes."""
    X, y, _ = w.covtype_like(w.SHARDED_ROWS)
    W = w.glm_weights()
    jmode, tmode = GLM_MODES[mode]
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=jmode)
    ll_j, g_j = _jax_reference(W, jd, mode)
    td = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y), dtype=tmode)
    g_t, ll_t = torch.func.vmap(torch.func.grad_and_value(glm.bernoulli_logits_loglik),
                                in_dims=(0, None))(torch.from_numpy(W), td)
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances(mode, w.SHARDED_ROWS)
    exact = None
    if mode != "bf16":  # bf16 mode rounds w and the residual: no float64 twin
        hi, lo = glm.split_hi_lo(torch.from_numpy(W))
        wd = hi.double() + lo.double() if mode == "split" else torch.from_numpy(W).double()
        logits = wd @ td.x_t[: td.d, : td.n].double()
        exact = -(torch.nn.functional.softplus(logits)
                  - td.y_row[0, : td.n].double() * logits).sum(-1)
    for rank, r in enumerate(jobs["four"].results()):
        got = r["glm"][mode]
        assert got["rows"] == ((0, 1000), (1000, 2001))[rank % 2]
        assert got["n"] == got["rows"][1] - got["rows"][0]
        assert got["all_reduce"] == 1 and got["plain"] == 1
        if exact is not None:
            np.testing.assert_allclose(got["ll"].numpy(), exact.numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["ll"].numpy(), ll_j, rtol=JAX_LL_RTOL)
        np.testing.assert_allclose(got["grad"].numpy(), g_j, rtol=G_RTOL, atol=G_ATOL)
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


def test_shard_aware_subsample_gives_the_whole_datas_panels(jobs):
    """``subsample`` of X and y through ``shard_data`` on the 2 x 2 mesh,
    under a plate of the whole size: eagerly (one all_reduce a take) and
    recorded under vmap for 8 chains as HMCECS records them (one all_reduce
    for both panels), the panels equal the whole data's rows bit for bit."""
    X, y = (torch.from_numpy(a) for a in w.ecs_data())
    idx = w.shard_idx()
    for rank, r in enumerate(jobs["four"].results()):
        sub = r["subsample"]
        assert sub["rows"] == ((0, 32, 64), (32, 64, 64))[rank % 2]
        assert torch.equal(sub["eager"][0], X[idx[0]]) and torch.equal(sub["eager"][1], y[idx[0]])
        assert sub["eager_reduces"] == 2
        assert torch.equal(sub["batched"][0], X[idx]) and torch.equal(sub["batched"][1], y[idx])
        assert sub["batched_reduces"] == 1


# the cases' ids name the message each raised while a shard's tag did not
# ride through ops; all but local_size now give the whole data's result
SHARD_CASES = {
    "obs": "obs-obs of sample site 'y' is a data shard",
    "unsubsampled": "unsubsampled-does not subsample",
    "local_size": "local_size-give the plate the whole data's size",
    "no_plate": "no_plate-under no plate that subsamples its dim -2",
    "outside": "outside-outside any plate",
    "ten_rows": "ten_rows-obs of sample site 'y' is a data shard",
    "lean": 'lean-panel_mode="lean"',
}
# all_reduces over the data axis of one batched potential-and-gradient
# evaluation: the site's sum, and one a replicated tensor's entry into an op
# with the rows (w[:-1] and w[-1] in "outside")
PARITY_REDUCES = {"obs": 2, "unsubsampled": 2, "no_plate": 2, "outside": 3, "ten_rows": 2}


def _jax_parity(case):
    """The JAX package's potential and gradient of a parity case's model on
    all rows, at every chain's point (and the 10-row case's log density at
    w = 1)."""
    from numpyro_tpu.infer.util import log_density as jlog_density
    from numpyro_tpu.infer.util import potential_energy as jpotential

    X, y, W = (jnp.asarray(a) for a in w.parity_data(case))
    n, d = X.shape
    if case == "outside":
        X = numpyro_tpu.subsample(X, event_dim=1)

    def model(X, y):
        wv = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(d), 1.0).to_event(1))
        if case in ("obs", "ten_rows"):
            numpyro_tpu.sample("y", jdist.Bernoulli(logits=X @ wv), obs=y)
        elif case == "unsubsampled":
            with numpyro_tpu.plate("N", n):
                xb = numpyro_tpu.subsample(X, event_dim=1)
                yb = numpyro_tpu.subsample(y, event_dim=0)
                numpyro_tpu.sample("y", jdist.Bernoulli(logits=xb @ wv), obs=yb)
        elif case == "no_plate":
            xb = numpyro_tpu.subsample(X, event_dim=1)
            numpyro_tpu.factor("lik", jdist.Bernoulli(logits=xb @ wv).log_prob(y))
        else:
            logits = X[:, :-1] @ wv[:-1] + X[:, -1] * wv[-1]
            with numpyro_tpu.plate("N", n):
                numpyro_tpu.sample("y", jdist.Bernoulli(logits=logits),
                                   obs=(y > 0.5).astype(jnp.float32))

    def pe(v):
        return jpotential(model, (X, y), {}, {"w": v})

    value, grad = jax.vmap(jax.value_and_grad(pe))(W)
    out = {"pe": np.asarray(value), "grad": np.asarray(grad)}
    if case == "ten_rows":
        out["log_density"] = float(jlog_density(model, (X, y), {}, {"w": jnp.ones(d)})[0])
    return out


def _lean_on_a_data_mesh(jobs, one_process):
    """HMCECS in lean mode on the 2 x 2 mesh against carry mode in one
    process on all rows: indices, draws, potentials, gradients and accept
    probabilities bit for bit; one all_reduce over the data axis an
    evaluation (every panel of the evaluation at once), none besides; a
    lean evaluation's panels the whole data's rows bit for bit."""
    X, y = (torch.from_numpy(a) for a in w.ecs_data())
    ref = one_process["ecs_carry"]
    assert ref["modes"]["panel"] == "carry"
    for r in jobs["four"].results():
        lean, carry = r["lean"], r["carry"]
        assert lean["modes"]["panel"] == "lean" and carry["modes"]["panel"] == "carry"
        assert lean["reduces"] == lean["evals"] and min(lean["evals"]) > 1
        assert carry["reduces"] == [1] * len(carry["reduces"])
        _equal_trees(tuple(lean["states"]), tuple(ref["states"]))
        _equal_trees(tuple(carry["states"]), tuple(ref["states"]))
        idx = lean["idx"]
        assert torch.equal(lean["panels"][0], X[idx]) and torch.equal(lean["panels"][1], y[idx])
        assert lean["panel_reduces"] == 1


@pytest.mark.parametrize("case", list(SHARD_CASES), ids=list(SHARD_CASES.values()))
def test_data_shard_where_it_would_give_a_shards_result_raises(jobs, one_process, case):
    """A model written for the whole data over ``shard_data``'s rows on the
    2 x 2 mesh (1,000 or 1,001 of 2,001 rows a rank): ``obs=`` of the rows,
    ``subsample`` under a plate that does not subsample them, under no
    plate (with ``factor`` of each row's term) and outside every handler
    (with column slices and a cast), and the 10-row ``Bernoulli(logits=X @
    w)`` that once gave a rank's log-likelihood alone (-5.6259 and -2.1496
    for -7.7756): every rank's potential and gradient at 8 points equal the
    JAX package's on all rows (potential rtol 1e-5, gradient rtol 1e-4 and
    atol 1e-4 of its largest component) and the port's one-process ones
    (``ECS_PROXY_RTOL``: the ranks' float32 partial sums add in another
    order).  HMCECS in lean mode on the mesh equals carry mode in one
    process bit for bit.  A plate of the shard's own size still raises."""
    if case == "local_size":
        for r in jobs["four"].results():
            message = r["subsample"]["raises"][case]
            assert message is not None and "give the plate the whole data's size" in message
        return
    if case == "lean":
        _lean_on_a_data_mesh(jobs, one_process)
        return
    want, ref = _jax_parity(case), one_process["parity"][case]
    g_scale = np.abs(want["grad"]).max()
    for r in jobs["four"].results():
        got = r["parity"][case]
        assert got["over_data"] == PARITY_REDUCES[case]
        np.testing.assert_allclose(got["pe"].numpy(), want["pe"], rtol=1e-5)
        np.testing.assert_allclose(got["grad"].numpy(), want["grad"], rtol=1e-4,
                                   atol=1e-4 * g_scale)
        np.testing.assert_allclose(got["pe"].numpy(), ref["pe"].numpy(), rtol=ECS_PROXY_RTOL)
        np.testing.assert_allclose(got["grad"].numpy(), ref["grad"].numpy(),
                                   rtol=ECS_PROXY_RTOL, atol=ECS_PROXY_RTOL * g_scale)
        if case == "ten_rows":
            np.testing.assert_allclose(got["log_density"].item(), want["log_density"],
                                       rtol=1e-6)
        if case in r["subsample"]["returned"]:
            assert r["subsample"]["returned"][case] == "DataShardTensor"


# all_reduces over the data axis of one batched potential-and-gradient
# evaluation of each ROW_PARITY case: row_latent the site's sum, w's entry
# and the cut tau * e's cotangent; lags and scan the three gathers of the
# series' slices (y[2:], y[1:-1], y[:-2]; y[2:], y[1], y[0]); reductions the
# columns' MAX, w's entry, logsumexp's MAX and sum, the MAX of the logits,
# its entry, the sum of its weights at the ranks that hold it and the site's
# sum; forward mode row_latent the site's sum and its tangent's, reductions
# the columns' MAX, logsumexp's MAX, its sum and its tangent's, the MAX of
# the logits, its tangent's with its weights, the site's sum and its
# tangent's
ROW_REDUCES = {"row_latent": 3, "lags": 3, "scan": 3, "reductions": 8, "row_latent_forward": 2,
               "reductions_forward": 8}


def _jax_row_model(case, n, d):
    """The JAX package's model of a ``ROW_PARITY`` case over ``n`` rows."""
    from numpyro_tpu.contrib.control_flow import scan as jscan

    def ar2_priors():
        return (numpyro_tpu.sample("a1", jdist.Normal(0.0, 1.0)),
                numpyro_tpu.sample("a2", jdist.Normal(0.0, 1.0)),
                numpyro_tpu.sample("const", jdist.Normal(0.0, 1.0)),
                numpyro_tpu.sample("sigma", jdist.HalfNormal(1.0)))

    def model(*data):
        if case in ("lags", "scan"):
            (y,) = data
            a1, a2, const, sigma = ar2_priors()
            if case == "lags":
                with numpyro_tpu.plate("T", n - 2):
                    numpyro_tpu.sample("y", jdist.Normal(const + a1 * y[1:-1] + a2 * y[:-2],
                                                         sigma), obs=y[2:])
                return

            def transition(carry, yt):
                y_prev, y_prev2 = carry
                m = const + a1 * y_prev + a2 * y_prev2
                numpyro_tpu.sample("y", jdist.Normal(m, sigma), obs=yt)
                return (yt, y_prev), None

            jscan(transition, (y[1], y[0]), y[2:])
            return
        X, y = data
        wv = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(d), 1.0).to_event(1))
        if case == "reductions":
            logits = (X / jnp.abs(X).max(0)) @ wv
            numpyro_tpu.factor("lse", -jax.nn.logsumexp(logits, 0))
            numpyro_tpu.sample("y", jdist.Bernoulli(logits=logits - logits.max()), obs=y)
            return
        tau = numpyro_tpu.sample("tau", jdist.HalfNormal(1.0))
        with numpyro_tpu.plate("N", n):
            e = numpyro_tpu.sample("e", jdist.Normal(0.0, 1.0))
            numpyro_tpu.sample("y", jdist.Bernoulli(logits=X @ wv + tau * e), obs=y)

    return model


def _jax_row_parity(case):
    """The JAX package's potential and gradient of a ``ROW_PARITY`` case on
    all rows, at every chain's point."""
    from numpyro_tpu.infer.util import potential_energy as jpotential

    data, points = w.row_parity_data(case)
    data = tuple(jnp.asarray(a) for a in data)
    model = _jax_row_model(case, w.SHARDED_ROWS, w.GLM_SHAPE[1])
    value, grad = jax.jit(jax.vmap(jax.value_and_grad(
        lambda z: jpotential(model, data, {}, z))))({k: jnp.asarray(v) for k, v in points.items()})
    return np.asarray(value), {k: np.asarray(v) for k, v in grad.items()}


@pytest.mark.parametrize("case", list(w.ROW_PARITY) + [f"{c}_forward" for c in w.ROW_FORWARD])
def test_models_that_cut_or_gather_the_rows_match_jax(jobs, case):
    """A model written for the whole data over ``shard_data``'s rows on the
    2 x 2 mesh (1,000 or 1,001 of 2,001 rows a rank) that cuts a whole
    latent to the rows (``row_latent``: a latent ``e`` a row under a plate
    of the whole size, overdispersed logistic regression) or gathers them
    (``lags``: AR(2) by lag slices; ``scan``: ``examples/ar2.py``;
    ``reductions``: a logsumexp and a max over the rows), ``row_latent``
    and ``reductions`` in forward mode too: every rank's potential and
    gradient at 8 points equal the JAX package's on all rows (potential
    rtol 1e-5, gradient rtol 1e-4 and atol 1e-4 of its largest component); the gradient of ``e`` is whole on every
    rank."""
    want_pe, want_grad = _jax_row_parity(case.replace("_forward", ""))
    for r in jobs["four"].results():
        got = r["row_parity_forward"][case[:-len("_forward")]] if case.endswith("_forward") \
            else r["row_parity"][case]
        assert got["over_data"] == ROW_REDUCES[case]
        np.testing.assert_allclose(got["pe"].numpy(), want_pe, rtol=1e-5)
        assert set(got["grad"]) == set(want_grad)
        for k, g_j in want_grad.items():
            assert got["grad"][k].shape == g_j.shape
            np.testing.assert_allclose(got["grad"][k].numpy(), g_j, rtol=1e-4,
                                       atol=1e-4 * np.abs(g_j).max(), err_msg=k)


def test_data_sharded_nuts_with_a_latent_a_row(jobs, one_process):
    """Pooled NUTS on ``row_latent`` (a latent ``e`` for each of the 2,001
    rows, held whole on every rank) with its chains over the 2 x 2 mesh's
    chains and its rows over its data: every rank holds the same draws, the
    whole ``e`` among them, and the posterior means of ``w`` and ``tau``
    are within 4 combined Monte-Carlo errors of the one-process run's."""
    res = [r["row_nuts"] for r in jobs["four"].results()]
    for r in res[1:]:
        _equal_trees(r, res[0])
    ref = one_process["row_nuts"]
    chains, _, samples, _ = w.ROW_NUTS
    assert res[0]["e"].shape == ref["e"].shape == (chains, samples, w.SHARDED_ROWS)
    for k in ("w", "tau"):
        got, want = res[0][k], ref[k]
        if k == "tau":
            got, want = got[..., None], want[..., None]
        assert torch.isfinite(got).all()
        (m1, e1), (m2, e2) = _mean_and_error(got), _mean_and_error(want)
        assert ((m1 - m2).abs() <= 4 * (e1**2 + e2**2).sqrt()).all(), k


def test_predictive_of_many_draws_over_the_rows(jobs, one_process):
    """``Predictive`` of 16 draws of ``row_latent``'s ``y`` (one ``vmap``)
    on the 2 x 2 mesh: each rank returns its rows, tagged, equal bit for bit
    to those rows of the port's one-process draws from the same generator;
    their mean over draws and rows is within 4 Monte-Carlo errors of the
    JAX package's ``Predictive`` on all rows from the same posterior draws
    (the binomial spread of both means at the draws' probabilities)."""
    from numpyro_tpu.infer import Predictive as JPredictive

    ref = one_process["row_predictive"]["y"]
    assert ref.shape == (w.ROW_DRAWS, w.SHARDED_ROWS)
    for r in jobs["four"].results():
        got = r["row_predictive"]
        assert got["type"] == "DataShardTensor" and got["axis"] == -1
        n = got["y"].shape[-1]
        assert n in (1000, 1001)
        assert torch.equal(got["y"], ref[:, got["start"]:got["start"] + n])
    X, _, _ = w.covtype_like(w.SHARDED_ROWS)
    samples = w.row_predictive_samples()
    model = _jax_row_model("row_latent", w.SHARDED_ROWS, w.GLM_SHAPE[1])
    y_j = np.asarray(JPredictive(model, {k: jnp.asarray(v) for k, v in samples.items()},
                                 return_sites=["y"])(random.PRNGKey(9), jnp.asarray(X), None)["y"])
    assert y_j.shape == tuple(ref.shape)
    logits = X @ samples["w"].T + samples["tau"] * samples["e"].T
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    err = np.sqrt(2.0 * (p * (1.0 - p)).sum()) / p.size
    assert abs(ref.double().mean().item() - y_j.mean()) <= 4 * err


def test_data_sharded_nuts_of_a_model_written_for_the_whole_data(jobs, one_process):
    """Pooled NUTS on ``Bernoulli(logits=X @ w)`` with ``obs=`` of the rows,
    its chains over the 2 x 2 mesh's chains and its rows over its data:
    every rank gathers the same panel, a sample of the posterior that the
    one-process run on all rows samples (4 combined Monte-Carlo errors)."""
    res = [r["shard_nuts"] for r in jobs["four"].results()]
    for r in res[1:]:
        _equal_trees(r, res[0])
    ref = one_process["shard_nuts"]
    assert res[0]["w"].shape == ref["w"].shape and torch.isfinite(res[0]["w"]).all()
    (m1, e1), (m2, e2) = _mean_and_error(res[0]["w"]), _mean_and_error(ref["w"])
    assert ((m1 - m2).abs() <= 4 * (e1**2 + e2**2).sqrt()).all()


@pytest.mark.parametrize("kernel", w.PADDED)
def test_padded_ensemble_on_four_chain_shards_equals_one_process(jobs, one_process, kernel):
    """AIES and ESS with 18 walkers on the four-rank chain mesh: padded to
    20, the pad walkers placed by the pad generator's init and moving with
    the ensemble; the draws and last state of the 18 real walkers equal the
    one-process run of the same padded ensemble bit for bit."""
    ref = one_process["padded_" + kernel]
    assert ref["w"].shape[:2] == (w.PADDED_ENSEMBLE[0], w.PADDED_ENSEMBLE[2])
    for r in jobs["four"].results():
        got = r["padded"][kernel]
        said = got.pop("warnings")
        assert any("padding the chain axis to 20" in m for m in said)
        assert not any("running unsharded" in m for m in said)
        _equal_trees(got, ref)


def test_hmcecs_chain_and_data_sharded_equals_one_process(jobs, one_process):
    """HMCECS without a proxy on the 2 x 2 mesh: its chains over the chain
    axis, X and y over the data axis; every rank holds the one-process
    run's draws, accept probabilities and indices bit for bit."""
    ref = one_process["ecs"]
    for r in jobs["four"].results():
        _equal_trees(r["ecs"], ref)


def test_hmcecs_with_the_taylor_proxy_on_a_data_mesh(jobs, one_process):
    """HMCECS with the Taylor proxy (stats mode) on the 2 x 2 mesh against
    one process, at init and after each of two transitions: indices,
    panels and per-point statistics exactly, the rest to
    ``ECS_PROXY_RTOL``; setup's all_reduces over the data axis: the
    prototype's two takes, the proxy's whole-data sums, its statistics at the
    prototype's indices and the first panels; then one a transition, the
    refreshed panels, whose replacement rows the proxy's statistics take.  The accept probability is
    ``exp`` of a difference of two potentials, each within ``ECS_PROXY_RTOL``
    of its size: it is held to twice that of the largest potential,
    relative."""
    ref = one_process["ecs_proxy"]
    assert ref["modes"] == {"proxy": "stats", "panel": "carry"}
    for r in jobs["four"].results():
        got = r["ecs_proxy"]
        assert got["modes"] == ref["modes"] and got["setup"]["over_data"] == 5
        assert got["step_reduces"] == [1] * w.ECS_PROXY[2]
        for s, t in zip(got["states"], ref["states"]):
            _equal_trees((s["z"]["N"], s["stats"], s["panels"]),
                         (t["z"]["N"], t["stats"], t["panels"]))
            np.testing.assert_allclose(s["pe"].numpy(), t["pe"].numpy(), rtol=ECS_PROXY_RTOL)
            np.testing.assert_allclose(
                s["accept"].numpy(), t["accept"].numpy(),
                rtol=2 * ECS_PROXY_RTOL * t["pe"].abs().max().item())
            for key in ("z", "grad"):
                np.testing.assert_allclose(s[key]["w"].numpy(), t[key]["w"].numpy(),
                                           rtol=ECS_PROXY_RTOL, atol=1e-6, err_msg=key)


def test_hmcecs_step_on_a_data_mesh_matches_jax(jobs):
    """One transition from the JAX package's state on its draws, with X and
    y sharded over the mesh's data axis and the 8 chains over its chain
    axis: equal to the port's one-process step on the same draws, near JAX's
    step; one all_reduce over the data axis (the refreshed panels) and none
    in any of the transition's potential evaluations; a rank holds its 32
    rows of X and its 4 chains' panels."""
    s_t, s_j = jobs["ecs_jax"]
    for r in jobs["four"].results():
        got = r["ecs_jax"]
        assert got["over_data"] == 1 and got["evals"] > 1
        assert got["x_rows"] == (32, w.ECS_RUN[1])
        assert got["panel_rows"] == (w.ECS_JAX[0] // 2, w.ECS_RUN[2], w.ECS_RUN[1])
        _equal_trees({k: got[k] for k in ("z", "pe", "grad", "panels", "accept", "num_steps")},
                     {"z": s_t.z, "pe": s_t.hmc_state.potential_energy,
                      "grad": s_t.hmc_state.z_grad, "panels": s_t.panels,
                      "accept": s_t.accept_prob, "num_steps": s_t.hmc_state.num_steps})
    h_j = s_j.hmc_state
    np.testing.assert_array_equal(s_t.z["N"].numpy(), np.asarray(s_j.z["N"]))
    for a, b in zip(s_t.panels, s_j.panels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(s_t.hmc_state.num_steps.numpy(), np.asarray(h_j.num_steps))
    np.testing.assert_allclose(s_t.accept_prob.numpy(), np.asarray(s_j.accept_prob),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(s_t.hmc_state.potential_energy.numpy(),
                               np.asarray(h_j.potential_energy), rtol=1e-4)
    g_j = np.asarray(h_j.z_grad["w"])
    np.testing.assert_allclose(s_t.hmc_state.z_grad["w"].numpy(), g_j, rtol=1e-4,
                               atol=1e-4 * np.abs(g_j).max())
    np.testing.assert_allclose(s_t.hmc_state.z["w"].numpy(), np.asarray(h_j.z["w"]),
                               rtol=1e-4, atol=1e-5)


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
    assert Xs.data_shard.size == 64
    with pytest.raises(ValueError, match="same rows"):
        glm.prepare_glm_data(Xs, torch.from_numpy(y), dtype="split")
    data = glm.prepare_glm_data(Xs, shard_data(torch.from_numpy(y), mesh), dtype="split")
    assert data.group is None and data.n == 64


def test_subsample_of_a_one_rank_data_shard_is_the_plain_take():
    """On a mesh of one rank a data shard holds every row: ``subsample``
    takes from it as from the data itself, and nothing raises."""
    from numpyro_tpu_torch import handlers
    from numpyro_tpu_torch.parallel import shard_data

    X, y = (torch.from_numpy(a) for a in w.ecs_data())
    mesh = chain_data_mesh(device="cpu")
    Xs, ys = shard_data(X, mesh), shard_data(y, mesh)
    idx = w.shard_idx()[0]
    n, _, sub = w.ECS_RUN[:3]
    xb, yb = handlers.substitute(w.subsample_take, data={"N": idx})(Xs, ys, n, sub)
    assert torch.equal(xb, X[idx]) and torch.equal(yb, y[idx])
