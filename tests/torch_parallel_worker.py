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
from numpyro_tpu_torch import handlers  # noqa: E402
from numpyro_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from numpyro_tpu_torch.contrib.control_flow import scan  # noqa: E402
from numpyro_tpu_torch.contrib.ecs_proxies import subsample_panels  # noqa: E402
from numpyro_tpu_torch.infer import AIES, ESS, HMCECS, MCMC, NUTS, SMC, CheesHMC  # noqa: E402
from numpyro_tpu_torch.infer import hmc as thmc  # noqa: E402
from numpyro_tpu_torch.infer import hmc_core as core  # noqa: E402
from numpyro_tpu_torch.infer import Predictive, init_to_value  # noqa: E402
from numpyro_tpu_torch.infer import util as infer_util  # noqa: E402
from numpyro_tpu_torch.infer.hmc_gibbs import _lean_shard_panels, ecs_state_from_numpy  # noqa: E402
from numpyro_tpu_torch.ops import glm  # noqa: E402
from numpyro_tpu_torch.parallel import (  # noqa: E402
    chain_data_mesh, chain_mesh, cross_chain_diagnostics, initialize_distributed,
    pooled_step_size, shard_chain_state, shard_data,
)
from numpyro_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from numpyro_tpu_torch.parallel.data_shard import local_rows  # noqa: E402
from numpyro_tpu_torch.util import tree_leaves  # noqa: E402

# the covtype-shape problem: rows, coefficients with the intercept, chains
GLM_SHAPE = (2000, 9, 8)
# warmup, samples and tree depth of the NUTS runs (20 warmup transitions
# have one middle window, so the pooled Welford merge runs once)
NUTS_RUN = (20, 10, 4)
# the data-sharded GLM: rows (odd, so the two data shards differ by one),
# and its modes
SHARDED_ROWS = 2001
GLM_MODES = {"split": "split", "f32": torch.float32, "bf16": torch.bfloat16}
# HMCECS: rows, coefficients, subsample, blocks, chains, warmup, samples
ECS_RUN = (64, 4, 16, 4, 8, 5, 5)
# the per-step run on the JAX package's draws: chains, warmup, steps, depths
JAX_RUN = (8, 20, 22, (3, 4))
JAX_PROBLEM = (200, 4)  # rows, coefficients of the logistic potential
CKPT_STEPS = 3
# ChEES (chains, warmup, samples) and the ensembles (walkers, warmup,
# samples), sharded over the two-rank chain mesh
CHEES_RUN = (8, 6, 4)
ENSEMBLE_RUN = (20, 3, 3)
COUPLED = ("CheesHMC", "CheesHMC_padded", "AIES", "ESS")
# HMCECS with the Taylor proxy on the 2 x 2 mesh: its reference, warmup and
# transitions compared
ECS_PROXY = (np.linspace(-0.8, 0.8, ECS_RUN[1]).astype(np.float32), 10, 2)
# the JAX package's step on its own draws (tests/parallel/test_ecs_sharded_data.py):
# chains, tree depth, warmup
ECS_JAX = (8, 4, 10)
# models over data shards written as for the whole data, held against the
# JAX package's potential on all rows (the 10-row one on ecs_data's first 10)
PARITY = ("obs", "unsubsampled", "no_plate", "outside", "ten_rows")
# a data-sharded NUTS run of the "obs" model on the 2 x 2 mesh: chains,
# warmup, samples, tree depth
SHARD_NUTS = (8, 20, 10, 4)
# the padded ensembles on the four-rank chain mesh: walkers (padded to 20),
# warmup, samples
PADDED_ENSEMBLE = (18, 3, 3)
PADDED = ("AIES", "ESS")
# models over data shards that cut a whole latent to the rows or gather the
# rows, on SHARDED_ROWS rows, held against the JAX package's potential on
# all rows: a latent a row, AR(2) by lag slices, examples/ar2.py's scan, and
# a logsumexp and a max over the rows
ROW_PARITY = ("row_latent", "lags", "scan", "reductions")
# the cases of ROW_PARITY run in forward mode as well
ROW_FORWARD = ("row_latent", "reductions")
# pooled NUTS of row_latent on the 2 x 2 mesh: chains, warmup, samples,
# tree depth
ROW_NUTS = (8, 20, 10, 3)
# Predictive of row_latent's y over the rows: draws
ROW_DRAWS = 16


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


def ecs_data():
    n, d = ECS_RUN[:2]
    rng = np.random.default_rng(5)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, d)))).astype(np.float32)
    return X, y


def ecs_problem():
    """The subsampled logistic model, its plate of the whole data's size
    (the rows a rank holds of a data shard are fewer), and the data."""
    n, d, sub = ECS_RUN[:3]
    X, y = ecs_data()

    def model(X, y):
        w = npt.sample("w", dist.Normal(torch.zeros(d), 1.0).to_event(1))
        with npt.plate("N", n, subsample_size=sub):
            xb = npt.subsample(X, event_dim=1)
            yb = npt.subsample(y, event_dim=0)
            npt.sample("y", dist.Bernoulli(logits=xb @ w), obs=yb)

    return model, torch.from_numpy(X), torch.from_numpy(y)


def ecs_run(chain_method, mesh=None, data_mesh=None, proxy=None):
    """HMCECS on ``ECS_RUN``; ``data_mesh``: X and y as its data shards."""
    model, X, y = ecs_problem()
    if data_mesh is not None:
        X, y = shard_data(X, data_mesh), shard_data(y, data_mesh)
    _, _, _, blocks, chains, warmup, samples = ECS_RUN
    m = MCMC(HMCECS(NUTS(model, max_tree_depth=3), num_blocks=blocks, proxy=proxy),
             num_warmup=warmup, num_samples=samples, num_chains=chains,
             chain_method=chain_method, mesh=mesh, device="cpu")
    m.run(3, X, y, extra_fields=("accept_prob",))
    return {"w": m.get_samples(group_by_chain=True)["w"],
            "accept_prob": m.get_extra_fields(group_by_chain=True)["accept_prob"],
            "idx": m.last_state.z["N"]}


def ecs_proxy_steps(mesh=None):
    """HMCECS with the Taylor proxy (``ECS_PROXY``), through the per-step
    API: the state after init and after each compared transition (every
    chain's, gathered), with the data sharded over ``mesh``'s data axis and
    the chains over its chain axis, or whole in one process."""
    model, X, y = ecs_problem()
    chains = ECS_RUN[4]
    ref, warmup, steps = ECS_PROXY
    if mesh is not None:
        X, y = shard_data(X, mesh), shard_data(y, mesh)
    kernel = HMCECS(NUTS(model, max_tree_depth=3), num_blocks=ECS_RUN[3],
                    proxy=HMCECS.taylor_proxy({"w": ref}, mode="stats"))
    mesh_lib.reset_collective_counts()
    state = kernel.init(torch.Generator().manual_seed(4), warmup, None, (X, y), {},
                        num_chains=chains)
    setup = dict(mesh_lib.collective_counts)
    if mesh is not None:
        state = shard_chain_state(state, mesh)
    states, step_reduces = [state], []
    for _ in range(steps):
        mesh_lib.reset_collective_counts()
        states.append(kernel.sample(states[-1], (X, y), {}))
        step_reduces.append(mesh_lib.collective_counts["over_data"])
    out = []
    for s in states:
        g = core.gather_state(s)
        out.append({"z": g.z, "pe": g.hmc_state.potential_energy, "grad": g.hmc_state.z_grad,
                    "stats": g.gibbs_state, "panels": g.panels, "accept": g.accept_prob})
    return {"states": out, "setup": setup, "step_reduces": step_reduces,
            "modes": dict(kernel.resolved_modes)}


class RecordedDraws:
    """A draw source that records what ``source`` draws, one entry a call in
    call order (the forked adaptation source records into the same list)."""

    shard = None

    def __init__(self, source, log):
        self.source, self.log = source, log
        self.generator = source.generator

    def _keep(self, out):
        self.log.append(out)
        return out

    def normal(self, like):
        return self._keep(self.source.normal(like))

    def start(self, like):
        return self._keep(self.source.start(like))

    def tick(self, like):
        return self._keep(self.source.tick(like))

    def uniform(self, like):
        return self._keep(self.source.uniform(like))

    def hmc_start(self, like):
        return self._keep(self.source.hmc_start(like))

    def block(self, idx, num_blocks, block_size, size):
        return self._keep(self.source.block(idx, num_blocks, block_size, size))

    def fork(self):
        return RecordedDraws(self.source.fork(), self.log)


class ReplayedDraws:
    """The draws of a :class:`RecordedDraws` list, in order, each cut to this
    rank's rows of the chain panel (``shard``)."""

    generator = torch.Generator().manual_seed(0)

    def __init__(self, log, shard):
        self.log, self.shard = list(log), shard

    def _next(self, *args):
        out = self.log.pop(0)
        rows = slice(self.shard.start, self.shard.stop)
        return tuple(x[rows] for x in out) if isinstance(out, tuple) else out[rows]

    normal = start = tick = uniform = hmc_start = block = _next

    def fork(self):
        return self


def ecs_jax_kernel(model):
    return HMCECS(NUTS(model, max_tree_depth=ECS_JAX[1]), num_blocks=ECS_RUN[3])


def ecs_on_jax_draws(mesh, out):
    """One HMCECS transition from the JAX package's state on its draws,
    recorded by the test (``OUT/ecs_jax.pt``), with X and y sharded over the
    mesh's data axis and the chains over its chain axis: the gathered state,
    the all_reduces over the data axis and the potential evaluations of the
    transition."""
    path = os.path.join(out, "ecs_jax.pt")
    _wait_for_file(path)
    got = torch.load(path, weights_only=False)
    model, X, y = ecs_problem()
    Xs, ys = shard_data(X, mesh), shard_data(y, mesh)
    kernel = ecs_jax_kernel(model)
    kernel.init(torch.Generator().manual_seed(0), ECS_JAX[2], None, (Xs, ys), {},
                num_chains=ECS_JAX[0])
    shard = mesh.chain_shard(ECS_JAX[0])
    state = shard_chain_state(ecs_state_from_numpy(got["state"]), mesh)
    state = state._replace(rng_key=ReplayedDraws(got["outer"], shard),
                           hmc_state=state.hmc_state._replace(
                               rng_key=ReplayedDraws(got["inner"], shard)))
    mesh_lib.reset_collective_counts()
    evals = infer_util.potential_evals
    state = kernel.sample(state, (Xs, ys), {})
    counts = dict(mesh_lib.collective_counts)
    g = core.gather_state(state)
    return {"z": g.z, "pe": g.hmc_state.potential_energy, "grad": g.hmc_state.z_grad,
            "panels": g.panels, "accept": g.accept_prob, "num_steps": g.hmc_state.num_steps,
            "over_data": counts["over_data"], "evals": infer_util.potential_evals - evals,
            "x_rows": tuple(Xs.shape), "panel_rows": tuple(state.panels[0].shape)}


def parity_model(case, n, d):
    """The model of a parity case over ``n`` rows of ``d`` columns, written
    as for the whole data; each case reaches the rows another way."""

    def prior():
        return npt.sample("w", dist.Normal(torch.zeros(d), 1.0).to_event(1))

    def obs(X, y):  # obs= of the rows, no plate
        w = prior()
        npt.sample("y", dist.Bernoulli(logits=X @ w), obs=y)

    def unsubsampled(X, y):  # subsample() under a plate of every row
        w = prior()
        with npt.plate("N", n):
            xb = npt.subsample(X, event_dim=1)
            yb = npt.subsample(y, event_dim=0)
            npt.sample("y", dist.Bernoulli(logits=xb @ w), obs=yb)

    def no_plate(X, y):  # subsample() under no plate, factor of each row's term
        w = prior()
        xb = npt.subsample(X, event_dim=1)
        npt.factor("lik", dist.Bernoulli(logits=xb @ w).log_prob(y))

    def outside(X, y):  # X taken by subsample() outside any handler: columns, casts
        w = prior()
        logits = X[:, :-1] @ w[:-1] + X[:, -1] * w[-1]
        with npt.plate("N", n):
            npt.sample("y", dist.Bernoulli(logits=logits), obs=(y > 0.5).float())

    return {"obs": obs, "unsubsampled": unsubsampled, "no_plate": no_plate,
            "outside": outside, "ten_rows": obs}[case]


def parity_data(case):
    """The rows of a parity case (numpy X, y) and the chains' points."""
    if case == "ten_rows":
        X, y = ecs_data()
        return X[:10], y[:10], glm_weights()[:, : X.shape[1]]
    X, y, _ = covtype_like(SHARDED_ROWS)
    return X, y, glm_weights()


def parity_potential(case, mesh=None):
    """Every chain's potential and gradient of a parity case's model (on
    ``mesh``'s data shards, or the whole data), the all_reduces of one
    batched evaluation over the data axis, and for the 10-row case the log
    density at w = 1."""
    X, y, W = parity_data(case)
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    if mesh is not None:
        X, y = shard_data(X, mesh), shard_data(y, mesh)
    if case == "outside":
        X = npt.subsample(X, event_dim=1)
    model = parity_model(case, X.data_shard.size if mesh is not None else X.shape[0],
                         W.shape[1])

    def pe(z):
        return infer_util.potential_energy(model, (X, y), {}, z)

    mesh_lib.reset_collective_counts()
    value, grad = infer_util.batched_value_and_grad(pe)({"w": torch.from_numpy(W)})
    out = {"pe": value, "grad": grad["w"], "over_data": mesh_lib.collective_counts["over_data"]}
    if case == "ten_rows":
        out["log_density"] = infer_util.log_density(
            model, (X, y), {}, {"w": torch.ones(W.shape[1])})[0]
    return out


def ar2_series(n=SHARDED_ROWS, seed=0):
    """``examples/ar2.py``'s series: ``n`` points of an AR(2) process."""
    rng = np.random.RandomState(seed)
    y = [0.0, 0.1]
    for _ in range(n - 2):
        y.append(0.1 + 0.5 * y[-1] - 0.3 * y[-2] + 0.2 * rng.randn())
    return np.asarray(y, dtype=np.float32)


def row_parity_model(case, n, d):
    """The model of a case of ``ROW_PARITY`` over ``n`` rows, written as
    for the whole data."""

    def row_latent(X, y):  # overdispersed logistic regression: a latent a row
        w = npt.sample("w", dist.Normal(torch.zeros(d), 1.0).to_event(1))
        tau = npt.sample("tau", dist.HalfNormal(1.0))
        with npt.plate("N", n):
            e = npt.sample("e", dist.Normal(0.0, 1.0))
            npt.sample("y", dist.Bernoulli(logits=X @ w + tau * e), obs=y)

    def ar2_priors():
        return (npt.sample("a1", dist.Normal(0.0, 1.0)), npt.sample("a2", dist.Normal(0.0, 1.0)),
                npt.sample("const", dist.Normal(0.0, 1.0)),
                npt.sample("sigma", dist.HalfNormal(1.0)))

    def lags(y):  # the series against itself one and two steps back
        a1, a2, const, sigma = ar2_priors()
        with npt.plate("T", n - 2):
            npt.sample("y", dist.Normal(const + a1 * y[1:-1] + a2 * y[:-2], sigma), obs=y[2:])

    def ar2_scan(y):  # examples/ar2.py
        a1, a2, const, sigma = ar2_priors()

        def transition(carry, yt):
            y_prev, y_prev2 = carry
            m = const + a1 * y_prev + a2 * y_prev2
            npt.sample("y", dist.Normal(m, sigma), obs=yt)
            return (yt, y_prev), None

        scan(transition, (y[1], y[0]), y[2:])

    def reductions(X, y):  # the columns' largest magnitudes, a logsumexp, a max
        w = npt.sample("w", dist.Normal(torch.zeros(d), 1.0).to_event(1))
        logits = (X / X.abs().amax(0)) @ w
        npt.factor("lse", -torch.logsumexp(logits, 0))
        npt.sample("y", dist.Bernoulli(logits=logits - logits.max()), obs=y)

    return {"row_latent": row_latent, "lags": lags, "scan": ar2_scan,
            "reductions": reductions}[case]


def row_parity_data(case):
    """The data of a case of ``ROW_PARITY`` (a tuple of numpy arrays) and
    the chains' points (unconstrained, by site)."""
    c = GLM_SHAPE[2]
    rng = np.random.default_rng(11)
    if case in ("lags", "scan"):
        points = {k: (0.3 * rng.standard_normal(c)).astype(np.float32)
                  for k in ("a1", "a2", "const")}
        points["sigma"] = np.linspace(-2.0, 0.0, c).astype(np.float32)
        return (ar2_series(),), points
    X, y, _ = covtype_like(SHARDED_ROWS)
    points = {"w": glm_weights()}
    if case == "row_latent":
        points["tau"] = np.linspace(-3.0, 0.0, c).astype(np.float32)
        points["e"] = rng.standard_normal((c, SHARDED_ROWS)).astype(np.float32)
    return (X, y), points


def row_parity_potential(case, mesh=None, forward=False):
    """Every chain's potential and gradient of a ``ROW_PARITY`` case (on
    ``mesh``'s data shards, or the whole data; ``forward``: by ``jacfwd``)
    and the all_reduces over the data axis of one batched evaluation."""
    data, points = row_parity_data(case)
    data = tuple(torch.from_numpy(a) for a in data)
    if mesh is not None:
        data = tuple(shard_data(a, mesh) for a in data)
    model = row_parity_model(case, SHARDED_ROWS, GLM_SHAPE[1])

    def pe(z):
        return infer_util.potential_energy(model, data, {}, z)

    mesh_lib.reset_collective_counts()
    value, grad = infer_util.batched_value_and_grad(pe, forward_mode=forward)(
        {k: torch.from_numpy(v) for k, v in points.items()})
    return {"pe": value, "grad": grad, "over_data": mesh_lib.collective_counts["over_data"]}


def row_nuts_run(chain_method, mesh=None):
    """Pooled NUTS of ``row_latent`` (``ROW_NUTS``) over covtype_like's 2,001
    rows, started from w = 0, tau = 0.1 and e = 0: its draws of ``w`` and
    ``tau`` and of ``e`` (whole on every rank)."""
    chains, warmup, samples, depth = ROW_NUTS
    X, y, _ = covtype_like(SHARDED_ROWS)
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    if mesh is not None:
        X, y = shard_data(X, mesh), shard_data(y, mesh)
    start = {"w": torch.zeros(GLM_SHAPE[1]), "tau": torch.tensor(0.1),
             "e": torch.zeros(SHARDED_ROWS)}
    m = MCMC(NUTS(row_parity_model("row_latent", SHARDED_ROWS, GLM_SHAPE[1]),
                  max_tree_depth=depth, pooled_adaptation=True,
                  init_strategy=init_to_value(values=start)),
             num_warmup=warmup, num_samples=samples, num_chains=chains,
             chain_method=chain_method, mesh=mesh, device="cpu")
    m.run(8, X, y)
    return {k: v for k, v in m.get_samples(group_by_chain=True).items()}


def row_predictive_samples():
    """``ROW_DRAWS`` posterior draws of row_latent's latents, from numpy."""
    rng = np.random.default_rng(13)
    d = GLM_SHAPE[1]
    return {"w": (0.5 * rng.standard_normal((ROW_DRAWS, d))).astype(np.float32),
            "tau": rng.uniform(0.2, 1.0, ROW_DRAWS).astype(np.float32),
            "e": rng.standard_normal((ROW_DRAWS, SHARDED_ROWS)).astype(np.float32)}


def row_predictive(mesh=None):
    """``Predictive`` of row_latent's ``y`` (``ROW_DRAWS`` draws, one
    ``vmap``) from seed 9: the rank's rows, tagged, on ``mesh``'s data
    shards (returned as plain rows with their start), or all rows."""
    X, _, _ = covtype_like(SHARDED_ROWS)
    X = torch.from_numpy(X)
    if mesh is not None:
        X = shard_data(X, mesh)
    samples = {k: torch.from_numpy(v) for k, v in row_predictive_samples().items()}
    pred = Predictive(row_parity_model("row_latent", SHARDED_ROWS, GLM_SHAPE[1]), samples,
                      return_sites=["y"], device="cpu")
    y = pred(9, X, None)["y"]
    if mesh is None:
        return {"y": y}
    return {"y": local_rows(y), "type": type(y).__name__, "axis": y._axis,
            "start": X.data_shard.start}


def shard_nuts_run(chain_method, mesh=None):
    """Pooled NUTS on the "obs" model over covtype_like's 2,001 rows: on
    ``mesh``'s data shards (chains over its chain axis) or the whole data."""
    chains, warmup, samples, depth = SHARD_NUTS
    X, y, _ = covtype_like(SHARDED_ROWS)
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    if mesh is not None:
        X, y = shard_data(X, mesh), shard_data(y, mesh)
    m = MCMC(NUTS(parity_model("obs", SHARDED_ROWS, X.shape[1]), max_tree_depth=depth,
                  pooled_adaptation=True),
             num_warmup=warmup, num_samples=samples, num_chains=chains,
             chain_method=chain_method, mesh=mesh, device="cpu")
    m.run(7, X, y)
    return {"w": m.get_samples(group_by_chain=True)["w"]}


def ecs_lean_run(mesh=None, panel_mode="lean"):
    """HMCECS without a proxy (``ECS_RUN``) in ``panel_mode``, through the
    per-step API from one seed: the gathered state after init and after
    each transition, with X and y on ``mesh``'s data shards (chains over
    its chain axis) or whole, and the all_reduces over the data axis of
    each transition and its potential evaluations."""
    model, X, y = ecs_problem()
    _, _, _, blocks, chains, warmup, samples = ECS_RUN
    if mesh is not None:
        X, y = shard_data(X, mesh), shard_data(y, mesh)
    kernel = HMCECS(NUTS(model, max_tree_depth=3), num_blocks=blocks, panel_mode=panel_mode)
    state = kernel.init(torch.Generator().manual_seed(4), warmup, None, (X, y), {},
                        num_chains=chains)
    if mesh is not None:
        state = shard_chain_state(state, mesh)
    states, reduces, evals = [state], [], []
    for _ in range(samples):
        mesh_lib.reset_collective_counts()
        before = infer_util.potential_evals
        states.append(kernel.sample(states[-1], (X, y), {}))
        reduces.append(mesh_lib.collective_counts["over_data"])
        evals.append(infer_util.potential_evals - before)
    out = []
    for s in states:
        g = core.gather_state(s)
        out.append({"idx": g.z["N"], "w": g.z["w"], "pe": g.hmc_state.potential_energy,
                    "grad": g.hmc_state.z_grad["w"], "accept": g.accept_prob})
    # the panels one lean evaluation gathers for every chain at the last
    # state's indices, and the all_reduces that takes
    idx = core.gather_state(states[-1]).z["N"]
    inner = kernel._base_inner_model.args[0]
    mesh_lib.reset_collective_counts()
    panels = torch.func.vmap(lambda i: _lean_shard_panels(
        inner, kernel._proto_latents, (X, y), {"_gibbs_sites": {"N": i}}))(idx)
    return {"states": out, "reduces": reduces, "evals": evals, "idx": idx,
            "modes": dict(kernel.resolved_modes), "panels": panels,
            "panel_reduces": mesh_lib.collective_counts["over_data"]}


def padded_ensemble_run(name, mesh=None):
    """AIES or ESS on the covtype-shape model with ``PADDED_ENSEMBLE``'s 18
    walkers padded to 20: through ``MCMC`` over ``mesh``'s chain shards, or
    in one process through the kernel on a sharded draw source over one
    shard that holds every row (the same pad generator's seed)."""
    walkers, warmup, samples = PADDED_ENSEMBLE
    kernel = coupled_kernel(name)
    data = glm_data()
    if mesh is not None:
        m = MCMC(kernel, num_warmup=warmup, num_samples=samples, num_chains=walkers,
                 chain_method="parallel", mesh=mesh, device="cpu")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m.run(6, data)
        return {"w": m.get_samples(group_by_chain=True)["w"],
                "last": core.replace_draw_sources(m.last_state, None),
                "warnings": [str(c.message) for c in caught]}
    from numpyro_tpu_torch.parallel.mesh import ChainShard

    padded = walkers + (-walkers) % 4
    generator = torch.Generator().manual_seed(6)
    pad = torch.Generator().manual_seed((6 * 1_000_003 + walkers) % 2**63)
    draws = core.ShardedDraws(generator, ChainShard(0, padded, walkers, padded, None), pad)
    state = kernel.init(draws, warmup, None, (data,), {}, num_chains=walkers)
    rows = []
    for i in range(warmup + samples):
        state = kernel.sample(state, (data,), {})
        if i >= warmup:
            rows.append(state.z["w"])
    last = core.replace_draw_sources(state, None)
    last = last._replace(z={"w": last.z["w"][:walkers]})
    return {"w": torch.stack(rows, 1)[:walkers], "last": last}


def subsample_take(X, y, n, sub):
    with npt.plate("N", n, subsample_size=sub):
        return npt.subsample(X, event_dim=1), npt.subsample(y, event_dim=0)


def shard_idx():
    n, _, sub = ECS_RUN[:3]
    rng = np.random.default_rng(12)
    return torch.from_numpy(np.stack([rng.permutation(n)[:sub] for _ in range(ECS_RUN[4])]))


def shard_subsample_checks(mesh):
    """The shard-aware subsample on the mesh's data axis: the panels, eager
    (one all_reduce a take) and recorded under vmap as HMCECS records them
    (one all_reduce for both), what still raises and what comes back
    tagged."""
    n, _, sub = ECS_RUN[:3]
    X, y = ecs_data()
    Xs, ys = shard_data(torch.from_numpy(X), mesh), shard_data(torch.from_numpy(y), mesh)
    idx = shard_idx()
    res = {"rows": (Xs.data_shard.start, Xs.data_shard.stop, Xs.data_shard.size)}
    mesh_lib.reset_collective_counts()
    res["eager"] = handlers.substitute(subsample_take, data={"N": idx[0]})(Xs, ys, n, sub)
    res["eager_reduces"] = mesh_lib.collective_counts["over_data"]
    groups = []

    def record(i):
        panels = []
        groups.clear()
        with subsample_panels(record=True, out=panels, groups=groups), \
                handlers.substitute(data={"N": i}):
            subsample_take(Xs, ys, n, sub)
        return tuple(panels)

    mesh_lib.reset_collective_counts()
    res["batched"] = mesh_lib.sum_partial_panels(torch.func.vmap(record)(idx), groups)
    res["batched_reduces"] = mesh_lib.collective_counts["over_data"]

    def unsubsampled(X, y):
        with npt.plate("N", n):
            return npt.subsample(X, event_dim=1)

    def local_size(X, y):
        with npt.plate("N", X.shape[0], subsample_size=sub):
            npt.subsample(X, event_dim=1)

    def no_plate(X, y):
        return npt.subsample(X, event_dim=1)

    seeded = lambda fn, *a: lambda: handlers.seed(fn, 0)(*a)  # noqa: E731
    res["raises"] = {"local_size": raises(seeded(local_size, Xs, ys), ValueError)}
    # what used to raise: subsample() with no plate or one that does not
    # subsample gives the tagged rows back, as the JAX package its array
    res["returned"] = {
        "unsubsampled": type(handlers.seed(unsubsampled, 0)(Xs, ys)).__name__,
        "no_plate": type(handlers.seed(no_plate, 0)(Xs, ys)).__name__,
        "outside": type(npt.subsample(Xs, event_dim=1)).__name__,
    }
    return res


def coupled_kernel(name):
    """ChEES and the ensembles on the covtype-shape model (AIES with both
    of its moves, so that the move is drawn)."""
    if name.startswith("CheesHMC"):
        return CheesHMC(model=glm_model, step_size=0.01, trajectory_length=0.1,
                        max_num_steps=8)
    if name == "AIES":
        return AIES(model=glm_model, moves={AIES.DEMove(): 0.5, AIES.StretchMove(): 0.5})
    return ESS(model=glm_model)


def coupled_run(name, chain_method, mesh=None):
    """A run of ``name`` (``CheesHMC_padded``: one chain fewer, which two
    chain shards pad): its draws and its last state (generators left out)."""
    chains, warmup, samples = CHEES_RUN if name.startswith("CheesHMC") else ENSEMBLE_RUN
    chains -= name.endswith("_padded")
    m = MCMC(coupled_kernel(name), num_warmup=warmup, num_samples=samples, num_chains=chains,
             chain_method=chain_method, mesh=mesh, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ensembles want more walkers than 2 x 9
        m.run(6, glm_data())
    return {"w": m.get_samples(group_by_chain=True)["w"],
            "last": core.replace_draw_sources(m.last_state, None)}


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


def _wait_for_file(path):
    deadline = time.time() + 240
    while not os.path.exists(path):
        if time.time() > deadline or os.path.exists(path + ".failed"):
            raise RuntimeError(f"the test did not write {os.path.basename(path)}")
        time.sleep(0.2)


def pooled_on_jax_draws(mesh, out):
    """The port's pooled warmup through the per-step API, each transition
    fed the JAX package's keys of that step (``OUT/jax_pooled.pt``)."""
    import jax.numpy as jnp

    path = os.path.join(out, "jax_pooled.pt")
    _wait_for_file(path)
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
    res["coupled"] = {name: coupled_run(name, "parallel", mesh) for name in COUPLED}
    res["smc"] = raises(lambda: SMC(glm_model, device="cpu").run(0, glm_data()),
                        NotImplementedError)
    res["jax_pooled"] = pooled_on_jax_draws(mesh, out)
    return res


def job_four(rank, out):
    mesh = chain_data_mesh(2, 2, device="cpu")
    res = {"backend": torch.distributed.get_backend(), "mesh": mesh_facts(mesh)}
    res["mismatch"] = raises(lambda: chain_data_mesh(3, None, device="cpu"), ValueError)
    X, y, _ = covtype_like(SHARDED_ROWS)
    Xs, ys = shard_data(torch.from_numpy(X), mesh), shard_data(torch.from_numpy(y), mesh)
    shard = mesh.chain_shard(GLM_SHAPE[2])
    w = shard.take(torch.from_numpy(glm_weights()))
    res["glm"] = {}
    for mode in GLM_MODES:
        data = glm.prepare_glm_data(Xs, ys, dtype=GLM_MODES[mode])
        mesh_lib.reset_collective_counts()
        glm.reset_launch_counts()
        g, ll = torch.func.vmap(torch.func.grad_and_value(glm.bernoulli_logits_loglik),
                                in_dims=(0, None))(w, data)
        res["glm"][mode] = {"rows": (Xs.data_shard.start, Xs.data_shard.stop), "n": data.n,
                            "all_reduce": mesh_lib.collective_counts["all_reduce"],
                            "plain": glm.launch_counts["plain"],
                            "ll": shard.gather(ll), "grad": shard.gather(g)}
    res["nuts"] = fused_run(8, True, "parallel", mesh, glm_data(mesh))
    res["subsample"] = shard_subsample_checks(mesh)
    res["ecs"] = ecs_run("parallel", mesh, data_mesh=mesh)
    res["ecs_proxy"] = ecs_proxy_steps(mesh)
    res["ecs_jax"] = ecs_on_jax_draws(mesh, out)
    res["parity"] = {case: parity_potential(case, mesh) for case in PARITY}
    res["shard_nuts"] = shard_nuts_run("parallel", mesh)
    res["lean"] = ecs_lean_run(mesh)
    res["carry"] = ecs_lean_run(mesh, "carry")
    t0 = time.perf_counter()
    res["row_parity"] = {case: row_parity_potential(case, mesh) for case in ROW_PARITY}
    res["row_parity_forward"] = {case: row_parity_potential(case, mesh, forward=True)
                                 for case in ROW_FORWARD}
    res["row_nuts"] = row_nuts_run("parallel", mesh)
    res["row_predictive"] = row_predictive(mesh)
    res["row_s"] = time.perf_counter() - t0
    chains = chain_mesh(device="cpu")
    res["padded"] = {name: padded_ensemble_run(name, chains) for name in PADDED}
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
