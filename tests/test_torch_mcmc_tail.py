"""The MCMC and SVI drivers' remaining options and the one-device helpers,
against the port's own runs and the JAX package's: a callable
``chain_method`` against ``"sequential"`` (bit for bit), the progress bars
with ``tqdm`` and with its import failing (the same draws and losses as
without a bar), ``transfer_states_to_host``, ``parallel``'s
``cross_chain_diagnostics`` and ``pooled_step_size``,
``hmc.momentum_generator`` (diagonal, dense and structured mass, on JAX's
normals) and ``constraints.is_dependent``.

Tolerances: exact where the port is held to itself; rtol 1e-5 on the
diagnostics and 1e-6 on the momenta against JAX (float32 both)."""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.distributions import constraints as jconstraints
from numpyro_tpu.infer import hmc as jhmc
from numpyro_tpu.parallel import cross_chain_diagnostics as jcross, pooled_step_size as jpooled
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.infer import MCMC, NUTS, SVI, BarkerMH, Trace_ELBO, hmc
from numpyro_tpu_torch.infer.autoguide import AutoNormal
from numpyro_tpu_torch.optim import Adam
from numpyro_tpu_torch.parallel import cross_chain_diagnostics, pooled_step_size
from numpyro_tpu_torch.util import tree_leaves, tree_map

torch.set_num_threads(1)


def _model():
    a = npt.sample("a", dist.Normal(0.0, 1.0))
    npt.sample("b", dist.Normal(a, 0.5).expand([2]).to_event(1))


def _kernel(kind):
    return NUTS(_model, max_tree_depth=3) if kind == "nuts" else BarkerMH(_model)


def sequential_map(one_chain):
    """A callable ``chain_method`` that maps in order: lane ``i`` takes
    generator ``i`` and chain ``i`` of the params; the outputs are stacked
    on a new leading axis."""

    def mapped(generators, init_params):
        outs = [one_chain(g, tree_map(lambda x: x[i], init_params))
                for i, g in enumerate(generators)]
        return tree_map(lambda *xs: torch.stack(xs), *outs)

    return mapped


def _run(kind, chain_method, seed=3, init_params=None, **kw):
    mcmc = MCMC(_kernel(kind), num_warmup=15, num_samples=10, num_chains=3,
                chain_method=chain_method, device="cpu", **kw)
    mcmc.run(seed, extra_fields=("potential_energy",), init_params=init_params)
    return mcmc


@pytest.mark.parametrize("kind", ["nuts", "barker"])
@pytest.mark.parametrize("with_params", [False, True])
def test_callable_chain_method_gives_sequential_draws(kind, with_params):
    """A callable that maps sequentially gives ``"sequential"``'s draws,
    extra fields and last state, bit for bit: on the fused run (NUTS) and on
    the per-step API (BarkerMH), from the model's init or from given
    params."""
    params = {"a": torch.tensor([0.1, -0.2, 0.3]), "b": torch.zeros(3, 2)} if with_params else None
    seq = _run(kind, "sequential", init_params=params)
    mapped = _run(kind, sequential_map, init_params=params)
    for k, v in seq.get_samples(group_by_chain=True).items():
        assert torch.equal(mapped.get_samples(group_by_chain=True)[k], v), k
    for k, v in seq.get_extra_fields(group_by_chain=True).items():
        assert torch.equal(mapped.get_extra_fields(group_by_chain=True)[k], v), k
    for x, y in zip(tree_leaves(seq.last_state), tree_leaves(mapped.last_state), strict=True):
        assert torch.equal(x, y)
    assert mapped.last_run_stats["potential_evals"] == seq.last_run_stats["potential_evals"]


def test_callable_chain_method_refuses_a_warmed_up_state():
    mcmc = MCMC(_kernel("nuts"), num_warmup=5, num_samples=3, num_chains=2,
                chain_method=sequential_map, device="cpu")
    mcmc.warmup(0)
    with pytest.raises(ValueError, match="post_warmup_state"):
        mcmc.run(1)


@pytest.fixture(params=["tqdm", "no_tqdm"])
def bar_env(request, monkeypatch):
    """Runs with ``tqdm`` (if installed), or with its import failing."""
    if request.param == "tqdm":
        pytest.importorskip("tqdm")
    else:
        monkeypatch.setitem(sys.modules, "tqdm", None)
        monkeypatch.setitem(sys.modules, "tqdm.auto", None)
    return request.param


@pytest.mark.parametrize("kind,chain_method", [("nuts", "vectorized"), ("barker", "vectorized"),
                                               ("nuts", "sequential")])
def test_progress_bar_leaves_the_draws_as_they_are(kind, chain_method, bar_env, capsys):
    """With ``progress_bar=True`` the run is the one without a bar: the same
    draws, on the fused run, the per-step API and sequential chains; the bar
    is written to stderr where ``tqdm`` is there."""
    plain = _run(kind, chain_method)
    with_bar = _run(kind, chain_method, progress_bar=True)
    for k, v in plain.get_samples(group_by_chain=True).items():
        assert torch.equal(with_bar.get_samples(group_by_chain=True)[k], v), k
    err = capsys.readouterr().err
    assert ("sample" in err) == (bar_env == "tqdm")


def test_svi_progress_bar_leaves_the_losses_as_they_are(bar_env, capsys):
    def model():
        a = npt.sample("a", dist.Normal(0.0, 1.0))
        npt.sample("y", dist.Normal(a, 0.5), obs=torch.tensor([0.3, 0.9]))

    svi = SVI(model, AutoNormal(model), Adam(0.05), Trace_ELBO(), device="cpu")
    plain = svi.run(0, 45)
    with_bar = svi.run(0, 45, progress_bar=True)
    assert torch.equal(with_bar.losses, plain.losses)
    for k, v in plain.params.items():
        assert torch.equal(with_bar.params[k], v)
    assert ("loss:" in capsys.readouterr().err) == (bar_env == "tqdm")


def test_transfer_states_to_host_keeps_the_results():
    """After the transfer the states live on the CPU and ``get_samples``,
    ``get_extra_fields`` and ``print_summary`` give what they gave before."""
    mcmc = _run("nuts", "vectorized")
    samples = tree_map(torch.clone, mcmc.get_samples(group_by_chain=True))
    flat = tree_map(torch.clone, mcmc.get_samples())
    extra = tree_map(torch.clone, mcmc.get_extra_fields())
    with redirect_stdout(io.StringIO()) as before:
        mcmc.print_summary()
    mcmc.transfer_states_to_host()
    for got, want in ((mcmc.get_samples(group_by_chain=True), samples),
                      (mcmc.get_samples(), flat), (mcmc.get_extra_fields(), extra)):
        for k, v in want.items():
            assert got[k].device.type == "cpu" and torch.equal(got[k], v), k
    assert all(leaf.device.type == "cpu" for leaf in tree_leaves(mcmc.last_state))
    with redirect_stdout(io.StringIO()) as after:
        mcmc.print_summary()
    assert after.getvalue() == before.getvalue() and "Number of divergences" in after.getvalue()


def test_cross_chain_helpers_match_jax():
    """``cross_chain_diagnostics`` on a dict of ``(C, N, ...)`` draws and
    ``pooled_step_size`` on a ``(C,)`` panel and on a state holding it, on
    the same numpy inputs as the JAX package's."""
    rng = np.random.default_rng(0)
    draws = {"a": rng.normal(size=(4, 50)).astype(np.float32),
             "b": (rng.normal(size=(4, 50, 3)) + np.arange(4)[:, None, None] * 0.3).astype(np.float32)}
    got = cross_chain_diagnostics({k: torch.from_numpy(v) for k, v in draws.items()})
    # jitted: the JAX package's eager diagnostics compile op by op
    want = jax.jit(jcross)({k: jnp.asarray(v) for k, v in draws.items()})
    for k in draws:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    steps = rng.uniform(0.05, 0.5, size=8).astype(np.float32)

    class State:
        step_size = torch.from_numpy(steps)

    want = np.asarray(jpooled(jnp.asarray(steps)))
    for adapt in (torch.from_numpy(steps), State()):
        np.testing.assert_allclose(pooled_step_size(adapt).numpy(), want, rtol=1e-6)


def _feed_normals(monkeypatch, arrays):
    """Hand ``torch.randn`` the given arrays in order."""
    queue = [torch.from_numpy(np.asarray(a)) for a in arrays]

    def randn(shape, **kwargs):
        out = queue.pop(0)
        assert tuple(out.shape) == tuple(shape)
        return out

    monkeypatch.setattr(torch, "randn", randn)
    return queue


def test_momentum_generator_matches_jax(monkeypatch):
    """Diagonal, dense and structured (dict) mass on JAX's own normals: the
    port draws each block's normals in JAX's order."""
    rng = np.random.default_rng(1)
    proto = {"x": np.zeros((2,), np.float32), "y": np.zeros((), np.float32),
             "z": np.zeros((2, 2), np.float32)}
    jproto = {k: jnp.asarray(v) for k, v in proto.items()}
    tproto = {k: torch.from_numpy(v) for k, v in proto.items()}
    key = random.PRNGKey(3)
    diag = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    dense = np.tril(rng.normal(size=(7, 7))).astype(np.float32) + 3 * np.eye(7, dtype=np.float32)
    blocks = {("x", "y"): np.tril(rng.normal(size=(3, 3))).astype(np.float32) + 2 * np.eye(3),
              ("z",): rng.uniform(0.5, 2.0, 4).astype(np.float32)}
    blocks = {k: v.astype(np.float32) for k, v in blocks.items()}
    for mass in (diag, dense, blocks):
        if isinstance(mass, dict):
            keys = random.split(key, len(mass))
            normals = [random.normal(k, (v.shape[0],)) for k, v in zip(keys, mass.values())]
            jmass = {k: jnp.asarray(v) for k, v in mass.items()}
            tmass = {k: torch.from_numpy(v) for k, v in mass.items()}
        else:
            normals = [random.normal(key, (7,))]
            jmass, tmass = jnp.asarray(mass), torch.from_numpy(mass)
        want = jhmc.momentum_generator(jproto, jmass, key)
        queue = _feed_normals(monkeypatch, normals)
        got = hmc.momentum_generator(tproto, tmass, torch.Generator())
        assert not queue and set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    monkeypatch.undo()
    r = hmc.momentum_generator(torch.zeros(3), torch.ones(3), torch.Generator().manual_seed(0))
    assert r.shape == (3,)
    with pytest.raises(ValueError, match="1- or 2-dimensional"):
        hmc.momentum_generator(torch.zeros(2), torch.ones(1, 2, 2), torch.Generator())


def test_is_dependent_matches_jax():
    for t, j in ((constraints.dependent, jconstraints.dependent),
                 (constraints.dependent(is_discrete=True), jconstraints.dependent(is_discrete=True)),
                 (constraints.real, jconstraints.real), (constraints.simplex, jconstraints.simplex)):
        assert constraints.is_dependent(t) == jconstraints.is_dependent(j)
    assert constraints.is_dependent(constraints.dependent)
