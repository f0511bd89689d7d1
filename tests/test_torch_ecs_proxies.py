"""The port's ``contrib.ecs_proxies`` against the JAX package's on the same
numpy inputs: the block refresh on JAX's draws, the Taylor proxy's
statistics, merge and totals (degree 1 and 2, ``stats`` and ``recompute``),
and the difference estimator's potential and gradient per chain (rtol 1e-4)."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.handlers as jhandlers
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.contrib import ecs_proxies as jecs
from numpyro_tpu.infer import hmc_gibbs as jgibbs
from numpyro_tpu.infer import util as jutil
from numpyro_tpu.infer.initialization import init_to_sample as j_init_to_sample
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib import ecs_proxies as tecs
from numpyro_tpu_torch.infer import HMCECS, NUTS, init_to_sample
from numpyro_tpu_torch.infer import hmc_gibbs as tgibbs
from numpyro_tpu_torch.infer import util

torch.set_num_threads(1)

N, D, M, BLOCKS, C = 2000, 4, 100, 10, 3
BS = M // BLOCKS
RTOL = 1e-4
PLATES = {"N": (N, M)}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    ref = np.array([0.7, -0.4, 0.2, 0.9], np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ ref))).astype(np.float32)
    idx = np.stack([rng.permutation(N)[:M] for _ in range(C)])
    ws = (ref + 0.05 * rng.standard_normal((C, D))).astype(np.float32)
    return X, y, ref, idx, ws


def jax_model(X, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    with numpyro_tpu.plate("N", X.shape[0], subsample_size=M):
        xb = numpyro_tpu.subsample(X, event_dim=1)
        yb = numpyro_tpu.subsample(y, event_dim=0)
        numpyro_tpu.sample("obs", jdist.Bernoulli(logits=xb @ w), obs=yb)


def torch_model(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    with npt.plate("N", X.shape[0], subsample_size=M):
        xb = npt.subsample(X, event_dim=1)
        yb = npt.subsample(y, event_dim=0)
        npt.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)


class BlockDraws:
    """A draw source that hands ``block_refresh`` JAX's block numbers and
    replacement rows (one entry per call)."""

    def __init__(self, pairs):
        self.pairs = list(pairs)

    def block(self, idx, num_blocks, block_size, size):
        b, repl = self.pairs.pop(0)
        assert repl.shape[-1] == block_size
        return torch.from_numpy(np.array(b, dtype=np.int64)), torch.from_numpy(
            np.array(repl, dtype=np.int64))


def _jax_refresh(keys, idx):
    """JAX's refresh of every chain, with the keys split as ``proxy_update``
    splits them for a model with one plate."""
    site_keys = jax.vmap(lambda k: random.split(k, 1)[0])(keys)
    return jax.vmap(lambda k, i: jecs.block_refresh(k, i, N, BLOCKS))(site_keys, jnp.asarray(idx))


@pytest.fixture(scope="module")
def built():
    """Prototype traces and the proxies of both packages, by degree and mode."""
    X, y, ref, idx, ws = _data()
    args_j = (jnp.asarray(X), jnp.asarray(y))
    args_t = (torch.from_numpy(X), torch.from_numpy(y))
    proto_j = jhandlers.trace(jhandlers.substitute(
        jhandlers.seed(jax_model, random.PRNGKey(0)), substitute_fn=j_init_to_sample()
    )).get_trace(*args_j)
    proto_t = handlers.trace(handlers.substitute(
        handlers.seed(torch_model, 0), substitute_fn=init_to_sample()
    )).get_trace(*args_t)
    out = {"args_j": args_j, "args_t": args_t, "proto_j": proto_j, "proto_t": proto_t}
    for degree in (1, 2):
        for mode in ("stats", "recompute"):
            out[degree, mode] = (
                jecs.taylor_proxy({"w": ref}, degree, mode=mode)(
                    proto_j, PLATES, jax_model, args_j, {}, num_blocks=BLOCKS),
                tecs.taylor_proxy({"w": ref}, degree, mode=mode)(
                    proto_t, PLATES, torch_model, args_t, {}, num_blocks=BLOCKS),
            )
    return out


def test_block_refresh_matches_jax_on_its_draws():
    _, _, _, idx, _ = _data()
    keys = random.split(random.PRNGKey(1), C)
    new_j, mask_j, repl_j, start_j = jax.vmap(
        lambda k, i: jecs.block_refresh(k, i, N, BLOCKS))(keys, jnp.asarray(idx))
    draws = BlockDraws([(np.asarray(start_j) // BS, np.asarray(repl_j))])
    new_t, mask_t, repl_t, start_t = tecs.block_refresh(draws, torch.from_numpy(idx), N, BLOCKS)
    assert new_t.dtype == torch.int64
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(start_t.numpy(), np.asarray(start_j))
    assert (mask_t.sum(-1) == BS).all() and not torch.equal(new_t, torch.from_numpy(idx))
    # one chain, unbatched, as the single-chain API hands it over
    one = BlockDraws([(np.asarray(start_j[0]) // BS, np.asarray(repl_j[0]))])
    got = tecs.block_refresh(one, torch.from_numpy(idx[0]), N, BLOCKS)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(new_j[0]))


def test_block_refresh_from_a_generator():
    from numpyro_tpu_torch.infer.hmc_core import GeneratorDraws

    _, _, _, idx, _ = _data()
    m_odd = 95  # a last block that is cut short: ceil(95 / 10) = 10 per block
    idx_t = torch.from_numpy(idx[:, :m_odd])
    draws = GeneratorDraws(torch.Generator().manual_seed(0))
    new, mask, repl, start = tecs.block_refresh(draws, idx_t, N, BLOCKS)
    assert repl.shape == (C, 10) and int(repl.max()) < N and int(repl.min()) >= 0
    assert torch.equal(new[~mask], idx_t[~mask])
    for c in range(C):
        s = int(start[c])
        k = int(mask[c].sum())
        assert k == min(10, m_odd - s) and torch.equal(new[c, s : s + k], repl[c, :k])
    both, state = tecs.block_update(PLATES, BLOCKS, draws, {"N": idx_t}, ("kept",))
    assert state == ("kept",) and both["N"].shape == idx_t.shape


@pytest.mark.parametrize("degree", [1, 2])
def test_proxy_init_update_and_totals_match_jax(built, degree):
    _, _, ref, idx, ws = _data()
    (fn_j, init_j, update_j), (fn_t, init_t, update_t) = built[degree, "stats"]
    assert fn_t.mode == "stats"
    stats_j = jax.vmap(init_j)({"N": jnp.asarray(idx)})
    stats_t = torch.func.vmap(init_t)({"N": torch.from_numpy(idx)})
    np.testing.assert_allclose(stats_t.value["N"].numpy(), np.asarray(stats_j.value["N"]),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(stats_t.grad["N"].numpy(), np.asarray(stats_j.grad["N"]),
                               rtol=RTOL, atol=1e-5)
    assert stats_t.grad["N"].shape == (C, M, D)

    # the block update: JAX's draws in, the same indices and merged panels out
    keys = random.split(random.PRNGKey(2), C)
    new_j, stats2_j = jax.vmap(update_j)(keys, {"N": jnp.asarray(idx)}, stats_j)
    _, _, repl_j, start_j = _jax_refresh(keys, idx)
    draws = BlockDraws([(np.asarray(start_j) // BS, np.asarray(repl_j))])
    new_t, stats2_t = update_t(draws, {"N": torch.from_numpy(idx)}, stats_t)
    np.testing.assert_array_equal(new_t["N"].numpy(), np.asarray(new_j["N"]))
    np.testing.assert_allclose(stats2_t.value["N"].numpy(), np.asarray(stats2_j.value["N"]),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(stats2_t.grad["N"].numpy(), np.asarray(stats2_j.grad["N"]),
                               rtol=RTOL, atol=1e-5)
    # the merged panels are the statistics at the new indices
    fresh = torch.func.vmap(init_t)(new_t)
    np.testing.assert_allclose(stats2_t.grad["N"].numpy(), fresh.grad["N"].numpy(),
                               rtol=1e-5, atol=1e-6)

    # the totals of the control variate, per chain
    all_j, sub_j = jax.vmap(lambda w, s, i: fn_j({"w": w}, ("N",), s, {"N": i}))(
        jnp.asarray(ws), stats_j, jnp.asarray(idx))
    all_t, sub_t = torch.func.vmap(lambda w, s, i: fn_t({"w": w}, ("N",), s, {"N": i}))(
        torch.from_numpy(ws), stats_t, torch.from_numpy(idx))
    np.testing.assert_allclose(all_t["N"].numpy(), np.asarray(all_j["N"]), rtol=1e-5)
    np.testing.assert_allclose(sub_t["N"].numpy(), np.asarray(sub_j["N"]), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("degree", [1, 2])
def test_recompute_and_stats_agree_pointwise(built, degree):
    """As tests/infer/test_ecs_modes.py:78: recompute mode reformulates the
    same totals, it does not approximate them."""
    _, _, ref, idx, ws = _data()
    (_, _, _), (fn_s, init_s, _) = built[degree, "stats"]
    (fn_jr, init_jr, _), (fn_r, init_r, update_r) = built[degree, "recompute"]
    assert fn_r.mode == "recompute" and init_r({"N": torch.from_numpy(idx[0])}) == ()
    i_t, w_t = {"N": torch.from_numpy(idx[0])}, {"w": torch.from_numpy(ws[0])}
    all_s, sub_s = fn_s(w_t, ("N",), init_s(i_t), idx_dict=i_t)
    all_r, sub_r = fn_r(w_t, ("N",), (), idx_dict=i_t)
    np.testing.assert_allclose(all_s["N"].numpy(), all_r["N"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(sub_s["N"].numpy(), sub_r["N"].numpy(), rtol=1e-4, atol=1e-4)
    i_j, w_j = {"N": jnp.asarray(idx[0])}, {"w": jnp.asarray(ws[0])}
    all_j, sub_j = fn_jr(w_j, ("N",), init_jr(i_j), idx_dict=i_j)
    np.testing.assert_allclose(sub_r["N"].numpy(), np.asarray(sub_j["N"]), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(all_r["N"].numpy(), np.asarray(all_j["N"]), rtol=1e-5)
    with pytest.raises(ValueError, match="requires the subsample indices"):
        fn_r(w_t, ("N",), ())
    new_idx, state = update_r(
        BlockDraws([(np.zeros(C, np.int64), np.zeros((C, BS), np.int64))]),
        {"N": torch.from_numpy(idx)}, ())
    assert state == () and bool((new_idx["N"][:, :BS] == 0).all())


def _potentials(built, degree, mode, with_panels):
    """The estimator-wrapped potential of every chain in both packages, built
    as ``HMCECS`` builds it."""
    X, y, ref, idx, ws = _data()
    (fn_j, init_j, _), (fn_t, init_t, _) = built[degree, mode]
    base_j = partial(jgibbs._wrap_gibbs_state, partial(jgibbs._wrap_model, jax_model))
    base_t = partial(tgibbs._wrap_gibbs_state, partial(tgibbs._wrap_model, torch_model))
    est_j = jecs.subsample_estimator(base_j, PLATES, fn_j)
    est_t = tecs.subsample_estimator(base_t, PLATES, fn_t)
    stats_j = jax.vmap(init_j)({"N": jnp.asarray(idx)})
    stats_t = torch.func.vmap(init_t)({"N": torch.from_numpy(idx)})
    panels = (X[idx], y[idx])

    def pe_j(w, i, s, p):
        kw = {"_gibbs_sites": {"N": i}, "_gibbs_state": s}
        if with_panels:
            kw["_subsample_panels"] = p
        return jutil.potential_energy(est_j, built["args_j"], kw, {"w": w})

    def pe_t(w, i, s, p):
        kw = {"_gibbs_sites": {"N": i}, "_gibbs_state": s}
        if with_panels:
            kw["_subsample_panels"] = p
        return util.potential_energy(est_t, built["args_t"], kw, {"w": w})

    v_j, g_j = jax.vmap(jax.value_and_grad(pe_j))(
        jnp.asarray(ws), jnp.asarray(idx), stats_j, tuple(jnp.asarray(p) for p in panels))
    g_t, v_t = torch.func.vmap(torch.func.grad_and_value(pe_t))(
        torch.from_numpy(ws), torch.from_numpy(idx), stats_t,
        tuple(torch.from_numpy(p) for p in panels))
    return (v_t.numpy(), g_t.numpy()), (np.asarray(v_j), np.asarray(g_j))


@pytest.mark.parametrize(
    "degree,mode,with_panels",
    [(2, "stats", True), (2, "stats", False), (2, "recompute", True), (1, "stats", True),
     (1, "recompute", False)],
)
def test_estimator_potential_and_gradient_match_jax(built, degree, mode, with_panels):
    (v_t, g_t), (v_j, g_j) = _potentials(built, degree, mode, with_panels)
    assert v_t.shape == (C,) and g_t.shape == (C, D)
    np.testing.assert_allclose(v_t, v_j, rtol=RTOL)
    np.testing.assert_allclose(g_t, g_j, rtol=RTOL, atol=1e-4 * np.abs(g_j).max())
    # the estimate stands near the full-data potential it estimates
    X, y, _, _, ws = _data()
    logits = X @ ws[0]
    full = -(y * logits - np.logaddexp(0, logits)).sum() + 0.5 * (ws[0] ** 2).sum()
    full += 0.5 * D * np.log(2 * np.pi)
    assert abs(v_t[0] - full) < 2.0


def test_estimator_leaves_tracing_untouched(built):
    """Outside a potential evaluation the wrapped model is the model."""
    _, (fn_t, _, _) = built[2, "stats"]
    _, _, _, idx, ws = _data()
    est = tecs.subsample_estimator(torch_model, PLATES, fn_t)
    tr = handlers.trace(handlers.substitute(
        est, data={"N": torch.from_numpy(idx[0]), "w": torch.from_numpy(ws[0])}
    )).get_trace(*built["args_t"])
    assert "_subsample_likelihood_estimate" not in tr
    assert not isinstance(tr["obs"]["fn"], dist.MaskedDistribution)


def test_auto_mode_resolves_by_budget(built):
    _, _, ref, _, _ = _data()
    make = tecs.taylor_proxy({"w": ref}, mode="auto")
    common = (built["proto_t"], PLATES, torch_model, built["args_t"], {})
    roomy = make(*common, num_blocks=BLOCKS, num_chains=4)
    assert roomy[0].mode == "stats"
    # 3 * 1000 chains * 100 rows * 5 floats * 4 B = 6 MB of panels against 15%
    # of a 10 MB budget
    tight = make(*common, num_blocks=BLOCKS, num_chains=1000, hbm_budget=10e6)
    assert tight[0].mode == "recompute"
    assert tecs._device_memory_bytes("cpu") == 1e12


def test_reference_params_as_tensors_or_numpy(built):
    _, _, ref, idx, ws = _data()
    common = (built["proto_t"], PLATES, torch_model, built["args_t"], {})
    i_t, w_t = {"N": torch.from_numpy(idx[0])}, {"w": torch.from_numpy(ws[0])}
    outs = []
    for given in (ref, torch.from_numpy(ref), ref.astype(np.float64).tolist()):
        fn, init, _ = tecs.taylor_proxy({"w": given}, mode="stats")(*common, num_blocks=BLOCKS)
        outs.append(fn(w_t, ("N",), init(i_t), idx_dict=i_t)[1]["N"])
    for other in outs[1:]:
        np.testing.assert_array_equal(other.numpy(), outs[0].numpy())


def test_bad_arguments_raise_as_jax():
    for mod in (tecs, jecs):
        with pytest.raises(ValueError, match="degree 1 or 2"):
            mod.taylor_proxy({}, degree=3)
        with pytest.raises(ValueError, match="stats\\|recompute\\|auto"):
            mod.taylor_proxy({}, mode="lean")


def test_proxy_rejects_discrete_latents_as_jax():
    X, y, ref, _, _ = _data()

    def jm(X, y):
        numpyro_tpu.sample("flip", jdist.Bernoulli(probs=0.5))
        jax_model(X, y)

    def tm(X, y):
        npt.sample("flip", dist.Bernoulli(probs=torch.tensor(0.5)))
        torch_model(X, y)

    from numpyro_tpu.infer import HMCECS as JHMCECS, NUTS as JNUTS

    with pytest.raises(RuntimeError, match="discrete latent sites"):
        JHMCECS(JNUTS(jm), proxy=JHMCECS.taylor_proxy({"w": ref})).init(
            random.PRNGKey(0), 1, None, (jnp.asarray(X), jnp.asarray(y)), {})
    with pytest.raises(RuntimeError, match="discrete latent sites"):
        HMCECS(NUTS(tm), proxy=HMCECS.taylor_proxy({"w": ref})).init(
            torch.Generator().manual_seed(0), 1, None,
            (torch.from_numpy(X), torch.from_numpy(y)), {})
