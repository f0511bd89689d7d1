"""``plate`` / ``subsample`` / scale, ``get_mask`` and the ``mask`` handler of
the port against the JAX package's: the same numpy inputs and the same
substituted subsample indices go through both (log densities to rtol 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.handlers as jhandlers
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.contrib.ecs_proxies import subsample_panels as j_subsample_panels
from numpyro_tpu.infer import util as jutil
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.ecs_proxies import subsample_panels
from numpyro_tpu_torch.infer import util

torch.set_num_threads(1)

N, D, M = 2000, 5, 100
RTOL = 1e-5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    w0 = np.linspace(-1, 1, D).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ w0))).astype(np.float32)
    idx = rng.permutation(N)[:M]
    w = (w0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    return X, y, idx, w


def jax_model_ecs(X, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    with numpyro_tpu.plate("N", X.shape[0], subsample_size=M):
        xb = numpyro_tpu.subsample(X, event_dim=1)
        yb = numpyro_tpu.subsample(y, event_dim=0)
        numpyro_tpu.sample("obs", jdist.Bernoulli(logits=xb @ w), obs=yb)


def torch_model_ecs(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    with npt.plate("N", X.shape[0], subsample_size=M):
        xb = npt.subsample(X, event_dim=1)
        yb = npt.subsample(y, event_dim=0)
        npt.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)


def _both_traces(idx, w, X, y):
    jm = jhandlers.substitute(jax_model_ecs, data={"N": jnp.asarray(idx)})
    tm = handlers.substitute(torch_model_ecs, data={"N": torch.from_numpy(idx)})
    ld_j, tr_j = jutil.log_density(jm, (jnp.asarray(X), jnp.asarray(y)), {}, {"w": jnp.asarray(w)})
    ld_t, tr_t = util.log_density(
        tm, (torch.from_numpy(X), torch.from_numpy(y)), {}, {"w": torch.from_numpy(w)}
    )
    return ld_j, tr_j, ld_t, tr_t


def test_model_ecs_log_density_and_trace_match_jax():
    X, y, idx, w = _data()
    ld_j, tr_j, ld_t, tr_t = _both_traces(idx, w, X, y)
    np.testing.assert_allclose(ld_t.item(), float(ld_j), rtol=RTOL)
    assert list(tr_t) == list(tr_j) == ["w", "N", "obs"]
    for name in tr_j:
        s_j, s_t = tr_j[name], tr_t[name]
        assert s_t["type"] == s_j["type"]
        assert s_t["scale"] == s_j["scale"], name
        assert [tuple(f) for f in s_t["cond_indep_stack"]] == [
            tuple(f) for f in s_j["cond_indep_stack"]
        ]
        np.testing.assert_allclose(s_t["value"].numpy(), np.asarray(s_j["value"]), rtol=RTOL)
    assert tr_t["obs"]["scale"] == N / M
    assert tr_t["N"]["args"] == tr_j["N"]["args"] == (N, M)
    frame = tr_t["obs"]["cond_indep_stack"][0]
    assert (frame.name, frame.dim, frame.size, frame.subsample_size) == ("N", -1, N, M)


def test_model_ecs_gradient_under_vmap_matches_jax():
    """The subsampled potential per chain, each chain with its own indices,
    as the ECS kernel evaluates it."""
    import jax

    X, y, _, w = _data(1)
    rng = np.random.default_rng(2)
    C = 3
    idx = np.stack([rng.permutation(N)[:M] for _ in range(C)])
    ws = (w + 0.1 * rng.standard_normal((C, D))).astype(np.float32)

    def pe_j(w_c, i_c):
        m = jhandlers.substitute(jax_model_ecs, data={"N": i_c})
        return jutil.potential_energy(m, (jnp.asarray(X), jnp.asarray(y)), {}, {"w": w_c})

    def pe_t(w_c, i_c):
        m = handlers.substitute(torch_model_ecs, data={"N": i_c})
        return util.potential_energy(m, (torch.from_numpy(X), torch.from_numpy(y)), {}, {"w": w_c})

    v_j, g_j = jax.vmap(jax.value_and_grad(pe_j))(jnp.asarray(ws), jnp.asarray(idx))
    g_t, v_t = torch.func.vmap(torch.func.grad_and_value(pe_t))(
        torch.from_numpy(ws), torch.from_numpy(idx)
    )
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-3)


def test_seeded_plate_draws_without_replacement():
    X, y, _, _ = _data()
    tr = handlers.trace(handlers.seed(torch_model_ecs, 3)).get_trace(
        torch.from_numpy(X), torch.from_numpy(y)
    )
    idx = tr["N"]["value"]
    assert idx.shape == (M,) and idx.dtype == torch.int64
    assert len(set(idx.tolist())) == M and 0 <= int(idx.min()) and int(idx.max()) < N
    again = handlers.trace(handlers.seed(torch_model_ecs, 3)).get_trace(
        torch.from_numpy(X), torch.from_numpy(y)
    )["N"]["value"]
    assert torch.equal(idx, again)
    # the observed values are the rows that were drawn
    np.testing.assert_array_equal(tr["obs"]["value"].numpy(), y[idx.numpy()])


def test_unseeded_subsample_plate_raises_as_jax():
    X, y, _, w = _data()
    for run in (
        lambda: handlers.substitute(torch_model_ecs, data={"w": torch.from_numpy(w)})(
            torch.from_numpy(X), torch.from_numpy(y)),
        lambda: jhandlers.substitute(jax_model_ecs, data={"w": jnp.asarray(w)})(
            jnp.asarray(X), jnp.asarray(y)),
    ):
        with pytest.raises(ValueError, match="use HMCECS instead"):
            run()
    with pytest.raises(ValueError, match="dim arg must be negative"):
        npt.plate("p", 3, dim=0)


def test_nested_plates_match_jax():
    rng = np.random.default_rng(4)
    A, B, MB = 6, 40, 8
    data = rng.standard_normal((A, B)).astype(np.float32)
    loc = rng.standard_normal((A, 1)).astype(np.float32)
    idx = rng.permutation(B)[:MB]

    def jm(data):
        with numpyro_tpu.plate("a", A, dim=-2):
            mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, 1.0))
            with numpyro_tpu.plate("b", B, subsample_size=MB, dim=-1):
                batch = numpyro_tpu.subsample(data, event_dim=0)
                numpyro_tpu.sample("x", jdist.Normal(mu, 1.0), obs=batch)

    def tm(data):
        with npt.plate("a", A, dim=-2):
            mu = npt.sample("mu", dist.Normal(0.0, 1.0))
            with npt.plate("b", B, subsample_size=MB, dim=-1):
                batch = npt.subsample(data, event_dim=0)
                npt.sample("x", dist.Normal(mu, 1.0), obs=batch)

    ld_j, tr_j = jutil.log_density(
        jhandlers.substitute(jm, data={"b": jnp.asarray(idx)}), (jnp.asarray(data),), {},
        {"mu": jnp.asarray(loc)},
    )
    ld_t, tr_t = util.log_density(
        handlers.substitute(tm, data={"b": torch.from_numpy(idx)}), (torch.from_numpy(data),), {},
        {"mu": torch.from_numpy(loc)},
    )
    np.testing.assert_allclose(ld_t.item(), float(ld_j), rtol=RTOL)
    for name in ("mu", "x"):
        assert tuple(tr_t[name]["fn"].batch_shape) == tuple(tr_j[name]["fn"].batch_shape)
        assert tr_t[name]["scale"] == tr_j[name]["scale"]
        assert [tuple(f) for f in tr_t[name]["cond_indep_stack"]] == [
            tuple(f) for f in tr_j[name]["cond_indep_stack"]
        ]
    assert tuple(tr_t["x"]["value"].shape) == (A, MB)
    assert tr_t["x"]["scale"] == B / MB and tr_t["mu"]["scale"] is None
    # a plate without a given dim takes the first free one
    with npt.plate("a", A, dim=-1), npt.plate("c", 3) as c_idx:
        pass
    assert c_idx.tolist() == [0, 1, 2]


def test_plate_rejects_data_of_another_size():
    def tm(data):
        with npt.plate("b", 10, subsample_size=4):
            npt.subsample(data, event_dim=0)

    with pytest.raises(ValueError, match="invalid shape"):
        handlers.seed(tm, 0)(torch.zeros(7))


def test_pregathered_replay_matches_jax():
    """``subsample_panels`` records the takes of one run and replays them in
    another; a replayed bf16 panel reaches the model in the data's dtype."""
    X, y, idx, w = _data(5)
    args_j = (jnp.asarray(X), jnp.asarray(y))
    args_t = (torch.from_numpy(X), torch.from_numpy(y))
    out_j, out_t = [], []
    with j_subsample_panels(record=True, out=out_j):
        jhandlers.seed(jhandlers.substitute(jax_model_ecs, data={"N": jnp.asarray(idx)}), 0)(*args_j)
    with subsample_panels(record=True, out=out_t):
        handlers.seed(handlers.substitute(torch_model_ecs, data={"N": torch.from_numpy(idx)}), 0)(
            *args_t
        )
    assert len(out_t) == len(out_j) == 2
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(out_t[0].numpy(), X[idx])

    # replay with OTHER indices at the plate: the panels win
    other = torch.from_numpy(np.arange(M))
    tm = handlers.substitute(torch_model_ecs, data={"N": other})
    with subsample_panels(panels=out_t):
        ld_replay, _ = util.log_density(tm, args_t, {}, {"w": torch.from_numpy(w)})
    _, _, ld_direct, _ = _both_traces(idx, w, X, y)
    np.testing.assert_allclose(ld_replay.item(), ld_direct.item(), rtol=1e-6)
    with j_subsample_panels(panels=out_j):
        ld_j, _ = jutil.log_density(
            jhandlers.substitute(jax_model_ecs, data={"N": jnp.arange(M)}), args_j, {},
            {"w": jnp.asarray(w)},
        )
    np.testing.assert_allclose(ld_replay.item(), float(ld_j), rtol=RTOL)

    seen = {}

    def probe(X, y):
        with npt.plate("N", N, subsample_size=M):
            seen["xb"] = npt.subsample(X, event_dim=1)

    half = [p.to(torch.bfloat16) for p in out_t]
    with subsample_panels(panels=half):
        handlers.substitute(probe, data={"N": other})(*args_t)
    assert seen["xb"].dtype == torch.float32
    np.testing.assert_array_equal(seen["xb"].numpy(), half[0].float().numpy())


def test_mask_handler_and_get_mask_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(7).astype(np.float32)
    keep = rng.random(7) < 0.5

    def jm(mask):
        with jhandlers.mask(mask=mask):
            numpyro_tpu.sample("x", jdist.Normal(0.0, 1.0).expand([7]), obs=jnp.asarray(x))
            return numpyro_tpu.get_mask()

    def tm(mask):
        with handlers.mask(mask=mask):
            npt.sample("x", dist.Normal(0.0, 1.0).expand([7]), obs=torch.from_numpy(x))
            return npt.get_mask()

    for m_j, m_t in ((False, False), (True, True), (jnp.asarray(keep), torch.from_numpy(keep))):
        ld_j, _ = jutil.log_density(jm, (m_j,), {}, {})
        ld_t, _ = util.log_density(tm, (m_t,), {}, {})
        np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=RTOL, atol=1e-30)
    assert tm(False) is False and jm(False) is False
    assert npt.get_mask() is None and numpyro_tpu.get_mask() is None
    with pytest.raises(ValueError, match="bool"):
        handlers.mask(mask=torch.ones(3))


def test_handlers_pass_unknown_message_types():
    """``plate``, ``subsample``, ``inspect`` and the ECS kernel's own message
    types go through every handler untouched (``substitute`` binds plates)."""
    seen = []

    class spy(npt.primitives.Messenger):
        def process_message(self, msg):
            seen.append(msg["type"])

    def tm():
        npt.primitives.apply_stack({"type": "_gibbs_state", "value": (1,)})
        npt.primitives.apply_stack({"type": "_subsample_panels", "value": (2,)})
        with npt.plate("N", 10, subsample_size=3) as idx:
            npt.subsample(torch.arange(10.0), event_dim=0)
            npt.get_mask()
        return idx

    stack = spy(handlers.trace(handlers.condition(handlers.substitute(
        handlers.block(handlers.seed(tm, 0), hide_fn=lambda msg: False),
        data={"other": torch.zeros(())}), data={"other": torch.zeros(())})))
    idx = stack()
    assert seen == ["_gibbs_state", "_subsample_panels", "plate", "subsample", "inspect"]
    assert idx.shape == (3,)
    # block stops a plate as it stops a sample site, and still seeds it
    hidden = []

    class spy2(npt.primitives.Messenger):
        def process_message(self, msg):
            hidden.append(msg["type"])

    with handlers.seed(rng_seed=1), spy2(), handlers.block():
        assert tm().shape == (3,)
    assert hidden == ["prng_key"]
    # substitute hands a plate its indices and fixes the subsample size
    tr = handlers.trace(handlers.substitute(tm, data={"N": torch.tensor([4, 5])})).get_trace()
    assert tr["N"]["args"] == (10, 2) and tr["N"]["value"].tolist() == [4, 5]
