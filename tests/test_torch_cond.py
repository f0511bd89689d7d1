"""The effectful ``cond`` in the port against the JAX package's: the models
of the JAX package's own tests (``tests/test_control_flow.py``), the
predicate batched over chains under the port's NUTS potential
(``torch.func.vmap``, where both branches run and a select keeps the taken
one's sites), and the raising cases.  Potentials agree to rtol 1e-5, their
gradients with an atol of 1e-5 times their largest entry."""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu as jnpt
import numpyro_tpu.distributions as jdist
import numpyro_tpu.handlers as jhandlers
from numpyro_tpu.contrib.control_flow import cond as jcond
from numpyro_tpu.contrib.control_flow.cond import cond_wrapper as jcond_wrapper
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.control_flow import cond
from numpyro_tpu_torch.contrib.control_flow.cond import cond_wrapper
from numpyro_tpu_torch.infer import util

torch.set_num_threads(1)

RTOL = 1e-5
J = SimpleNamespace(npt=jnpt, dist=jdist, h=jhandlers, cond=jcond,
                    t=lambda x: jnp.asarray(np.asarray(x, np.float32)))
T = SimpleNamespace(npt=npt, dist=dist, h=handlers, cond=cond,
                    t=lambda x: torch.as_tensor(np.asarray(x, np.float32)))


def _cluster_model(P, locs=(20.0, 0.0)):
    """``test_cond_in_model``'s model (``test_cond_substitute``'s with
    ``locs=(10, -10)``)."""
    def cmodel():
        def tf(_):
            return P.npt.sample("x", P.dist.Normal(locs[0], 1.0))

        def ff(_):
            return P.npt.sample("x", P.dist.Normal(locs[1], 1.0))

        c = P.npt.sample("cluster", P.dist.Normal(0.0, 1.0))
        return P.cond(c > 0, tf, ff, None)
    return cmodel


def test_cond_in_model():
    with handlers.seed(rng_seed=0):
        v = _cluster_model(T)()
    assert np.isfinite(float(v))
    for P in (J, T):
        tr = P.h.trace(P.h.seed(_cluster_model(P), 1)).get_trace()
        assert [k for k in tr] == ["cluster", "x"]
        # the value and the distribution are those of the branch taken
        taken = 20.0 if float(tr["cluster"]["value"]) > 0 else 0.0
        assert float(tr["x"]["fn"].loc) == taken
        assert abs(float(tr["x"]["value"]) - taken) < 6.0


def test_cond_substitute():
    for P in (J, T):
        with P.h.seed(rng_seed=0):
            v = P.h.substitute(_cluster_model(P, (10.0, -10.0)), data={"x": P.t(3.21)})()
        np.testing.assert_allclose(float(v), 3.21, rtol=1e-6)


@pytest.mark.parametrize("cluster", [-0.7, 0.4])
def test_cond_log_density_matches_jax(cluster):
    params = {"cluster": cluster, "x": 1.3}
    lds = []
    for P in (J, T):
        fn = util.log_density if P is T else jutil.log_density
        seeded = P.h.seed(_cluster_model(P), 0) if P is T else \
            jhandlers.seed(_cluster_model(P), random.PRNGKey(0))
        ld, _ = fn(seeded, (), {}, {k: P.t(v) for k, v in params.items()})
        lds.append(float(ld))
    np.testing.assert_allclose(lds[1], lds[0], rtol=RTOL)


def _nuts_model(P, deterministic=False):
    """A latent predicate, both branches with the sites ``x`` (real) and
    ``s`` (positive: its log-Jacobian is a factor site inside the branch),
    and an observation downstream of the result; with ``deterministic`` a
    deterministic site ``d`` in each branch too."""
    def model(y):
        c = P.npt.sample("c", P.dist.Normal(0.0, 1.0))

        def tf(scale):
            x = P.npt.sample("x", P.dist.Normal(2.0 * scale, 1.0))
            s = P.npt.sample("s", P.dist.HalfNormal(1.0))
            if deterministic:
                P.npt.deterministic("d", x + 1.0)
            return x, s

        def ff(scale):
            x = P.npt.sample("x", P.dist.Normal(-1.0, 0.5 * scale))
            s = P.npt.sample("s", P.dist.HalfNormal(3.0))
            if deterministic:
                P.npt.deterministic("d", x - 1.0)
            return x, s

        x, s = P.cond(c > 0, tf, ff, P.t(1.5))
        with P.npt.plate("N", y.shape[0]):
            P.npt.sample("y", P.dist.Normal(x, s), obs=y)
    return model


def test_batched_predicate_under_the_nuts_potential():
    y = np.array([0.5, 2.5, -0.3], np.float32)
    rng = np.random.default_rng(0)
    z = {k: rng.normal(size=16).astype(np.float32) for k in ("c", "x", "s")}
    model_j, model_t = _nuts_model(J), _nuts_model(T)
    jvg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: jutil.potential_energy(model_j, (jnp.asarray(y),), {}, p))))
    pe_j, g_j = jvg({k: jnp.asarray(v) for k, v in z.items()})
    pe_t, g_t = util.batched_value_and_grad(
        partial(util.potential_energy, model_t, (torch.as_tensor(y),), {}))(
        {k: torch.as_tensor(v) for k, v in z.items()})
    assert (z["c"] > 0).any() and (z["c"] <= 0).any()
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=RTOL)
    for k in z:
        g = np.asarray(g_j[k])
        np.testing.assert_allclose(g_t[k].numpy(), g, rtol=RTOL, atol=RTOL * np.abs(g).max(),
                                   err_msg=k)


def test_deterministic_sites_through_cond():
    """A departure: the JAX package's ``cond`` fails on a deterministic site
    (its ``fn``, a new closure each call, must be the same in both branches);
    the port selects the site's value like any other."""
    y = torch.tensor([0.5, 2.5, -0.3])
    with pytest.raises(TypeError, match="same pytree structure"):
        jutil.initialize_model(random.PRNGKey(0), _nuts_model(J, True),
                               model_args=(jnp.asarray(y.numpy()),))
    info = util.initialize_model(torch.Generator().manual_seed(0), _nuts_model(T, True),
                                 num_chains=4, model_args=(y,))
    assert set(info.param_info.z) == {"c", "x", "s"}
    z = {"c": torch.tensor([-1.0, 1.0, -2.0, 0.5]), "x": torch.tensor([0.1, 0.2, 0.3, 0.4]),
         "s": torch.zeros(4)}
    out = torch.func.vmap(info.postprocess_fn)(z)
    np.testing.assert_allclose(out["d"].numpy(), [-0.9, 1.2, -0.7, 1.4], rtol=1e-6)
    np.testing.assert_allclose(out["s"].numpy(), np.ones(4), rtol=1e-6)


def test_a_python_predicate_runs_one_branch():
    ran = []

    def branch(tag):
        def fn(v):
            ran.append(tag)
            return npt.sample("x", dist.Normal(v, 1.0))
        return fn

    with handlers.trace() as tr, handlers.seed(rng_seed=0):
        cond(True, branch("true"), branch("false"), torch.tensor(3.0))
    assert ran == ["true"] and float(tr["x"]["fn"].loc) == 3.0
    assert cond(False, lambda v: v + 1, lambda v: v - 1, torch.tensor(3.0)).item() == 2.0


def test_a_tensor_predicate_outside_handlers_selects():
    out = cond(torch.tensor(False), lambda v: (v + 1, v * 2), lambda v: (v - 1, v * 3),
               torch.tensor([1.0, 2.0]))
    out_j = jcond(jnp.asarray(False), lambda v: (v + 1, v * 2), lambda v: (v - 1, v * 3),
                  jnp.array([1.0, 2.0]))
    for a, b in zip(out, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_enumeration_raises():
    for wrapper in (jcond_wrapper, cond_wrapper):
        with pytest.raises(RuntimeError, match="does not support enumeration"):
            wrapper(True, lambda v: v, lambda v: v, 0.0, enum=True)


def test_branches_with_different_sites_raise():
    def model():
        c = npt.sample("c", dist.Normal(0.0, 1.0))
        return cond(c > 0, lambda _: npt.sample("x", dist.Normal(0.0, 1.0)),
                    lambda _: npt.sample("z", dist.Normal(0.0, 1.0)), None)

    with pytest.raises(TypeError, match="identical structure"):
        handlers.seed(model, 0)()

    def other_class():
        c = npt.sample("c", dist.Normal(0.0, 1.0))
        return cond(c > 0, lambda _: npt.sample("x", dist.Normal(0.0, 1.0)),
                    lambda _: npt.sample("x", dist.Laplace(0.0, 1.0)), None)

    with pytest.raises(TypeError, match="identical structure"):
        handlers.seed(other_class, 0)()


def test_cond_under_a_plate_raises():
    def model():
        with npt.plate("N", 3):
            cond(True, lambda v: v, lambda v: v, 0.0)

    with pytest.raises(NotImplementedError, match="control flow"):
        handlers.seed(model, 0)()


def test_replay_through_cond_takes_the_recorded_latents():
    """A replayed trace reaches the branch's sites (the port's ``scan``
    replays the same way)."""
    tr = handlers.trace(handlers.seed(_cluster_model(T), 3)).get_trace()
    again = handlers.trace(handlers.seed(handlers.replay(_cluster_model(T), tr), 4)).get_trace()
    for name in ("cluster", "x"):
        assert float(again[name]["value"]) == float(tr[name]["value"])
