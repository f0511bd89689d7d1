"""The port's ``util`` helpers against the JAX package's ``numpyro_tpu.util``:
``format_shapes`` (the same text for the same model), ``fori_collect``
(thinning, ``lower``, ``collection_size`` and ``return_last_val`` on a
deterministic body: equal), ``enable_x64`` (a model's draws and log density
in float64 in both packages, the densities equal to rtol 1e-12, and float32
again after ``enable_x64(False)``), the GLM op's explicit float32 cast under
x64, which the JAX op makes too, ``set_rng_seed`` and the small helpers.
"""

import random as pyrandom
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu as jnpt
import numpyro_tpu.distributions as jdist
import numpyro_tpu.handlers as jhandlers
import numpyro_tpu.util as jutil
from numpyro_tpu.infer.util import log_density as jlog_density
from numpyro_tpu.ops import glm as jglm
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers, util
from numpyro_tpu_torch.infer.util import log_density
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)


def _jax_model(x):
    w = jnpt.sample("w", jdist.Normal(jnp.zeros(3), 1.0).to_event(1))
    with jnpt.plate("N", x.shape[0]):
        jnpt.sample("obs", jdist.Normal(x @ w, 1.0), obs=jnp.zeros(5))


def _torch_model(x):
    w = npt.sample("w", dist.Normal(torch.zeros(3), 1.0).to_event(1))
    with npt.plate("N", x.shape[0]):
        npt.sample("obs", dist.Normal(x @ w, 1.0), obs=torch.zeros(5))


def _jax_nested():
    p = jnpt.param("p", jnp.ones((2, 3)))
    s = jnpt.param("s", jnp.ones(()))
    with jnpt.plate("outer", 4, dim=-2):
        with jnpt.plate("inner", 3):
            jnpt.sample("x", jdist.Normal(p.sum(0), s))
    jnpt.sample("y", jdist.Dirichlet(jnp.ones(5)))


def _torch_nested():
    p = npt.param("p", torch.ones((2, 3)))
    s = npt.param("s", torch.ones(()))
    with npt.plate("outer", 4, dim=-2):
        with npt.plate("inner", 3):
            npt.sample("x", dist.Normal(p.sum(0), s))
    npt.sample("y", dist.Dirichlet(torch.ones(5)))


@pytest.fixture(scope="module")
def traces():
    jx, tx = jnp.ones((5, 3)), torch.ones((5, 3))
    return {
        "test_util": (
            jhandlers.trace(jhandlers.seed(_jax_model, random.PRNGKey(0))).get_trace(jx),
            handlers.trace(handlers.seed(_torch_model, 0)).get_trace(tx),
        ),
        "nested": (
            jhandlers.trace(jhandlers.seed(_jax_nested, random.PRNGKey(0))).get_trace(),
            handlers.trace(handlers.seed(_torch_nested, 0)).get_trace(),
        ),
    }


@pytest.mark.parametrize("options", [
    {}, {"compute_log_prob": True}, {"compute_log_prob": lambda name, site: name == "x"},
    {"title": "Shapes:", "last_site": "inner"}, {"last_site": "p"},
])
@pytest.mark.parametrize("which", ["test_util", "nested"])
def test_format_shapes_gives_jax_s_text(traces, which, options):
    jtr, ttr = traces[which]
    want = jutil.format_shapes(jtr, **options)
    got = util.format_shapes(ttr, **options)
    assert got == want
    assert "Trace Shapes:" in got or "Shapes:" in got


def test_format_shapes_of_an_empty_trace_is_the_title():
    assert util.format_shapes({}) == jutil.format_shapes({}) == "Trace Shapes:"


def _body_jax(state):
    return {"a": state["a"] + 1.0, "b": state["b"] * 1.5}


def _body_torch(state):
    return {"a": state["a"] + 1.0, "b": state["b"] * 1.5}


@pytest.mark.parametrize("lower, upper, thinning, collection_size", [
    (0, 10, 1, None), (3, 13, 3, None), (4, 9, 2, None), (2, 8, 1, 9), (5, 5, 1, None),
])
@pytest.mark.parametrize("return_last_val", [False, True])
def test_fori_collect_matches_jax(lower, upper, thinning, collection_size, return_last_val):
    j0 = {"a": jnp.zeros(2), "b": jnp.ones(())}
    t0 = {"a": torch.zeros(2), "b": torch.ones(())}
    kw = dict(progbar=False, thinning=thinning, collection_size=collection_size,
              return_last_val=return_last_val)
    want = jutil.fori_collect(lower, upper, _body_jax, j0, **kw)
    got = util.fori_collect(lower, upper, _body_torch, t0, **kw)
    if return_last_val:
        (want, want_last), (got, got_last) = want, got
        for k in ("a", "b"):
            np.testing.assert_array_equal(got_last[k].numpy(), np.asarray(want_last[k]))
    for k in ("a", "b"):
        assert tuple(got[k].shape) == np.shape(want[k])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_fori_collect_transform_and_body_args_match_jax():
    def jbody(x, step):
        return x + step

    def tbody(x, step):
        return x + step

    want = jutil.fori_collect(2, 12, jbody, jnp.zeros(3), transform=lambda x: x.sum(),
                              progbar=False, thinning=2, body_args=(jnp.asarray(0.5),))
    got = util.fori_collect(2, 12, tbody, torch.zeros(3), transform=lambda x: x.sum(),
                            progbar=False, thinning=2, body_args=(torch.tensor(0.5),))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fori_collect_with_a_progress_bar_collects_the_same(monkeypatch):
    plain = util.fori_collect(1, 7, lambda x: x * 2, torch.ones(()), progbar=False)
    monkeypatch.setitem(__import__("sys").modules, "tqdm", None)
    monkeypatch.setitem(__import__("sys").modules, "tqdm.auto", None)
    barless = util.fori_collect(1, 7, lambda x: x * 2, torch.ones(()), progbar=True,
                                progbar_desc=lambda i: f"step {i}")
    torch.testing.assert_close(barless, plain)


def _jax_x64_model(y):
    mu = jnpt.sample("mu", jdist.Normal(0.0, 2.0))
    sigma = jnpt.sample("sigma", jdist.HalfNormal(1.0))
    with jnpt.plate("N", y.shape[0]):
        jnpt.sample("y", jdist.Normal(mu, sigma), obs=y)


def _torch_x64_model(y):
    mu = npt.sample("mu", dist.Normal(0.0, 2.0))
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    with npt.plate("N", y.shape[0]):
        npt.sample("y", dist.Normal(mu, sigma), obs=y)


def test_enable_x64_gives_float64_draws_and_densities_in_both_packages():
    y = np.random.default_rng(0).normal(1.0, 0.5, 20)
    params = {"mu": np.float64(0.7), "sigma": np.float64(0.45)}
    was_x64 = jax.config.jax_enable_x64
    was_dtype = torch.get_default_dtype()
    try:
        jutil.enable_x64()
        util.enable_x64()
        assert torch.get_default_dtype() == torch.float64
        jtr = jhandlers.trace(jhandlers.seed(_jax_x64_model, random.PRNGKey(0))).get_trace(
            jnp.asarray(y))
        ttr = handlers.trace(handlers.seed(_torch_x64_model, 0)).get_trace(torch.tensor(y))
        for name in ("mu", "sigma"):
            assert jtr[name]["value"].dtype == jnp.float64
            assert ttr[name]["value"].dtype == torch.float64
        want, _ = jlog_density(_jax_x64_model, (jnp.asarray(y),), {},
                               {k: jnp.asarray(v) for k, v in params.items()})
        got, _ = log_density(_torch_x64_model, (torch.tensor(y),), {},
                             {k: torch.tensor(v) for k, v in params.items()})
        assert want.dtype == jnp.float64 and got.dtype == torch.float64
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
        util.enable_x64(False)
        assert torch.get_default_dtype() == torch.float32
        t32 = handlers.trace(handlers.seed(_torch_x64_model, 0)).get_trace(
            torch.tensor(y, dtype=torch.float32))
        assert t32["mu"]["value"].dtype == torch.float32
    finally:
        jax.config.update("jax_enable_x64", was_x64)
        torch.set_default_dtype(was_dtype)


def test_the_glm_op_casts_a_float64_w_to_float32_as_jax_does():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((300, 6)).astype(np.float32)
    yv = (rng.random(300) < 0.5).astype(np.float32)
    w = rng.standard_normal((4, 6))
    was_x64 = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", True)
        jdata = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(yv), dtype=jnp.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            want = jax.vmap(jglm.bernoulli_logits_loglik, (0, None))(jnp.asarray(w), jdata)
    finally:
        jax.config.update("jax_enable_x64", was_x64)
    data = glm.prepare_glm_data(torch.tensor(X), torch.tensor(yv), dtype=torch.float32)
    w64 = torch.tensor(w, requires_grad=True)
    got = glm.bernoulli_logits_loglik(w64, data)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # both compute at w cast to float32; the JAX op sums the padded columns'
    # log 2 in float32 (ROADMAP.md, "Departures"), so each is held to a
    # float64 reference at its own precision
    logits = w.astype(np.float32).astype(np.float64) @ X.astype(np.float64).T
    ref = (yv * logits - np.logaddexp(0.0, logits)).sum(1)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(want), ref, rtol=1e-4)
    torch.testing.assert_close(got, glm.bernoulli_logits_loglik(w64.float(), data))
    got.sum().backward()
    assert w64.grad.dtype == torch.float64 and torch.isfinite(w64.grad).all()


def test_set_rng_seed_seeds_python_and_numpy_as_jax_does():
    jutil.set_rng_seed(3)
    want = (pyrandom.random(), np.random.rand(3))
    util.set_rng_seed(3)
    got = (pyrandom.random(), np.random.rand(3))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_small_helpers_match_jax():
    state = {"adapt_state": {"step_size": 0.5}, "i": 3}
    for fields in (("adapt_state.step_size",), ("i", "adapt_state.step_size")):
        assert util.nested_attrgetter(*fields)(state) == jutil.nested_attrgetter(*fields)(state)
    with util.optional(False, pytest.raises(ValueError)):
        pass
    with util.optional(True, pytest.raises(ValueError)):
        raise ValueError
    assert util.find_stack_level() >= 0


def test_check_model_guide_match_warns_of_guide_only_sites_as_jax_s_util():
    def trace_of(names):
        return {n: {"type": "sample", "is_observed": False, "value": np.zeros(()), "fn": None}
                for n in names}

    for model, guide, warns in ((["a"], ["a", "aux"], True), (["a", "b"], ["a"], False)):
        for check in (jutil.check_model_guide_match, util.check_model_guide_match):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                check(trace_of(model), trace_of(guide))
            assert bool([w for w in caught if "auxiliary" in str(w.message)]) == warns
