"""The model DSL's tail in the port against the JAX package: the handlers
``scale``, ``scope``, ``lift``, ``do`` and ``collapse``, ``plate_stack`` and
``sample(obs_mask=...)``.

The two packages draw different numbers from one seed, so traces are
compared by their names, dims and shapes, and densities at values made with
numpy.  Densities and potentials agree to rtol 1e-5 (float32 in both), the
gradients with an atol of 1e-5 times their largest entry.  ``collapse`` and
``obs_mask`` are also held against JAX under the port's chain-batched NUTS
potential (``torch.func.vmap``) at fixed unconstrained points.
"""

import warnings
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu as jnpt
import numpyro_tpu.distributions as jdist
import numpyro_tpu.handlers as jhandlers
from numpyro_tpu.infer import Predictive as JPredictive
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.infer import Predictive, util
from numpyro_tpu_torch.infer.autoguide import AutoNormal

torch.set_num_threads(1)

RTOL = 1e-5


def _f32(x):
    """Numbers as float32 arrays; boolean and integer arrays as they are."""
    x = np.asarray(x)
    return x if x.dtype.kind in "bi" else x.astype(np.float32)


J = SimpleNamespace(npt=jnpt, dist=jdist, h=jhandlers, t=lambda x: jnp.asarray(_f32(x)))
T = SimpleNamespace(npt=npt, dist=dist, h=handlers, t=lambda x: torch.as_tensor(_f32(x)))


def _ld(P, model, *args, params=None):
    """The log density of a seeded ``model`` and its trace."""
    if P is J:
        ld, tr = jutil.log_density(jhandlers.seed(model, random.PRNGKey(0)), args, {},
                                   params or {})
        return float(ld), tr
    ld, tr = util.log_density(handlers.seed(model, 0), args, {}, params or {})
    return float(ld), tr


def _same_ld(make, *args, params=None):
    """``make(P)`` of both packages gives one log density; returns it and
    the port's trace."""
    ld_j, _ = _ld(J, make(J), *[J.t(a) for a in args],
                  params={k: J.t(v) for k, v in (params or {}).items()})
    ld_t, tr_t = _ld(T, make(T), *[T.t(a) for a in args],
                     params={k: T.t(v) for k, v in (params or {}).items()})
    np.testing.assert_allclose(ld_t, ld_j, rtol=RTOL)
    return ld_t, tr_t


def _same_potential(make, z, *args):
    """The chain-batched potential and its gradient of ``make(P)`` at the
    unconstrained points ``z`` (numpy, a leading chain axis)."""
    model_j, model_t = make(J), make(T)
    jvg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: jutil.potential_energy(model_j, tuple(J.t(a) for a in args), {}, p))))
    pe_j, g_j = jvg({k: J.t(v) for k, v in z.items()})
    pe_t, g_t = util.batched_value_and_grad(
        partial(util.potential_energy, model_t, tuple(T.t(a) for a in args), {}))(
        {k: T.t(v) for k, v in z.items()})
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=RTOL)
    assert set(g_t) == set(g_j) == set(z)
    for k in g_j:
        g = np.asarray(g_j[k])
        np.testing.assert_allclose(g_t[k].numpy(), g, rtol=RTOL, atol=RTOL * np.abs(g).max(),
                                   err_msg=k)
    return pe_t


def _names(tr):
    return [k for k, s in tr.items() if s["type"] != "inspect"]


# ----------------------------------------------------------------- scale


@pytest.mark.parametrize("s", [0.5, 2.0, 10.0])
def test_scale_multiplies_the_log_density(s):
    def make(P):
        def model():
            with P.h.scale(scale=s):
                P.npt.sample("x", P.dist.Normal(0.0, 1.0), obs=P.t(1.0))
        return model

    ld, _ = _same_ld(make)
    np.testing.assert_allclose(ld, s * st.norm.logpdf(1.0), rtol=RTOL)


def test_scale_nests_and_compounds_with_a_subsampled_plate():
    def make(P):
        def model(x):
            with P.h.scale(scale=2.0), P.h.scale(scale=3.0):
                with P.npt.plate("N", 10, subsample_size=5):
                    batch = P.npt.subsample(x, event_dim=0)
                    P.npt.sample("x", P.dist.Normal(0.0, 1.0), obs=batch)
        return model

    x = np.arange(10.0)
    indices = np.array([1, 3, 5, 7, 9])
    ld_j, tr_j = _ld(J, jhandlers.substitute(make(J), data={"N": jnp.asarray(indices)}),
                     J.t(x))
    ld_t, tr_t = _ld(T, handlers.substitute(make(T), data={"N": torch.as_tensor(indices)}),
                     T.t(x))
    np.testing.assert_allclose(ld_t, ld_j, rtol=RTOL)
    assert tr_t["x"]["scale"] == tr_j["x"]["scale"] == 12.0
    # a plate message carries the scale too
    assert tr_t["N"]["scale"] == tr_j["N"]["scale"] == 6.0


def test_scale_with_a_tensor_multiplies_elementwise():
    s = np.array([0.5, 2.0, 4.0])

    def make(P):
        def model():
            with P.npt.plate("N", 3), P.h.scale(scale=P.t(s)):
                P.npt.sample("x", P.dist.Normal(0.0, 1.0), obs=P.t([0.3, -1.0, 2.0]))
        return model

    ld, _ = _same_ld(make)
    np.testing.assert_allclose(ld, (s * st.norm.logpdf([0.3, -1.0, 2.0])).sum(), rtol=RTOL)


@pytest.mark.parametrize("bad", [-1.0, 0.0, np.array([1.0, -2.0]), "cpu tensor"])
def test_scale_rejects_a_nonpositive_scale_it_can_read(bad):
    if isinstance(bad, str):
        bad_j, bad_t = jnp.array([1.0, -2.0]), torch.tensor([1.0, -2.0])
    else:
        bad_j = bad_t = bad
    with pytest.raises(ValueError, match="positive"):
        jhandlers.scale(scale=bad_j)
    with pytest.raises(ValueError, match="positive"):
        handlers.scale(scale=bad_t)


def test_scale_under_the_batched_nuts_potential():
    """A departure: the JAX package's ``scale`` checks a Python number with a
    ``jnp`` op, which ``jit`` stages, and then reads it with ``if``, so it
    raises inside a jitted potential; its potential without ``jit`` is the
    port's (which checks the number with numpy)."""
    def make(P):
        def model(y):
            mu = P.npt.sample("mu", P.dist.Normal(0.0, 2.0))
            with P.h.scale(scale=0.25), P.npt.plate("N", y.shape[0]):
                P.npt.sample("y", P.dist.Normal(mu, 1.0), obs=y)
        return model

    y = np.array([0.3, -1.0, 2.0], np.float32)
    z = {"mu": np.array([0.1, 0.4, -0.7], np.float32)}
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jax.jit(jax.vmap(lambda p: jutil.potential_energy(make(J), (J.t(y),), {}, p)))(
            {"mu": J.t(z["mu"])})
    pe_j = jax.vmap(lambda p: jutil.potential_energy(make(J), (J.t(y),), {}, p))(
        {"mu": J.t(z["mu"])})
    pe_t, _ = util.batched_value_and_grad(
        partial(util.potential_energy, make(T), (T.t(y),), {}))({"mu": T.t(z["mu"])})
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=RTOL)
    expected = -(st.norm.logpdf(z["mu"], 0, 2)
                 + 0.25 * st.norm.logpdf(y[None], z["mu"][:, None], 1).sum(1))
    np.testing.assert_allclose(pe_t.numpy(), expected, rtol=RTOL)


def test_scale_does_not_read_a_tensor_it_cannot_read():
    """A scale batched under ``vmap`` (JAX's tracer) is not read; nor is a
    tensor on another device than the CPU (a departure: on the card the read
    would be a host sync each time the model runs), shown here with a
    ``meta`` tensor, which has no value to read."""
    handlers.scale(scale=torch.tensor(-1.0, device="meta"))

    def scaled(s):
        return handlers.scale(scale=s).scale * 1.0

    out = torch.func.vmap(scaled)(torch.tensor([-1.0, 2.0]))
    np.testing.assert_array_equal(out.numpy(), [-1.0, 2.0])
    jax.vmap(lambda s: jhandlers.scale(scale=s).scale * 1.0)(jnp.array([-1.0, 2.0]))


# ----------------------------------------------------------------- scope


def _scoped_model(P):
    def model():
        mu = P.npt.sample("mu", P.dist.Normal(0.0, 1.0))
        with P.npt.plate("N", 3):
            P.npt.sample("x", P.dist.Normal(mu, 1.0))
        P.npt.param("w", P.t(0.5))
        P.npt.deterministic("d", mu * 2)
    return model


@pytest.mark.parametrize("kwargs", [
    dict(prefix="outer"),
    dict(prefix="outer", divider="."),
    dict(prefix="s", hide_types=["param"]),
    dict(prefix="s", hide_types=["plate", "deterministic"]),
])
def test_scope_renames_sites_and_plate_frames_as_jax(kwargs):
    tr_j = jhandlers.trace(jhandlers.scope(jhandlers.seed(_scoped_model(J), 0), **kwargs))
    tr_t = handlers.trace(handlers.scope(handlers.seed(_scoped_model(T), 0), **kwargs))
    tr_j, tr_t = tr_j.get_trace(), tr_t.get_trace()
    assert _names(tr_t) == _names(tr_j)
    for name in _names(tr_j):
        frames_j = [tuple(f) for f in tr_j[name].get("cond_indep_stack", [])]
        frames_t = [tuple(f) for f in tr_t[name].get("cond_indep_stack", [])]
        assert frames_t == frames_j, name


def test_scope_nested_prefixes_and_density():
    def make(P):
        def model():
            P.npt.sample("x", P.dist.Normal(0.0, 1.0), obs=P.t(0.7))
        return P.h.scope(P.h.scope(model, prefix="in"), prefix="out", divider=".")

    _, tr = _same_ld(make)
    assert _names(tr) == ["out.in/x"]


def test_scope_substitutes_by_the_scoped_name():
    def make(P):
        def model():
            return P.npt.sample("x", P.dist.Normal(0.0, 1.0))
        return P.h.substitute(P.h.scope(model, prefix="a"), data={"a/x": P.t(1.5)})

    ld, tr = _same_ld(make)
    assert float(tr["a/x"]["value"]) == 1.5
    np.testing.assert_allclose(ld, st.norm.logpdf(1.5), rtol=RTOL)


# ------------------------------------------------------------------ lift


def _lift_prior(P, kind):
    if kind == "dict":
        return {"a": P.dist.Normal(0.0, 2.0), "b": P.dist.Exponential(1.5)}
    if kind == "distribution":
        return P.dist.HalfNormal(3.0)
    return lambda name: P.dist.Gamma(2.0, 1.0) if name == "b" else None


@pytest.mark.parametrize("kind", ["dict", "distribution", "callable"])
def test_lift_turns_params_into_sample_sites(kind):
    def make(P):
        def model():
            a = P.npt.param("a", P.t(0.5))
            b = P.npt.param("b", P.t(1.0), constraint=P.dist.constraints.positive)
            P.npt.sample("y", P.dist.Normal(a, b), obs=P.t(0.3))
        return P.h.lift(model, prior=_lift_prior(P, kind))

    tr_j = jhandlers.trace(jhandlers.seed(make(J), 0)).get_trace()
    tr_t = handlers.trace(handlers.seed(make(T), 0)).get_trace()
    assert _names(tr_t) == _names(tr_j)
    assert {k: s["type"] for k, s in tr_t.items()} == {k: s["type"] for k, s in tr_j.items()}
    lifted = [k for k in ("a", "b") if tr_j[k]["type"] == "sample"]
    params = {k: 0.8 for k in lifted}
    _same_ld(make, params=params)


def test_lift_shares_one_draw_for_a_param_named_twice():
    def make(P):
        def model():
            return P.npt.param("a", P.t(1.0)), P.npt.param("a", P.t(1.0))
        return P.h.lift(model, prior={"a": P.dist.Normal(0.0, 1.0)})

    with handlers.seed(rng_seed=0):
        a1, a2 = make(T)()
    assert a1 is a2 and float(a1) != 1.0
    for P in (J, T):
        with pytest.raises(AssertionError, match="duplicated"):
            P.h.trace(P.h.seed(make(P), 0)).get_trace()


# -------------------------------------------------------------------- do


def _do_model(P):
    def model():
        a = P.npt.sample("a", P.dist.Normal(0.0, 1.0))
        b = P.npt.sample("b", P.dist.Normal(a * 10, 1.0))
        return a, b
    return model


def test_do_sends_the_intervention_downstream_and_records_the_draw():
    for P in (J, T):
        with P.h.trace() as tr, P.h.seed(rng_seed=0), P.h.do(data={"a": P.t(2.0)}):
            a, b = _do_model(P)()
        assert _names(tr) == ["a", "b"]
        assert float(tr["b"]["fn"].loc) == 20.0
        # the model goes on with the intervention; the trace keeps the draw
        assert float(a) == 2.0 and float(tr["a"]["value"]) != 2.0


def test_do_density_matches_jax():
    def make(P):
        return P.h.do(_do_model(P), data={"a": P.t(2.0)})

    ld, tr = _same_ld(make, params={"a": 0.3, "b": 19.0})
    np.testing.assert_allclose(ld, st.norm.logpdf(0.3) + st.norm.logpdf(19.0, 20.0), rtol=RTOL)


def test_a_trace_inside_do_sees_the_renamed_site():
    for P in (J, T):
        with P.h.do(data={"a": P.t(2.0)}):
            tr = P.h.trace(P.h.seed(_do_model(P), 0)).get_trace()
        assert _names(tr) == ["a", "a__CF", "b"]
        assert tr["a__CF"]["is_observed"] and float(tr["a__CF"]["value"]) == 2.0


def test_do_twice_warns_and_does_not_recurse():
    for P in (J, T):
        with pytest.warns(RuntimeWarning, match="multiple times"):
            with P.h.seed(rng_seed=0), P.h.do(data={"a": P.t(1.0)}), \
                    P.h.do(data={"a": P.t(2.0)}):
                _do_model(P)()


def test_do_leaves_other_sites_alone():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with handlers.trace() as tr, handlers.seed(rng_seed=0), \
                handlers.do(data={"c": torch.tensor(1.0)}):
            _do_model(T)()
    assert _names(tr) == ["a", "b"]


# -------------------------------------------------------------- collapse


def _collapse_case(kind):
    """(make, observed value, closed form) for each conjugacy rule."""
    if kind == "beta_bernoulli":
        def make(P):
            def model(x):
                with P.h.collapse():
                    p = P.npt.sample("p", P.dist.Beta(2.0, 3.0))
                    P.npt.sample("obs", P.dist.Bernoulli(p), obs=x)
            return model
        return make, 1.0, np.log(2 / 5)
    if kind == "beta_binomial":
        def make(P):
            def model(x):
                with P.h.collapse():
                    p = P.npt.sample("p", P.dist.Beta(2.0, 3.0))
                    P.npt.sample("obs", P.dist.Binomial(5, probs=p), obs=x)
            return model
        return make, 2.0, st.betabinom(5, 2.0, 3.0).logpmf(2)
    if kind == "gamma_poisson":
        def make(P):
            def model(x):
                with P.h.collapse():
                    lam = P.npt.sample("lam", P.dist.Gamma(3.0, 2.0))
                    P.npt.sample("obs", P.dist.Poisson(lam), obs=x)
            return model
        return make, 4.0, st.nbinom(3, 2 / 3).logpmf(4)
    if kind == "normal_normal":
        def make(P):
            def model(x):
                with P.h.collapse():
                    mu = P.npt.sample("mu", P.dist.Normal(1.0, 2.0))
                    P.npt.sample("obs", P.dist.Normal(mu, 1.5), obs=x)
            return model
        return make, 0.3, st.norm(1.0, np.sqrt(6.25)).logpdf(0.3)
    if kind == "dirichlet_categorical":
        def make(P):
            def model(x):
                with P.h.collapse():
                    p = P.npt.sample("p", P.dist.Dirichlet(P.t([1.0, 2.0, 3.0])))
                    P.npt.sample("obs", P.dist.Categorical(p), obs=x)
            return model
        return make, 2, np.log(0.5)
    if kind == "dirichlet_multinomial":
        def make(P):
            def model(x):
                with P.h.collapse():
                    p = P.npt.sample("p", P.dist.Dirichlet(P.t([1.0, 2.0, 3.0])))
                    P.npt.sample("obs", P.dist.Multinomial(4, probs=p), obs=x)
            return model
        counts = np.array([1.0, 1.0, 2.0])
        return make, counts, st.dirichlet_multinomial(np.array([1.0, 2.0, 3.0]), 4).logpmf(
            counts)
    if kind == "batched_elementwise":
        def make(P):
            def model(x):
                with P.h.collapse():
                    p = P.npt.sample("p", P.dist.Beta(P.t([2.0, 5.0]), P.t([3.0, 1.0]))
                                     .to_event(1))
                    P.npt.sample("obs", P.dist.Bernoulli(p).to_event(1), obs=x)
            return model
        return make, np.array([1.0, 0.0]), np.log(2 / 5) + np.log(1 / 6)
    raise KeyError(kind)


COLLAPSE_CASES = ["beta_bernoulli", "beta_binomial", "gamma_poisson", "normal_normal",
                  "dirichlet_categorical", "dirichlet_multinomial", "batched_elementwise"]


@pytest.mark.parametrize("kind", COLLAPSE_CASES)
def test_collapse_gives_the_compound_density(kind):
    make, x, expected = _collapse_case(kind)
    x_j = jnp.asarray(x)
    x_t = torch.as_tensor(x) if kind == "dirichlet_categorical" else T.t(x)
    ld_j, tr_j = _ld(J, make(J), x_j)
    ld_t, tr_t = _ld(T, make(T), x_t)
    np.testing.assert_allclose(ld_t, ld_j, rtol=RTOL)
    np.testing.assert_allclose(ld_t, expected, rtol=1e-4)
    assert _names(tr_t) == _names(tr_j) == ["obs"]
    assert type(tr_t["obs"]["fn"]).__name__ == type(tr_j["obs"]["fn"]).__name__


def test_collapse_raises_on_an_unused_prior():
    for P in (J, T):
        def model(P=P):
            with P.h.collapse():
                P.npt.sample("p", P.dist.Beta(2.0, 3.0))

        with pytest.raises(RuntimeError, match="never consumed"):
            _ld(P, model)


def test_collapse_raises_on_a_prior_taken_twice():
    for P in (J, T):
        def model(P=P):
            with P.h.collapse():
                p = P.npt.sample("p", P.dist.Beta(2.0, 3.0))
                P.npt.sample("o1", P.dist.Bernoulli(p), obs=P.t(1.0))
                P.npt.sample("o2", P.dist.Bernoulli(p), obs=P.t(0.0))

        with pytest.raises(NotImplementedError, match="more than one"):
            _ld(P, model)


def test_collapse_raises_without_a_conjugacy_rule():
    for P in (J, T):
        def model(P=P):
            with P.h.collapse():
                lam = P.npt.sample("lam", P.dist.Normal(3.0, 2.0))
                P.npt.sample("obs", P.dist.Poisson(lam), obs=P.t(2.0))

        with pytest.raises(NotImplementedError, match="no conjugacy rule"):
            _ld(P, model)


def test_collapse_misses_a_prior_broadcast_over_a_batch_as_jax():
    """A scalar prior given to a batch of three draws is padded, so neither
    package finds its placeholder (the three draws would need the joint
    compound), and both raise that it was never consumed."""
    for P in (J, T):
        def model(P=P):
            with P.h.collapse():
                mu = P.npt.sample("mu", P.dist.Normal(1.0, 2.0))
                P.npt.sample("obs", P.dist.Normal(mu, P.t([1.0, 1.5, 2.0])),
                             obs=P.t([0.1, 0.2, 0.3]))

        with pytest.raises(RuntimeError, match="never consumed"):
            _ld(P, model)


def _collapse_nuts_model(P):
    """A collapsed Normal-Normal site whose likelihood has a second, latent
    parameter ``sigma``, beside an ordinary latent ``logit``."""
    def model(y, x):
        logit = P.npt.sample("logit", P.dist.Normal(0.0, 2.0))
        sigma = P.npt.sample("sigma", P.dist.HalfNormal(1.0))
        with P.h.collapse():
            mu = P.npt.sample("mu", P.dist.Normal(0.5, 2.0))
            P.npt.sample("y", P.dist.Normal(mu, sigma), obs=y)
        with P.npt.plate("N", x.shape[0]):
            P.npt.sample("x", P.dist.Bernoulli(logits=logit), obs=x)
    return model


def test_collapse_under_the_batched_nuts_potential():
    rng = np.random.default_rng(3)
    x = (rng.uniform(size=20) < 0.7).astype(np.float32)
    z = {"logit": rng.normal(size=8).astype(np.float32),
         "sigma": rng.normal(size=8).astype(np.float32)}
    pe = _same_potential(_collapse_nuts_model, z, 1.3, x)
    sigma = np.exp(z["sigma"].astype(np.float64))
    expected = -(st.norm.logpdf(z["logit"], 0, 2) + st.halfnorm.logpdf(sigma) + z["sigma"]
                 + st.norm.logpdf(1.3, 0.5, np.sqrt(4 + sigma ** 2))
                 + (x[None] * -np.log1p(np.exp(-z["logit"][:, None]))
                    + (1 - x[None]) * -np.log1p(np.exp(z["logit"][:, None]))).sum(1))
    np.testing.assert_allclose(pe.numpy(), expected, rtol=1e-4)
    # the collapsed site is no latent of the model, in both packages
    info = util.initialize_model(torch.Generator().manual_seed(0), _collapse_nuts_model(T),
                                 num_chains=4, model_args=(T.t(1.3), T.t(x)))
    assert set(info.param_info.z) == {"logit", "sigma"}


# ------------------------------------------------------------ plate_stack


@pytest.mark.parametrize("sizes,rightmost_dim", [((2, 3), -1), ((4,), -2), ((2, 3, 4), -2)])
def test_plate_stack_dims_and_names_match_jax(sizes, rightmost_dim):
    def make(P):
        def model():
            with P.npt.plate_stack("p", sizes, rightmost_dim=rightmost_dim):
                P.npt.sample("x", P.dist.Normal(0.0, 1.0))
        return model

    tr_j = jhandlers.trace(jhandlers.seed(make(J), 0)).get_trace()
    tr_t = handlers.trace(handlers.seed(make(T), 0)).get_trace()
    assert _names(tr_t) == _names(tr_j)
    assert [tuple(f) for f in tr_t["x"]["cond_indep_stack"]] == \
        [tuple(f) for f in tr_j["x"]["cond_indep_stack"]]
    assert tuple(tr_t["x"]["value"].shape) == tuple(tr_j["x"]["value"].shape)
    assert {f.name: f.dim for f in tr_t["x"]["cond_indep_stack"]} == {
        f"p_{i}": rightmost_dim - len(sizes) + 1 + i for i in range(len(sizes))}


# ---------------------------------------------------------------- obs_mask


OBS = np.array([1.0, 2.0, 3.0, -1.0], np.float32)
MASK = np.array([True, False, True, False])


def _obs_mask_model(P, event=False):
    def model(y, mask):
        mu = P.npt.sample("mu", P.dist.Normal(0.0, 2.0))
        if event:
            with P.npt.plate("N", 2):
                return P.npt.sample("x", P.dist.Normal(mu, 1.5).expand([2]).to_event(1),
                                    obs=y.reshape(2, 2), obs_mask=mask[::2])
        with P.npt.plate("N", 4):
            return P.npt.sample("x", P.dist.Normal(mu, 1.5), obs=y, obs_mask=mask)
    return model


@pytest.mark.parametrize("event", [False, True])
def test_obs_mask_splits_the_site_as_jax(event):
    y_j, m_j = jnp.asarray(OBS), jnp.asarray(MASK)
    y_t, m_t = torch.as_tensor(OBS), torch.as_tensor(MASK)
    tr_j = jhandlers.trace(jhandlers.seed(_obs_mask_model(J, event), 0)).get_trace(y_j, m_j)
    tr_t = handlers.trace(handlers.seed(_obs_mask_model(T, event), 0)).get_trace(y_t, m_t)
    assert _names(tr_t) == _names(tr_j) == ["mu", "N", "x_unobserved", "x_observed", "x"]
    for name in ("x_unobserved", "x_observed", "x"):
        assert tuple(tr_t[name]["value"].shape) == tuple(tr_j[name]["value"].shape)
        assert tr_t[name]["type"] == tr_j[name]["type"]
    assert not tr_t["x_unobserved"]["is_observed"] and tr_t["x_observed"]["is_observed"]
    keep = MASK[::2] if event else MASK
    x = tr_t["x"]["value"].numpy()
    np.testing.assert_array_equal(x[keep], (OBS.reshape(2, 2) if event else OBS)[keep])
    np.testing.assert_array_equal(x[~keep], tr_t["x_unobserved"]["value"].numpy()[~keep])


@pytest.mark.parametrize("event", [False, True])
def test_obs_mask_under_the_batched_nuts_potential(event):
    rng = np.random.default_rng(5)
    shape = (2, 2) if event else (4,)
    z = {"mu": rng.normal(size=6).astype(np.float32),
         "x_unobserved": rng.normal(size=(6,) + shape).astype(np.float32)}
    pe = _same_potential(lambda P: _obs_mask_model(P, event), z, OBS, MASK)
    keep = np.broadcast_to(MASK[::2, None] if event else MASK, shape)
    merged = np.where(keep, OBS.reshape(shape), z["x_unobserved"])
    expected = -(st.norm.logpdf(z["mu"], 0, 2)
                 + st.norm.logpdf(merged, z["mu"].reshape((6,) + (1,) * len(shape)), 1.5)
                 .reshape(6, -1).sum(1))
    np.testing.assert_allclose(pe.numpy(), expected, rtol=1e-5)


def test_obs_mask_latent_is_seen_by_init_predictive_and_guides():
    y_t, m_t = torch.as_tensor(OBS), torch.as_tensor(MASK)
    y_j, m_j = jnp.asarray(OBS), jnp.asarray(MASK)
    info_t = util.initialize_model(torch.Generator().manual_seed(0), _obs_mask_model(T),
                                   num_chains=3, model_args=(y_t, m_t))
    info_j = jutil.initialize_model(random.PRNGKey(0), _obs_mask_model(J), model_args=(y_j, m_j))
    assert {k: tuple(v.shape[1:]) for k, v in info_t.param_info.z.items()} == {
        k: tuple(v.shape) for k, v in info_j.param_info.z.items()}
    draws = {"mu": np.array([0.5, -0.5], np.float32),
             "x_unobserved": np.array([[9.0, 8.0, 7.0, 6.0], [5.0, 4.0, 3.0, 2.0]], np.float32)}
    pred_t = Predictive(_obs_mask_model(T), {k: torch.as_tensor(v) for k, v in draws.items()},
                        return_sites=["x"], device="cpu")(0, y_t, m_t)["x"]
    pred_j = JPredictive(_obs_mask_model(J), {k: jnp.asarray(v) for k, v in draws.items()},
                         return_sites=["x"])(random.PRNGKey(0), y_j, m_j)["x"]
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    np.testing.assert_array_equal(pred_t.numpy()[:, ~MASK], draws["x_unobserved"][:, ~MASK])
    guide = AutoNormal(_obs_mask_model(T))
    with handlers.seed(rng_seed=0):
        tr = handlers.trace(guide).get_trace(y_t, m_t)
    assert tuple(tr["x_unobserved"]["value"].shape) == (4,)
