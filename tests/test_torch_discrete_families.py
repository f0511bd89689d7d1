"""The port's discrete families against the JAX package's, on the same numpy
inputs: ``log_prob``, ``mean``, ``variance``, ``cdf``, ``icdf``, ``entropy``
and ``enumerate_support`` wherever the JAX class has them (a raise wherever
it has not), the probs/logits twins, ``sample`` on JAX's own draws (through
the draw source ``tests/torch_draws.py``) wherever the class draws through a
kind the source can replay, the port's own draws against the analytic
moments (4 standard errors) and the pmf (``gof.multinomial_goodness_of_fit``,
the port's copy), also under ``soft_vmap``; the samplers ``binomial`` and
``multinomial`` at their edges; enumeration of a ``Binomial`` and a
``DiscreteUniform`` site under ``TraceEnum_ELBO`` and in the enumerated NUTS
potential.

Parameters are the JAX package's own cases
(``tests/test_distributions.py::SCIPY_CASES``,
``tests/test_distributions_sweep.py::SPECS``), each widened to a batch of 3.
Tolerances: rtol 1e-5 and atol 1e-6 on float32 values unless a case says
why not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.contrib.enum as jenum
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.gof import (lumped_goodness_of_fit,
                                                 multinomial_goodness_of_fit)
from numpyro_tpu_torch.distributions.util import binomial, multinomial
from numpyro_tpu_torch.infer import TraceEnum_ELBO
from numpyro_tpu_torch.infer import util
from numpyro_tpu_torch.util import soft_vmap

from torch_draws import FedDraws

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TEST_FAILURE_RATE = 5e-3


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t),
                               np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


def _whole(kind):
    """JAX's own draws of the class, handed over whole."""
    def draws(key, sample_shape, d):
        return [(kind, d.sample(key, sample_shape))]
    return draws


def _uniforms(key, sample_shape, d):
    return [("uniforms", random.uniform(key, sample_shape + d.batch_shape))]


def _multinomial_uniforms(key, sample_shape, d):
    n_max = int(np.max(np.asarray(d.total_count)))
    shape = (n_max,) + sample_shape + d.batch_shape + (1,)
    return [("uniforms", random.uniform(key, shape))]


def _gamma_poisson(conc, rate):
    def draws(key, sample_shape, d):
        k_mix, k_obs = random.split(key)
        c, r = conc(d), rate(d)
        shape = sample_shape + d.batch_shape
        lam = jdist.Gamma(c, r).sample(k_mix, sample_shape)
        return [("gammas", random.gamma(k_mix, jnp.broadcast_to(c, shape), shape)),
                ("poissons", random.poisson(k_obs, lam))]
    return draws


def _zero_inflated(key, sample_shape, d):
    k_gate, k_obs = random.split(key)
    shape = sample_shape + d.batch_shape
    base = d.base_dist if hasattr(d, "base_dist") else jdist.Poisson(d.rate)
    return [("uniforms", random.uniform(k_gate, shape)),
            ("poissons", base.expand(d.batch_shape).sample(k_obs, sample_shape))]


# name -> (constructor, numpy params, draws fed to sample or None)
BATCH = 3
CASES = {
    "BinomialProbs": ("BinomialProbs", dict(probs=0.4, total_count=10.0), _whole("binomials")),
    "BinomialLogits": ("BinomialLogits", dict(logits=0.4, total_count=7.0), _whole("binomials")),
    "DiscreteUniform": ("DiscreteUniform", dict(low=0.0, high=5.0), None),
    "MultinomialProbs": ("MultinomialProbs", dict(probs=[0.2, 0.3, 0.5], total_count=6.0),
                         _multinomial_uniforms),
    "MultinomialLogits": ("MultinomialLogits", dict(logits=[0.2, -0.1, 0.4], total_count=6.0),
                          _multinomial_uniforms),
    "Poisson": ("Poisson", dict(rate=3.5), _whole("poissons")),
    "GeometricProbs": ("GeometricProbs", dict(probs=0.3), _uniforms),
    "GeometricLogits": ("GeometricLogits", dict(logits=-1.1), _uniforms),
    "OrderedLogistic": ("OrderedLogistic", dict(predictor=0.5, cutpoints=[-1.0, 1.0]), None),
    "NegativeBinomial2": ("NegativeBinomial2", dict(mean=3.0, concentration=2.0),
                          _gamma_poisson(lambda d: d.concentration,
                                         lambda d: d.concentration / d._mu)),
    "ZeroInflatedPoisson": ("ZeroInflatedPoisson", dict(gate=0.3, rate=2.0), _zero_inflated),
    "ZeroInflatedProbs": ("ZeroInflatedProbs", dict(gate=0.3, base_rate=2.0), _zero_inflated),
    "ZeroInflatedLogits": ("ZeroInflatedLogits", dict(gate_logits=-0.8, base_rate=2.0),
                           _zero_inflated),
}


def _widen(name, params, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, np.float32)
        if k in ("total_count", "low", "high") or v.ndim:
            out[k] = np.broadcast_to(v, (BATCH,) + v.shape).copy()
        elif k in ("logits", "gate_logits", "predictor"):
            out[k] = (v + rng.uniform(-0.5, 0.5, BATCH)).astype(np.float32)
        else:
            out[k] = (v * (1.0 + 0.3 * rng.uniform(-1.0, 1.0, BATCH))).astype(np.float32)
    if name == "DiscreteUniform":
        out["high"] = out["high"] + np.array([0.0, 1.0, 2.0], np.float32)
    return out


def _build(pkg, name, params):
    cls_name = CASES[name][0]
    mod, arr = (jdist, jnp.asarray) if pkg == "jax" else (dist, _t)
    kw = {k: arr(v) for k, v in params.items()}
    if "base_rate" in kw:
        kw = {k: v for k, v in kw.items() if k != "base_rate"}
        return getattr(mod, cls_name)(mod.Poisson(arr(params["base_rate"])), **kw)
    if name == "DiscreteUniform":
        # the JAX class keeps integer bounds
        kw = {k: jnp.asarray(v, jnp.int32) if pkg == "jax" else v for k, v in kw.items()}
    return getattr(mod, cls_name)(**kw)


def _make(name, seed=0):
    params = _widen(name, CASES[name][1], seed)
    return _build("jax", name, params), _build("torch", name, params), params


def _values(d_j, n=4, seed=7):
    return np.asarray(d_j.sample(random.PRNGKey(seed), (n,)))


def _method(d, attr, *args):
    out = getattr(d, attr)
    return out(*args) if callable(out) else out


@pytest.mark.parametrize("name", list(CASES))
def test_methods_match_jax(name):
    d_j, d_t, _ = _make(name)
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape
    x = _values(d_j)
    # counts as integers and as floats
    _close(d_t.log_prob(torch.from_numpy(x.astype(np.int64))), d_j.log_prob(x), what="log_prob")
    _close(d_t.log_prob(_t(x)), d_j.log_prob(x), what="log_prob of float counts")
    q = np.random.default_rng(1).uniform(0.05, 0.95, (4, BATCH)).astype(np.float32)
    for attr, args in (("mean", ()), ("variance", ()), ("entropy", ()), ("cdf", (x,)),
                       ("icdf", (q,))):
        try:
            want = np.asarray(_method(d_j, attr, *args))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                _method(d_t, attr, *(_t(a) for a in args))
            continue
        _close(_method(d_t, attr, *(_t(a) for a in args)), want, what=attr)
    assert d_t.has_enumerate_support == d_j.has_enumerate_support
    if d_j.has_enumerate_support:
        for expand in (False, True):
            try:
                want = np.asarray(d_j.enumerate_support(expand))
            except NotImplementedError:  # an uneven bound has no one support
                with pytest.raises(NotImplementedError, match="Inhomogeneous"):
                    d_t.enumerate_support(expand)
                continue
            np.testing.assert_array_equal(d_t.enumerate_support(expand).numpy(), want)
    assert d_t.support.is_discrete and bool(d_t.support(torch.from_numpy(x)).all())
    assert set(d_t.arg_constraints) == set(d_j.arg_constraints)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][2] is not None])
def test_sample_on_jax_draws_equals_jax(name):
    d_j, d_t, _ = _make(name)
    key = random.PRNGKey(11)
    want = np.asarray(d_j.sample(key, (5,)))
    source = FedDraws(CASES[name][2](key, (5,), d_j))
    got = d_t.sample(source, (5,))
    assert not source.items and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _moments_hold(x, mean, var):
    """The sample mean within 4 standard errors of ``mean``, and the sample
    variance within 4 of ``var``."""
    x, mean, var = x.double(), mean.double(), var.double()
    n = x.shape[0]
    se = torch.sqrt(var / n)
    assert ((x.mean(0) - mean).abs() <= 4 * se).all(), (x.mean(0), mean)
    se_var = torch.sqrt(((x - x.mean(0)) ** 4).mean(0) / n)
    assert ((x.var(0) - var).abs() <= 4 * se_var).all(), (x.var(0), var)


def _pmf_fit(d_t, draws):
    """The smallest p-value of each batch element's counts against its pmf,
    over the values up to the largest draw and one tail cell."""
    pvalues = []
    for b in range(draws.shape[1]):
        s = draws[:, b].numpy().astype(np.int64)
        hi = int(s.max()) + 1
        support = torch.arange(hi, dtype=torch.float32).reshape(-1, *(1,) * len(d_t.batch_shape))
        pmf = d_t.log_prob(support).exp().double().numpy()[:, b]
        pmf = np.append(pmf, max(1.0 - pmf.sum(), 0.0))
        counts = np.bincount(s, minlength=hi + 1)
        pvalues.append(lumped_goodness_of_fit(pmf, counts))
    return min(pvalues)


UNIVARIATE = [n for n in CASES if not n.startswith("Multinomial")]


@pytest.mark.parametrize("name", UNIVARIATE)
def test_own_draws_match_the_moments_and_the_pmf(name):
    _, d_t, _ = _make(name)
    x = d_t.sample(torch.Generator().manual_seed(5), (20_000,))
    assert x.dtype == torch.int64 and x.shape == (20_000, BATCH)
    if name != "OrderedLogistic":
        _moments_hold(x, d_t.mean, d_t.variance)
    assert _pmf_fit(d_t, x) > TEST_FAILURE_RATE


@pytest.mark.parametrize("name", list(CASES))
def test_draws_under_soft_vmap_differ_and_match_the_moments(name):
    """Each mapped element draws its own value from the shared generator,
    and the draws keep their moments (OrderedLogistic has none: its draws
    are held to its pmf)."""
    _, d_t, _ = _make(name)
    gen = torch.Generator().manual_seed(6)
    x = soft_vmap(lambda _: d_t.sample(gen), torch.arange(8000), chunk_size=4000)
    assert x.shape == (8000,) + d_t.batch_shape + d_t.event_shape
    assert len(torch.unique(x.reshape(8000, -1), dim=0)) > 8
    if name == "OrderedLogistic":
        assert _pmf_fit(d_t, x) > TEST_FAILURE_RATE
    else:
        _moments_hold(x, d_t.mean.expand(x.shape[1:]), d_t.variance.expand(x.shape[1:]))


def test_multinomial_compositions_follow_the_pmf():
    """Every composition of 6 into 3 cells is a category of the pmf test."""
    from itertools import combinations_with_replacement

    probs = torch.tensor([0.2, 0.3, 0.5])
    for d in (dist.Multinomial(6, probs), dist.Multinomial(6, logits=torch.log(probs)),
              dist.Multinomial(6, probs, total_count_max=9)):
        comps = sorted({tuple(np.bincount(list(c), minlength=3))
                        for c in combinations_with_replacement(range(3), 6)})
        pmf = d.log_prob(torch.tensor(comps, dtype=torch.float32)).exp().double().numpy()
        lookup = {c: i for i, c in enumerate(comps)}
        s = d.sample(torch.Generator().manual_seed(13), (20_000,))
        assert s.dtype == torch.int64 and bool((s.sum(-1) == 6).all())
        counts = np.zeros(len(comps), np.int64)
        for row in s.numpy():
            counts[lookup[tuple(int(v) for v in row)]] += 1
        assert multinomial_goodness_of_fit(pmf / pmf.sum(), counts,
                                           total_count=20_000) > TEST_FAILURE_RATE


def test_twins_and_factories_match_jax():
    x = np.array([0.0, 2.0, 5.0, 7.0], np.float32)
    pairs = [
        (dist.Binomial(7, probs=_t(0.35)), jdist.Binomial(7, probs=0.35)),
        (dist.Binomial(7, logits=_t(0.4)), jdist.Binomial(7, logits=0.4)),
        (dist.Geometric(probs=_t(0.25)), jdist.Geometric(probs=0.25)),
        (dist.Geometric(logits=_t(-1.1)), jdist.Geometric(logits=-1.1)),
        (dist.ZeroInflatedDistribution(dist.Poisson(_t(2.0)), gate=_t(0.3)),
         jdist.ZeroInflatedDistribution(jdist.Poisson(2.0), gate=0.3)),
        (dist.ZeroInflatedDistribution(dist.Poisson(_t(2.0)), gate_logits=_t(-0.8)),
         jdist.ZeroInflatedDistribution(jdist.Poisson(2.0), gate_logits=-0.8)),
        (dist.ZeroInflatedNegativeBinomial2(_t(3.0), _t(2.0), gate=_t(0.2)),
         jdist.ZeroInflatedNegativeBinomial2(3.0, 2.0, gate=0.2)),
    ]
    for d_t, d_j in pairs:
        assert type(d_t).__name__ == type(d_j).__name__
        _close(d_t.log_prob(_t(x)), d_j.log_prob(x), what=type(d_t).__name__)
        _close(d_t.mean, d_j.mean)
        _close(d_t.variance, d_j.variance)
    # the lazily derived twin parameter
    _close(dist.Binomial(7, probs=_t(0.35)).logits, jdist.Binomial(7, probs=0.35).logits)
    _close(dist.Geometric(logits=_t(-1.1)).probs, jdist.Geometric(logits=-1.1).probs)
    _close(dist.Multinomial(6, logits=_t([0.2, -0.1, 0.4])).probs,
           jdist.Multinomial(6, logits=jnp.array([0.2, -0.1, 0.4])).probs)
    for factory in (dist.Binomial, dist.Geometric, dist.Multinomial):
        with pytest.raises(ValueError):
            factory()
    with pytest.raises(ValueError):
        dist.ZeroInflatedDistribution(dist.Poisson(2.0))
    assert dist.Poisson(_t(2.0), is_sparse=True).is_sparse
    _close(dist.Poisson(_t(2.0), is_sparse=True).log_prob(_t(x)),
           jdist.Poisson(2.0, is_sparse=True).log_prob(x))
    # a probability of 1 at 0 failures (the guarded corner)
    _close(dist.Geometric(probs=_t([1.0, 0.5])).log_prob(_t([0.0, 0.0])),
           jdist.Geometric(probs=jnp.array([1.0, 0.5])).log_prob(jnp.zeros(2)))
    assert dist.OrderedLogistic.infer_shapes((4,), (2,)) == jdist.OrderedLogistic.infer_shapes(
        (4,), (2,))
    with pytest.raises(NotImplementedError, match="Poisson.infer_shapes"):
        dist.Poisson.infer_shapes((3,))


def test_constraints_of_the_slice_match_jax():
    from numpyro_tpu.distributions import constraints as jc

    x = np.array([-1.0, 0.0, 1.0, 2.5, 3.0], np.float32)
    for c_t, c_j in ((constraints.nonnegative_integer, jc.nonnegative_integer),
                     (constraints.positive_integer, jc.positive_integer),
                     (constraints.integer_greater_than(2), jc.integer_greater_than(2)),
                     (constraints.circular, jc.circular)):
        np.testing.assert_array_equal(c_t(_t(x)).numpy(), np.asarray(c_j(x)))
        np.testing.assert_array_equal(c_t.feasible_like(_t(x)).numpy(),
                                      np.asarray(c_j.feasible_like(x)))
        assert c_t.is_discrete == c_j.is_discrete
    v = np.array([[0.0, 2.0, 4.0], [3.0, 3.0, 0.0], [1.0, -1.0, 6.0]], np.float32)
    for c_t, c_j in ((constraints.multinomial(6), jc.multinomial(6)),
                     (constraints.ordered_vector, jc.ordered_vector),
                     (constraints.l1_ball, jc.l1_ball), (constraints.sphere, jc.sphere)):
        for arr in (v, v / np.abs(v).sum(-1, keepdims=True),
                    v / np.linalg.norm(v, axis=-1, keepdims=True)):
            np.testing.assert_array_equal(c_t(_t(arr)).numpy(), np.asarray(c_j(arr)))
        np.testing.assert_array_equal(c_t.feasible_like(_t(v)).numpy(),
                                      np.asarray(c_j.feasible_like(v)))
        assert c_t.event_dim == c_j.event_dim == 1
    dep = constraints.dependent(is_discrete=True, event_dim=0)
    assert dep.is_discrete and dep.event_dim == 0
    with pytest.raises(ValueError):
        dep(_t(x))
    # biject_to(circular) is the JAX package's map onto (-pi, pi)
    u = np.linspace(-4, 4, 9).astype(np.float32)
    y_t = dist.biject_to(constraints.circular)(_t(u))
    _close(y_t, jdist.biject_to(jc.circular)(u))
    _close(dist.biject_to(constraints.circular).inv(y_t), u, rtol=1e-4, atol=1e-4)
    # the ordered_vector and l1_ball rows are the JAX package's maps, and
    # sphere has no row there or here: it raises with the JAX package's message
    for c_t, c_j in ((constraints.ordered_vector, jc.ordered_vector),
                     (constraints.l1_ball, jc.l1_ball)):
        t, t_j = dist.biject_to(c_t), jdist.biject_to(c_j)
        assert type(t).__name__ == type(t_j).__name__
        x = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
        _close(t(_t(x)), t_j(x))
        _close(t.log_abs_det_jacobian(_t(x), t(_t(x))), t_j.log_abs_det_jacobian(x, t_j(x)),
               rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="^Cannot transform _Sphere constraint$"):
        dist.biject_to(constraints.sphere)
    with pytest.raises(NotImplementedError, match="^Cannot transform _Sphere constraint$"):
        jdist.biject_to(jc.sphere)


# ---------------------------------------------------------------------------
# the samplers at their edges


def test_binomial_edges_match_jax():
    """A NaN probability and a count of 0 give 0, a probability of 0 gives 0
    and one of 1 the count (the mirror about 0.5), as JAX's sampler gives."""
    p = np.array([np.nan, 0.3, 0.0, 1.0, 0.7, 1.0], np.float32)
    n = np.array([5.0, 0.0, 9.0, 9.0, -2.0, 0.0], np.float32)
    want = np.asarray(jdist.util.binomial(random.PRNGKey(0), jnp.asarray(p), jnp.asarray(n)))
    got = binomial(torch.Generator().manual_seed(0), _t(p), _t(n))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,p", [(12.0, 0.2), (100.0, 0.3), (60.0, 0.999), (40.0, 0.85),
                                 (1000.0, 1e-4), (30.0, 0.5)])
def test_binomial_draws_on_both_sides_of_the_switch(n, p):
    """``n min(p, 1 - p)`` from 0.1 to 30: the draws follow the pmf, and
    their moments, as JAX's BTRS and inversion paths draw them."""
    d = dist.Binomial(n, probs=_t(p))
    x = binomial(torch.Generator().manual_seed(9), _t(p), _t(n), (20_000,))
    assert x.dtype == torch.float32
    _moments_hold(x, d.mean, d.variance)
    j = jdist.util.binomial(random.PRNGKey(9), jnp.float32(p), jnp.float32(n), (20_000,))
    # both packages' draws against the same analytic moments
    _moments_hold(torch.from_numpy(np.asarray(j)), d.mean, d.variance)
    values = np.arange(int(n) + 1, dtype=np.float32)
    pmf = d.log_prob(_t(values)).exp().double().numpy()
    counts = np.bincount(x.numpy().astype(np.int64), minlength=len(values))
    assert lumped_goodness_of_fit(pmf, counts) > TEST_FAILURE_RATE


def test_multinomial_sampler_bounds_and_vmap():
    probs = torch.tensor([0.2, 0.3, 0.5])
    gen = torch.Generator().manual_seed(0)
    counts = torch.tensor([4.0, 0.0, 6.0])
    x = multinomial(gen, probs, counts, (3,))
    np.testing.assert_array_equal(x.sum(-1).numpy(), [4, 0, 6])
    y = multinomial(gen, probs, counts, (3,), total_count_max=8)
    np.testing.assert_array_equal(y.sum(-1).numpy(), [4, 0, 6])
    assert multinomial(gen, probs, torch.tensor(0.0), (2,)).sum() == 0
    # a total count batched under vmap cannot be read on the host
    with pytest.raises(ValueError, match="total_count_max is required"):
        torch.func.vmap(lambda n: multinomial(gen, probs, n), randomness="different")(counts)
    z = torch.func.vmap(lambda n: multinomial(gen, probs, n, total_count_max=6),
                        randomness="different")(counts)
    np.testing.assert_array_equal(z.sum(-1).numpy(), [4, 0, 6])
    with pytest.raises(ValueError, match="total_count_max is required"):
        jax.vmap(lambda n: jdist.util.multinomial(random.PRNGKey(0), jnp.asarray(probs.numpy()),
                                                  n))(jnp.asarray(counts.numpy()))


# ---------------------------------------------------------------------------
# enumeration


def _binomial_model(pkg, ys):
    sample, plate, param, d = (
        (numpyro_tpu.sample, numpyro_tpu.plate, numpyro_tpu.param, jdist) if pkg == "jax"
        else (npt.sample, npt.plate, npt.param, dist))
    logit = param("logit", 0.0)
    loc = param("loc", 0.5)
    with plate("N", ys.shape[0]):
        k = sample("k", d.Binomial(4, logits=logit), infer={"enumerate": "parallel"})
        sample("y", d.Normal(loc * k, 1.0), obs=ys)


def _uniform_model(pkg, ys):
    sample, plate, param, d = (
        (numpyro_tpu.sample, numpyro_tpu.plate, numpyro_tpu.param, jdist) if pkg == "jax"
        else (npt.sample, npt.plate, npt.param, dist))
    loc = param("loc", 0.5)
    with plate("N", ys.shape[0]):
        k = sample("k", d.DiscreteUniform(1, 4), infer={"enumerate": "parallel"})
        sample("y", d.Normal(loc * k, 0.7), obs=ys)


@pytest.mark.parametrize("which", ["binomial", "uniform"])
def test_trace_enum_elbo_matches_jax(which):
    """With a guide that samples nothing, the loss is the negative enumerated
    log marginal; it and its gradient in the model's params against JAX's."""
    build = {"binomial": _binomial_model, "uniform": _uniform_model}[which]
    ys = np.random.default_rng(3).normal(1.0, 1.0, 6).astype(np.float32)
    params = {"logit": np.float32(0.3), "loc": np.float32(0.7)}
    if which == "uniform":
        params.pop("logit")

    def loss_j(p):
        return jinfer.TraceEnum_ELBO().loss(random.PRNGKey(0), p,
                                            lambda: build("jax", jnp.asarray(ys)), lambda: None)

    jval, jgrad = jax.jit(jax.value_and_grad(loss_j))({k: jnp.asarray(v) for k, v in params.items()})

    def loss_t(p):
        return TraceEnum_ELBO().loss(torch.Generator().manual_seed(0), p,
                                     lambda: build("torch", torch.from_numpy(ys)), lambda: None)

    tgrad, tval = torch.func.grad_and_value(loss_t)({k: torch.tensor(v)
                                                     for k, v in params.items()})
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    for k in params:
        np.testing.assert_allclose(tgrad[k].item(), float(jgrad[k]), rtol=RTOL, atol=1e-6)


def _latent_binomial(pkg, ys):
    sample, plate, d = ((numpyro_tpu.sample, numpyro_tpu.plate, jdist) if pkg == "jax"
                        else (npt.sample, npt.plate, dist))
    logit = sample("logit", d.Normal(0.0, 1.5))
    loc = sample("loc", d.HalfNormal(1.0))
    with plate("N", ys.shape[0]):
        k = sample("k", d.Binomial(4, logits=logit), infer={"enumerate": "parallel"})
        sample("y", d.Normal(loc * k, 1.0), obs=ys)


def test_enumerated_nuts_potential_matches_jax():
    ys = np.random.default_rng(4).normal(1.5, 1.0, 8).astype(np.float32)
    wrapped = jenum.enum(jenum.config_enumerate(lambda y: _latent_binomial("jax", y)),
                         first_available_dim=-2)
    jvg = jax.jit(jax.value_and_grad(
        lambda p: jutil.potential_energy(wrapped, (jnp.asarray(ys),), {}, p, enum=True)))
    tinfo = util.initialize_model(torch.Generator().manual_seed(0),
                                  lambda y: _latent_binomial("torch", y),
                                  model_args=(torch.from_numpy(ys),))
    rng = np.random.default_rng(2)
    for _ in range(4):
        u = {"logit": np.float32(rng.standard_normal()),
             "loc": np.float32(rng.standard_normal() - 0.3)}
        jpe, jg = jvg({k: jnp.asarray(v) for k, v in u.items()})
        tg, tpe = torch.func.grad_and_value(tinfo.potential_fn)(
            {k: torch.as_tensor(v) for k, v in u.items()})
        np.testing.assert_allclose(tpe.item(), float(jpe), rtol=RTOL)
        for k in u:
            np.testing.assert_allclose(tg[k].item(), float(jg[k]), rtol=RTOL, atol=1e-6)


def test_enumerate_support_of_a_batched_or_uneven_total_count_raises():
    counts = torch.tensor([3.0, 3.0])
    with pytest.raises(NotImplementedError, match="static total_count"):
        torch.func.vmap(lambda n: dist.Binomial(n, probs=torch.tensor(0.3)).enumerate_support())(
            counts)
    with pytest.raises(NotImplementedError, match="Inhomogeneous"):
        dist.Binomial(torch.tensor([3.0, 4.0]), probs=torch.tensor(0.3)).enumerate_support()
    with pytest.raises(NotImplementedError, match="static total_count"):
        jax.vmap(lambda n: jdist.Binomial(n, probs=0.3).enumerate_support())(jnp.ones(2) * 3)
    # data captured from outside the map is read once on the host
    support = torch.func.vmap(
        lambda p: dist.Binomial(counts, probs=p).enumerate_support(False))(torch.rand(4))
    assert support.shape == (4, 4, 1)
