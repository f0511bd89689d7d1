"""The init strategies and the batched init search of the port against the
JAX package's: each strategy's value at every site of a model with real,
positive, unit-interval, simplex, vector and ``Cauchy`` sites (one drawn
with a ``sample_shape``, one stored by ``condition``, one by
``substitute``); ``initialize_model`` at 4 chains under the strategies that
draw nothing; for ``init_to_median`` and ``init_to_sample`` chain ``i``
against a single-chain search on chain ``i``'s generator and the spread of
512 chains against JAX's; a model whose potential is ``-inf`` on part of the
box; ``MCMC(NUTS)`` from every strategy; ``compute_log_probs`` and
``get_transforms``.

Tolerances: rtol 1e-6 (atol 1e-6) on values both packages compute in
float32 from the same numbers; 4 Monte-Carlo errors on statistics of draws;
exact where the port is held to itself on the same generator."""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.infer import initialization as jinit
from numpyro_tpu.infer import util as jutil
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.infer import MCMC, NUTS, initialization
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.util import chain_generators

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
Y = np.array([0.3, -0.2, 1.1], np.float32)
VALUES = {"a": 0.25, "b": 1.5, "c": 0.4, "d": [0.2, 0.3, 0.5], "e": -0.7,
          "f": [[0.1, -0.2], [0.3, 0.0]], "s": [0.5, -0.5]}
STORED = {"g": 0.7, "h": 0.3}


def _model(np_, t, arr):
    """The model of these tests for a package: ``np_`` its primitives, ``t``
    its distributions, ``arr`` its array maker."""

    def model(y):
        a = np_.sample("a", t.Normal(arr(0.5), arr(2.0)))
        b = np_.sample("b", t.LogNormal(arr(0.2), arr(0.5)))
        c = np_.sample("c", t.Beta(arr(2.0), arr(3.0)))
        np_.sample("d", t.Dirichlet(arr([1.0, 2.0, 3.0])))
        np_.sample("e", t.Cauchy(arr(0.0), arr(1.0)))
        with np_.plate("p", 2):
            np_.sample("f", t.Normal(arr([0.0, 1.0]), arr(1.0)).to_event(1))
        np_.sample("s", t.Normal(arr(1.5), arr(1.0)), sample_shape=(2,))
        g = np_.sample("g", t.HalfNormal(arr(1.0)))
        h = np_.sample("h", t.Exponential(arr(2.0)))
        np_.sample("obs", t.Normal(a + c, b + g + h), obs=arr(Y))

    return model


def _arr(x):
    return torch.as_tensor(np.asarray(x, np.float32))


jax_model = _model(numpyro_tpu, jdist, lambda x: jnp.asarray(np.asarray(x, np.float32)))
torch_model = _model(npt, dist, _arr)


def _stored(model, h, c):
    """``g`` stored by ``condition`` (observed) and ``h`` by ``substitute``."""
    return c(h.substitute(model, data={"h": STORED["h"]}), data={"g": STORED["g"]})


def _torch_stored():
    return handlers.condition(handlers.substitute(torch_model, data={"h": _arr(STORED["h"])}),
                              data={"g": _arr(STORED["g"])})


def _jax_stored():
    return jhandlers.condition(
        jhandlers.substitute(jax_model, data={"h": jnp.asarray(STORED["h"], jnp.float32)}),
        data={"g": jnp.asarray(STORED["g"], jnp.float32)})


def _strategies(pkg, arr):
    return {
        "mean": pkg.init_to_mean,
        "feasible": pkg.init_to_feasible,
        "value": pkg.init_to_value(values={k: arr(v) for k, v in VALUES.items()}),
        "median": pkg.init_to_median,
        "sample": pkg.init_to_sample,
        "uniform": pkg.init_to_uniform,
    }


JAX_STRATEGIES = _strategies(jinit, lambda x: jnp.asarray(np.asarray(x, np.float32)))
TORCH_STRATEGIES = _strategies(initialization, _arr)
DETERMINISTIC = ("mean", "feasible", "value")


def _jax_trace(strategy, seed=0):
    strategy = strategy if isinstance(strategy, functools.partial) else strategy()
    model = jhandlers.substitute(jhandlers.seed(_jax_stored(), random.PRNGKey(seed)),
                                 substitute_fn=strategy)
    return jhandlers.trace(model).get_trace(jnp.asarray(Y))


def _torch_trace(strategy, seed=0):
    strategy = strategy if isinstance(strategy, functools.partial) else strategy()
    model = handlers.substitute(handlers.seed(_torch_stored(), torch.Generator().manual_seed(seed)),
                                substitute_fn=strategy)
    return handlers.trace(model).get_trace(_arr(Y))


def _in_support(site):
    return bool(site["fn"].support(site["value"]).all())


@pytest.mark.parametrize("name", sorted(TORCH_STRATEGIES))
def test_site_values_match_jax(name):
    """Every sample site's value under the strategy: the stored sites keep
    their values; under a strategy that draws nothing every site equals
    JAX's, but ``e``, whose ``Cauchy`` mean is NaN and so takes
    ``init_to_median``; every value lies in its support."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # init_to_median's note on h
        want = _jax_trace(JAX_STRATEGIES[name])
        got = _torch_trace(TORCH_STRATEGIES[name])
    assert [k for k in got if got[k]["type"] == "sample"] == \
        [k for k in want if want[k]["type"] == "sample"]
    for k in ("g", "h", "obs"):
        np.testing.assert_allclose(got[k]["value"].numpy(), np.asarray(want[k]["value"]), **TOL)
    for k, site in got.items():
        if site["type"] == "sample":
            assert tuple(site["value"].shape) == np.shape(want[k]["value"]), k
            # a coordinatewise median of simplex draws leaves the simplex
            assert _in_support(site) or (name == "median" and k == "d"), k
    if name in DETERMINISTIC:
        for k in got:
            if got[k]["type"] == "sample" and not (name == "mean" and k == "e"):
                np.testing.assert_allclose(got[k]["value"].numpy(),
                                           np.asarray(want[k]["value"]), **TOL, err_msg=k)


def _site(fn, seed, sample_shape=()):
    return {"type": "sample", "name": "z", "fn": fn, "value": None, "is_observed": False,
            "kwargs": {"rng_key": torch.Generator().manual_seed(seed),
                       "sample_shape": sample_shape}}


def test_init_to_mean_takes_the_median_where_the_mean_is_undefined():
    """A ``Cauchy`` (mean NaN) and a class whose mean raises
    ``NotImplementedError`` take ``init_to_median``'s value on the same
    generator; a defined mean is broadcast over the ``sample_shape``."""

    class NoMean(dist.Normal):
        @property
        def mean(self):
            raise NotImplementedError

    for fn in (dist.Cauchy(_arr(1.0), _arr(0.5)), NoMean(_arr(1.0), _arr(0.1))):
        via_mean = initialization.init_to_mean(_site(fn, 4, (3,)))
        assert via_mean.shape == (3,)
        assert torch.equal(via_mean, initialization.init_to_median(_site(fn, 4, (3,))))
    mean = initialization.init_to_mean(_site(dist.Normal(_arr([1.0, 2.0]), 1.0), 4, (3,)))
    assert torch.equal(mean, torch.tensor([[1.0, 2.0]] * 3))


def _batched(strategy, num_chains, model=None, seed=0, **kwargs):
    return infer_util.initialize_model(
        torch.Generator().manual_seed(seed), _torch_stored() if model is None else model,
        num_chains=num_chains, init_strategy=strategy, model_args=(_arr(Y),), **kwargs)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_initialize(model, name):
    """JAX's initialize_model at 4 chains (``random.split(key, 4)``).  Its
    batched ``init_to_mean`` raises: the NaN check reads a traced mean
    (``TracerBoolConversionError``, ROADMAP Queue 3), so that strategy,
    which draws the same for every chain, is held to JAX's one-chain search
    broadcast over the chains."""
    if name != "mean":
        return jutil.initialize_model(random.split(random.PRNGKey(0), 4), model,
                                      init_strategy=JAX_STRATEGIES[name],
                                      model_args=(jnp.asarray(Y),))
    with pytest.raises(Exception, match="TracerBoolConversionError|Attempted boolean"):
        jutil.initialize_model(random.split(random.PRNGKey(0), 4), model,
                               init_strategy=JAX_STRATEGIES[name], model_args=(jnp.asarray(Y),))
    info = jutil.initialize_model(random.PRNGKey(0), model, init_strategy=JAX_STRATEGIES[name],
                                  model_args=(jnp.asarray(Y),))
    z, pe, grad = info.param_info
    four = lambda t: {k: jnp.broadcast_to(v, (4,) + jnp.shape(v)) for k, v in t.items()}  # noqa
    return info._replace(param_info=info.param_info._replace(
        z=four(z), potential_energy=jnp.broadcast_to(pe, (4,)), z_grad=four(grad)))


@pytest.fixture(scope="module")
def jax_batched():
    """JAX's initialize_model at 4 chains under each strategy that draws
    nothing, and at 512 under the two that draw."""
    out = {}
    for name in DETERMINISTIC:
        info = _jax_initialize(_jax_stored(), name)
        out[name] = tuple(_np(t) if isinstance(t, dict) else np.asarray(t)
                          for t in info.param_info)
    for name in ("median", "sample"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            info = jutil.initialize_model(random.split(random.PRNGKey(1), 512), _jax_stored(),
                                          init_strategy=JAX_STRATEGIES[name],
                                          model_args=(jnp.asarray(Y),))
        out[name] = _np(info.param_info.z)
    return out


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_batched_deterministic_strategies_match_jax(name, jax_batched):
    """``initialize_model`` at 4 chains: params, potentials and gradients
    equal JAX's (``random.split(key, 4)``); a strategy that draws nothing
    (here ``init_to_mean``'s ``e`` draws, so its chains differ in ``e``
    alone) traces the model once for all chains."""
    z_j, pe_j, grad_j = jax_batched[name]
    traces0 = infer_util.init_traces
    z, pe, grad = _batched(TORCH_STRATEGIES[name], 4).param_info
    traces = infer_util.init_traces - traces0
    assert set(z) == set(z_j)
    for k in z:
        if name == "mean" and k == "e":
            continue
        np.testing.assert_allclose(z[k].numpy(), z_j[k], **TOL, err_msg=k)
        if name != "mean":
            np.testing.assert_allclose(grad[k].numpy(), grad_j[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    if name != "mean":
        np.testing.assert_allclose(pe.numpy(), pe_j, rtol=1e-6)
        assert traces == 2  # initialize_model's own trace and one candidate
    else:
        assert traces == 1 + 4


def _no_cauchy(np_, t, arr):
    def model(y):
        a = np_.sample("a", t.Normal(arr(0.5), arr(2.0)))
        b = np_.sample("b", t.LogNormal(arr(0.2), arr(0.5)))
        np_.sample("d", t.Dirichlet(arr([1.0, 2.0, 3.0])))
        np_.sample("obs", t.Normal(a, b), obs=arr(Y))

    return model


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_nuts_initial_params_match_jax(name):
    """``NUTS(model, init_strategy=s)`` at 4 chains starts where the JAX
    package's ``initialize_model`` puts them, on a model whose every mean
    is defined; the strategy is traced once for all chains."""
    jm = _no_cauchy(numpyro_tpu, jdist, lambda x: jnp.asarray(np.asarray(x, np.float32)))
    tm = _no_cauchy(npt, dist, _arr)
    want = _jax_initialize(jm, name).param_info
    state = NUTS(tm, init_strategy=TORCH_STRATEGIES[name]).init(
        torch.Generator().manual_seed(0), 10, None, (_arr(Y),), {}, num_chains=4)
    for k in want.z:
        np.testing.assert_allclose(state.z[k].numpy(), np.asarray(want.z[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(state.z_grad[k].numpy(), np.asarray(want.z_grad[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(state.potential_energy.numpy(),
                               np.asarray(want.potential_energy), rtol=1e-6)


@pytest.mark.parametrize("name", ["median", "sample"])
def test_chain_i_is_the_single_chain_search_on_its_generator(name):
    """A batched search under a strategy that draws gives chain ``i`` what a
    single-chain search on chain ``i``'s generator finds, exactly."""
    strategy = TORCH_STRATEGIES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        (z, pe, grad), ok = infer_util.find_valid_initial_params(
            torch.Generator().manual_seed(5), _torch_stored(), num_chains=4,
            init_strategy=strategy, model_args=(_arr(Y),))
        gens = chain_generators(torch.Generator().manual_seed(5), torch.device("cpu"), 4)
        for i, g in enumerate(gens):
            (z_i, pe_i, grad_i), ok_i = infer_util.find_valid_initial_params(
                g, _torch_stored(), init_strategy=strategy, model_args=(_arr(Y),))
            assert bool(ok[i]) and bool(ok_i)
            for k in z:
                assert torch.equal(z[k][i], z_i[k]), (i, k)
                torch.testing.assert_close(grad[k][i], grad_i[k], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(pe[i], pe_i, rtol=1e-6, atol=0)


def _spread_gap(x, y):
    """Largest gap of means and of standard deviations over coordinates, in
    units of their combined Monte-Carlo errors."""
    x = x.reshape(x.shape[0], -1).astype(np.float64)
    y = y.reshape(y.shape[0], -1).astype(np.float64)
    sx, sy = x.std(0, ddof=1), y.std(0, ddof=1)
    mean_gap = np.abs(x.mean(0) - y.mean(0)) / np.sqrt(sx**2 / len(x) + sy**2 / len(y))
    std_gap = np.abs(sx - sy) / np.sqrt(sx**2 / (2 * len(x) - 2) + sy**2 / (2 * len(y) - 2))
    return max(mean_gap.max(), std_gap.max())


def _share_gap(x, y, low=-1.0, high=1.0):
    """Gap of the shares of draws in ``(low, high)``, in units of their
    combined binomial errors: a statistic for the heavy-tailed ``Cauchy``
    site, whose one draw (``init_to_sample``) has no variance."""
    p, q = (((low < v) & (v < high)).mean() for v in (x, y))
    return abs(p - q) / np.sqrt(p * (1 - p) / len(x) + q * (1 - q) / len(y))


@pytest.mark.parametrize("name", ["median", "sample"])
def test_spread_of_512_chains_matches_jax(name, jax_batched):
    """Means and standard deviations over 512 chains of every continuous
    latent (unconstrained) within 4 Monte-Carlo errors of JAX's; for the
    ``Cauchy`` site the share in (-1, 1); the site stored by ``substitute``
    is the same in every chain of both."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        z = _batched(TORCH_STRATEGIES[name], 512, seed=7).param_info.z
    for k, v in z.items():
        v, w = v.numpy(), jax_batched[name][k]
        if k == "h":
            np.testing.assert_allclose(v, w, **TOL)
        elif k == "e":
            assert _share_gap(v, w) < 4
        else:
            assert _spread_gap(v, w) < 4, k


def _cut_model(np_, t, arr, where):
    """A potential of ``-inf`` where ``x > 0.3``: about 40% of a standard
    normal's draws, and of the box (-2, 2)."""

    def model():
        x = np_.sample("x", t.Normal(arr(0.0), arr(1.0)))
        np_.sample("y", t.Normal(arr(0.0), arr(1.0)))
        np_.factor("cut", where(x > 0.3, arr(-np.inf), arr(0.0)))

    return model


@pytest.mark.parametrize("name", ["uniform", "median", "sample"])
def test_valid_chains_keep_their_params_while_others_retry(name):
    """With 64 chains about 40% of the first candidates are invalid: those
    draw again until valid, and the others keep their first candidates."""
    model = _cut_model(npt, dist, _arr, torch.where)
    strategy = TORCH_STRATEGIES[name]
    strategy = strategy if isinstance(strategy, functools.partial) else strategy()
    proto = {"x": torch.zeros(()), "y": torch.zeros(())}
    first, _ = infer_util._batched_candidates(torch.Generator().manual_seed(9), model, strategy,
                                              64, (), {}, proto)
    first_ok = first["x"] <= 0.3
    (z, pe, grad), ok = infer_util.find_valid_initial_params(
        torch.Generator().manual_seed(9), model, num_chains=64, init_strategy=strategy,
        prototype_params=proto)
    assert bool(ok.all()) and bool(torch.isfinite(pe).all())
    assert 10 < int((~first_ok).sum()) < 54
    assert bool((z["x"] <= 0.3).all())
    for k in z:
        assert torch.equal(z[k][first_ok], first[k][first_ok])
        assert not torch.equal(z[k][~first_ok], first[k][~first_ok])


def test_a_strategy_that_draws_nothing_does_not_retry():
    """``init_to_feasible`` on a model that is invalid at zero gives up
    after one batched evaluation, as a retry would find the same point."""

    def model():
        x = npt.sample("x", dist.Normal(_arr(0.0), _arr(1.0)))
        npt.factor("cut", torch.where(x > -1.0, _arr(-np.inf), _arr(0.0)))

    evals0 = infer_util.potential_evals
    with pytest.raises(RuntimeError, match="Cannot find valid initial parameters"):
        infer_util.initialize_model(torch.Generator().manual_seed(0), model, num_chains=8,
                                    init_strategy=initialization.init_to_feasible)
    assert infer_util.potential_evals - evals0 == 1


def test_search_without_a_prototype_and_without_gradient():
    """``prototype_params=None`` traces ``init_to_uniform`` as any other
    strategy; ``validate_grad=False`` scores the potential alone."""
    model = _no_cauchy(npt, dist, _arr)
    (z, pe, grad), ok = infer_util.find_valid_initial_params(
        torch.Generator().manual_seed(2), model, num_chains=3, model_args=(_arr(Y),))
    assert bool(ok.all()) and grad is not None and z["a"].shape == (3,)
    gens = chain_generators(torch.Generator().manual_seed(2), torch.device("cpu"), 3)
    (z0, _, _), _ = infer_util.find_valid_initial_params(gens[0], model, model_args=(_arr(Y),))
    assert torch.equal(z["d"][0], z0["d"])
    (z, pe, grad), ok = infer_util.find_valid_initial_params(
        torch.Generator().manual_seed(2), model, num_chains=3, model_args=(_arr(Y),),
        validate_grad=False, init_strategy=initialization.init_to_median)
    assert bool(ok.all()) and grad is None and pe.shape == (3,)


@pytest.mark.parametrize("name", sorted(TORCH_STRATEGIES))
def test_nuts_runs_from_every_strategy(name):
    """``MCMC(NUTS(model, init_strategy=s), num_chains=4)`` runs; its init
    traces are counted (one, plus one per chain under a strategy that
    draws)."""
    mcmc = MCMC(NUTS(_no_cauchy(npt, dist, _arr), init_strategy=TORCH_STRATEGIES[name],
                     max_tree_depth=3),
                num_warmup=10, num_samples=5, num_chains=4, device="cpu")
    mcmc.run(0, _arr(Y))
    draws = mcmc.get_samples(group_by_chain=True)
    assert draws["d"].shape == (4, 5, 3) and bool(torch.isfinite(draws["a"]).all())
    traces = mcmc.last_run_stats["init_traces"]
    assert traces == {"mean": 2, "feasible": 2, "value": 2, "uniform": 1}.get(name, 1 + 4)


def _lp_model(np_, t, arr, h):
    def model(y):
        with np_.plate("N", 3):
            a = np_.sample("a", t.Normal(arr(0.0), arr(1.0)))
            with h.scale(scale=2.0):
                b = np_.sample("b", t.Normal(a, arr(1.0)).expand([2, 3]))
            with h.mask(mask=arr(np.array([True, False, True]))):
                np_.sample("obs", t.Normal(a + b.sum(0), arr(1.0)), obs=y)

    return model


LP_PARAMS = {"a": np.array([0.1, -0.3, 0.4], np.float32),
             "b": np.arange(6, dtype=np.float32).reshape(2, 3) / 10}


@pytest.mark.parametrize("batch_ndims", [0, 1, 2])
def test_compute_log_probs_matches_jax(batch_ndims):
    """Per-site log-probs under ``plate``, ``scale`` and ``mask``, summed
    whole or over all but the leading ``batch_ndims`` dims."""
    jm = _lp_model(numpyro_tpu, jdist, lambda x: jnp.asarray(x), jhandlers)
    tm = _lp_model(npt, dist, lambda x: torch.as_tensor(x), handlers)
    want, _ = jutil.compute_log_probs(jm, (jnp.asarray(Y),), {},
                                      {k: jnp.asarray(v) for k, v in LP_PARAMS.items()},
                                      batch_ndims=batch_ndims)
    got, trace = infer_util.compute_log_probs(tm, (_arr(Y),), {},
                                              {k: torch.from_numpy(v) for k, v in LP_PARAMS.items()},
                                              batch_ndims=batch_ndims)
    assert set(got) == set(want) == {"a", "b", "obs"}
    for k in got:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    assert trace["b"]["scale"] == 2.0


def test_get_transforms_matches_jax():
    """The transform of every continuous latent, by name, maps the same
    numpy input to JAX's output (and back)."""
    jm = _no_cauchy(numpyro_tpu, jdist, lambda x: jnp.asarray(np.asarray(x, np.float32)))
    tm = _no_cauchy(npt, dist, _arr)
    params = {"a": 0.3, "b": 1.7, "d": [0.2, 0.3, 0.5]}
    want = jutil.get_transforms(jm, (jnp.asarray(Y),), {},
                                {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in params.items()})
    got = infer_util.get_transforms(tm, (_arr(Y),), {}, {k: _arr(v) for k, v in params.items()})
    assert set(got) == set(want) == {"a", "b", "d"}
    rng = np.random.default_rng(0)
    for k in got:
        assert type(got[k]).__name__ == type(want[k]).__name__, k
        u = rng.normal(size=(2,) if k == "d" else ()).astype(np.float32)
        np.testing.assert_allclose(got[k](_arr(u)).numpy(), np.asarray(want[k](jnp.asarray(u))),
                                   **TOL, err_msg=k)
        x = _arr(params[k])
        np.testing.assert_allclose(got[k].inv(x).numpy(),
                                   np.asarray(want[k].inv(jnp.asarray(np.asarray(x)))),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
