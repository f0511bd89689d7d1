"""The port's optimizers against the JAX package's (optax underneath): the
same gradient sequence, made from a seed with numpy, drives both for 50
steps, and the params and every leaf of the optimizer state must agree to
``atol=1e-6, rtol=1e-5`` (float32 arithmetic in the same order; what is
left is the rounding of ``rsqrt`` and ``pow``).  Also the stateless API
(``eval_and_update``, ``eval_and_stable_update``) on a loss function."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import numpyro_tpu.optim as joptim
import numpyro_tpu_torch.optim as optim

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5
NAMES = ["Adam", "ClippedAdam", "Adagrad", "Momentum", "RMSProp", "RMSPropMomentum", "SGD", "SM3"]


def _params(rng):
    # a vector, a matrix and a 0-d leaf (which SM3 lifts to shape (1,))
    return {
        "a": rng.standard_normal(3).astype(np.float32),
        "b": rng.standard_normal((2, 4)).astype(np.float32),
        "c": np.asarray(0.3, np.float32),
    }


def _grads(rng, params, n=50, scale=5.0):
    return [
        {k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32) for k, v in params.items()}
        for _ in range(n)
    ]


def _leaves(tree):
    """The leaves of a port state in the order ``jax.tree.leaves`` gives a
    JAX state: dict keys sorted, tuples and lists in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _structure(tree):
    """A JAX-comparable outline of a state: namedtuple names and nesting."""
    if isinstance(tree, (torch.Tensor, jax.Array, np.ndarray)):
        return "*"
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(v) for v in tree)
    return repr(tree)


def _run_both(name, step_size, grads, params, **kw):
    jopt = getattr(joptim, name)(step_size, **kw)
    topt = getattr(optim, name)(step_size, **kw)
    js = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = topt.init({k: torch.tensor(v) for k, v in params.items()})
    for g in grads:
        js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts)
    return jopt, topt, js, ts


def _assert_states_match(js, ts):
    assert _structure(ts) == _structure(js)
    jl, tl = jax.tree.leaves(js), _leaves(ts)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(np.shape(j)) == tuple(t.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_fifty_steps_match_optax(name):
    rng = np.random.default_rng(0)
    params = _params(rng)
    jopt, topt, js, ts = _run_both(name, 0.01, _grads(rng, params), params)
    _assert_states_match(js, ts)
    for k, v in jopt.get_params(js).items():
        np.testing.assert_allclose(topt.get_params(ts)[k].numpy(), np.asarray(v),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["Adam", "SGD", "RMSPropMomentum", "Adagrad"])
def test_step_size_schedule_matches_optax(name):
    rng = np.random.default_rng(1)
    params = _params(rng)
    # the schedule takes the step count, an int32 array in both packages
    _, _, js, ts = _run_both(name, lambda i: 0.05 / (1.0 + i), _grads(rng, params), params)
    _assert_states_match(js, ts)


@pytest.mark.parametrize("kw", [{"mass": 0.5}, {"mass": 0.99}])
def test_momentum_mass_matches_optax(kw):
    rng = np.random.default_rng(2)
    params = _params(rng)
    _, _, js, ts = _run_both("Momentum", 0.01, _grads(rng, params), params, **kw)
    _assert_states_match(js, ts)


def test_clipped_adam_clips_each_element():
    """``optax.clip`` bounds every gradient element by ``clip_norm``; the norm
    of the whole gradient is not involved."""
    rng = np.random.default_rng(3)
    params = _params(rng)
    grads = _grads(rng, params, n=20, scale=50.0)
    _, _, js, ts = _run_both("ClippedAdam", 0.01, grads, params, clip_norm=1.0)
    _assert_states_match(js, ts)
    # with every element clipped to +-1, Adam's first moment stays inside it
    mu = ts[1][1][1][0].mu
    assert all(bool((v.abs() <= 1.0).all()) for v in mu.values())


def test_sm3_lifts_a_scalar_leaf():
    opt = optim.SM3(0.1)
    state = opt.init({"s": torch.tensor(2.0)})
    state = opt.update({"s": torch.tensor(-1.0)}, state)
    assert opt.get_params(state)["s"].shape == ()
    assert state[1][1][0].nu["s"].shape == (1,)


def _quadratic(target):
    def fn(params):
        loss = sum(((v - target) ** 2).sum() for v in params.values())
        return loss, None

    return fn


def _jax_quadratic(target):
    def fn(params):
        loss = sum(jnp.sum((v - target) ** 2) for v in params.values())
        return loss, None

    return fn


@pytest.mark.parametrize("stable", [False, True])
def test_eval_and_update_matches_jax(stable):
    rng = np.random.default_rng(4)
    params = _params(rng)
    jopt, topt = joptim.Adam(0.1), optim.Adam(0.1)
    js = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = topt.init({k: torch.tensor(v) for k, v in params.items()})
    for _ in range(10):
        jstep = jopt.eval_and_stable_update if stable else jopt.eval_and_update
        tstep = topt.eval_and_stable_update if stable else topt.eval_and_update
        (jl, _), js = jstep(_jax_quadratic(0.5), js)
        (tl, aux), ts = tstep(_quadratic(0.5), ts)
        assert aux is None
        np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    _assert_states_match(js, ts)


def test_stable_update_keeps_the_state_on_a_nan_loss():
    rng = np.random.default_rng(5)
    params = _params(rng)
    jopt, topt = joptim.Adam(0.1), optim.Adam(0.1)
    js = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = topt.init({k: torch.tensor(v) for k, v in params.items()})
    (_, _), js = jopt.eval_and_stable_update(_jax_quadratic(0.5), js)
    (_, _), ts = topt.eval_and_stable_update(_quadratic(0.5), ts)

    def nan_loss(params):
        loss, _ = _quadratic(0.5)(params)
        return loss * torch.nan, None

    def jax_nan_loss(params):
        loss, _ = _jax_quadratic(0.5)(params)
        return loss * jnp.nan, None

    (jl, _), js2 = jopt.eval_and_stable_update(jax_nan_loss, js)
    (tl, _), ts2 = topt.eval_and_stable_update(nan_loss, ts)
    assert np.isnan(float(jl)) and torch.isnan(tl)
    # the step count and every leaf stay as they were, in both packages
    _assert_states_match(js2, ts2)
    for old, new in zip(_leaves(ts), _leaves(ts2)):
        assert torch.equal(old, new)
    assert int(ts2[0]) == 1


def test_stable_update_keeps_the_state_on_a_nonfinite_param():
    opt = optim.SGD(1.0)
    state = opt.init({"x": torch.tensor([1.0, 2.0])})

    def fn(params):
        # a finite loss whose gradient overflows the update
        return (params["x"] * 3e38).sum(), None

    (loss, _), new = opt.eval_and_stable_update(fn, state)
    assert torch.isnan(loss)
    assert torch.equal(opt.get_params(new)["x"], torch.tensor([1.0, 2.0]))


def test_forward_mode_gradient_matches_reverse():
    rng = np.random.default_rng(6)
    params = {k: torch.tensor(v) for k, v in _params(rng).items()}
    opt = optim.SGD(0.1)
    (_, _), fwd = opt.eval_and_update(_quadratic(0.5), opt.init(params),
                                      forward_mode_differentiation=True)
    (_, _), rev = opt.eval_and_update(_quadratic(0.5), opt.init(params))
    for a, b in zip(_leaves(fwd), _leaves(rev)):
        torch.testing.assert_close(a, b)
