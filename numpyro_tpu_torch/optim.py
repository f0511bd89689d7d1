"""Optimizers for SVI (port of ``numpyro_tpu/optim.py``).

The JAX package wraps optax transformations in the thin ``_NumPyroOptim``
API (``init``/``update``/``eval_and_update``/``get_params``) that SVI drives.
The port writes each transformation's update out on tensors, with the
arithmetic of the optax version it replaces (``optax.adam``,
``optax.adagrad``, ``optax.sgd``, ``optax.rmsprop``, ``optax.sm3`` and
``optax.clip``), and keeps the optax state layout: a state is
``(step, (params, opt_state))``, where ``opt_state`` is the tuple of the
chained transformations' states, named as optax names them.  Params are a
dict of tensors or of trees of them (a network's layers, with ``None``
where a layer has no bias; ``SM3`` and ``Minimize`` take tensors only); every update is out
of place and stays on their device.

``step_size`` is a number or a callable of the step count (an ``int32``
tensor), as optax takes it.  ``optax_to_numpyro`` (a bridge to optax) is not
ported (ROADMAP.md).  ``Minimize`` runs a whole BFGS fit in one step
(``numpyro_tpu_torch.optimize``, JAX's algorithm written out on tensors).
"""

from __future__ import annotations

from collections import namedtuple
from collections.abc import Callable

import torch

from numpyro_tpu_torch.infer.hmc_core import FlatLayout
from numpyro_tpu_torch.optimize import minimize
from numpyro_tpu_torch.util import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "Adam",
    "Adagrad",
    "ClippedAdam",
    "Minimize",
    "Momentum",
    "RMSProp",
    "RMSPropMomentum",
    "SGD",
    "SM3",
]

GradientTransformation = namedtuple("GradientTransformation", ["init", "update"])
EmptyState = namedtuple("EmptyState", [])
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
ScaleByRssState = namedtuple("ScaleByRssState", ["sum_of_squares"])
ScaleByRmsState = namedtuple("ScaleByRmsState", ["nu"])
ScaleByScheduleState = namedtuple("ScaleByScheduleState", ["count"])
ScaleBySM3State = namedtuple("ScaleBySM3State", ["mu", "nu"])
TraceState = namedtuple("TraceState", ["trace"])


def _count(params):
    leaf = tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _empty_init(params):
    return EmptyState()


def _identity():
    return GradientTransformation(_empty_init, lambda g, state, params=None: (g, state))


def _chain(*transforms):
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def _scale(step_size):
    return GradientTransformation(
        _empty_init, lambda g, state, params=None: (tree_map(lambda u: step_size * u, g), state)
    )


def _scale_by_schedule(step_size_fn):
    def init(params):
        return ScaleByScheduleState(_count(params))

    def update(updates, state, params=None):
        step_size = step_size_fn(state.count)
        updates = tree_map(lambda g: torch.as_tensor(step_size, dtype=g.dtype,
                                                     device=g.device) * g, updates)
        return updates, ScaleByScheduleState(state.count + 1)

    return GradientTransformation(init, update)


def _scale_by_learning_rate(learning_rate):
    if callable(learning_rate):
        return _scale_by_schedule(lambda count: -learning_rate(count))
    return _scale(-learning_rate)


def _bias_correction(moment, decay, count):
    correction = 1 - decay**count
    return tree_map(lambda t: t / correction.to(t.dtype), moment)


def _scale_by_adam(b1, b2, eps):
    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return ScaleByAdamState(_count(params), zeros, tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates, state.nu)
        count = state.count + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        updates = tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat, nu_hat)
        return updates, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def _scale_by_rss(initial_accumulator_value, eps):
    def init(params):
        return ScaleByRssState(
            tree_map(lambda p: torch.full_like(p, initial_accumulator_value), params)
        )

    def update(updates, state, params=None):
        sum_of_squares = tree_map(lambda g, t: g * g + t, updates, state.sum_of_squares)
        inv_sqrt = tree_map(
            lambda t: torch.where(t > 0, torch.rsqrt(t + eps), 0.0), sum_of_squares
        )
        return tree_map(lambda s, g: s * g, inv_sqrt, updates), ScaleByRssState(sum_of_squares)

    return GradientTransformation(init, update)


def _scale_by_rms(decay, eps):
    def init(params):
        return ScaleByRmsState(tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        nu = tree_map(lambda g, t: (1 - decay) * (g * g) + decay * t, updates, state.nu)
        updates = tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, updates)
        return updates, ScaleByRmsState(nu)

    return GradientTransformation(init, update)


def _trace(decay):
    def init(params):
        return TraceState(tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        new_trace = tree_map(lambda g, t: g + decay * t, updates, state.trace)
        return new_trace, TraceState(new_trace)

    return GradientTransformation(init, update)


def _clip(max_delta):
    return GradientTransformation(
        _empty_init,
        lambda g, state, params=None: (tree_map(lambda u: u.clamp(-max_delta, max_delta), g),
                                       state),
    )


def _scale_by_sm3(b1, eps=1e-8):
    """``optax.scale_by_sm3`` with ``b2 = 1``: one accumulator per axis of
    each leaf, the elementwise accumulator the minimum over the axes' (a
    leaf of fewer than two dims keeps a full one)."""

    def init(params):
        mu = tree_map(lambda p: [p.new_zeros((s,)) for s in p.shape], params)
        return ScaleBySM3State(mu, tree_map(torch.zeros_like, params))

    def expanded(g, v):
        return [v[i].reshape([1] * i + [g.shape[i]] + [1] * (g.dim() - i - 1))
                for i in range(g.dim())]

    def new_accum(g, v):
        if g.dim() < 2:
            return g**2 + v[0]
        least = v[0]
        for x in v[1:]:
            least = torch.minimum(least, x)
        return g**2 + least

    def new_mu(g, i):
        if g.dim() < 2:
            return g
        others = [a for a in range(g.dim()) if a != i]
        return torch.amax(g, dim=others)

    def update(updates, state, params=None):
        mu = {k: expanded(g, state.mu[k]) for k, g in updates.items()}
        accum = {k: new_accum(g, mu[k]) for k, g in updates.items()}
        up = {
            k: g * torch.where(accum[k] > 0, torch.rsqrt(accum[k] + eps), 0.0)
            for k, g in updates.items()
        }
        nu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, up, state.nu)
        mu = {k: [new_mu(a, i) for i in range(a.dim())] for k, a in accum.items()}
        return nu, ScaleBySM3State(mu, nu)

    return GradientTransformation(init, update)


class _NumPyroOptim:
    """Stateless-API optimizer: a state is ``(step, (params, opt_state))``."""

    def __init__(self, transformation):
        self.transformation = transformation

    def init(self, params):
        opt_state = self.transformation.init(params)
        return _count(params), (params, opt_state)

    def update(self, g, state):
        step, (params, opt_state) = state
        updates, opt_state = self.transformation.update(g, opt_state, params)
        params = tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
        return step + 1, (params, opt_state)

    def _eval(self, fn, params, forward_mode_differentiation):
        # torch.func takes trees of tensors only: a param tree with None
        # leaves (a network's missing bias) is differentiated through its
        # list of tensor leaves
        leaves = tree_leaves(params)
        if forward_mode_differentiation:
            out, aux = fn(params)
            # a 0-d tangent meeting a Python number comes out in float64
            grads = [g.to(p.dtype) for p, g in zip(leaves, torch.func.jacfwd(
                lambda ls: fn(tree_unflatten(params, ls))[0])(leaves))]
        else:
            # torch.func takes an aux of tensors only: a None travels boxed
            def boxed(ls):
                out, aux = fn(tree_unflatten(params, ls))
                return out, [] if aux is None else [aux]

            grads, (out, aux) = torch.func.grad_and_value(boxed, has_aux=True)(leaves)
            aux = aux[0] if aux else None
        return out, aux, tree_unflatten(params, grads)

    def eval_and_update(self, fn: Callable, state, forward_mode_differentiation=False):
        """One optimization step on ``fn(params) -> (loss, aux)``."""
        out, aux, grads = self._eval(fn, self.get_params(state), forward_mode_differentiation)
        return (out, aux), self.update(grads, state)

    def eval_and_stable_update(self, fn: Callable, state, forward_mode_differentiation=False):
        """Like :meth:`eval_and_update`, but keeps the previous state when the
        loss or any updated param is not finite.  The choice is made on the
        device (``torch.where``), with no wait for the host."""
        out, aux, grads = self._eval(fn, self.get_params(state), forward_mode_differentiation)
        new_state = self.update(grads, state)
        ok = torch.isfinite(out)
        for leaf in tree_leaves(new_state[1][0]):
            ok = ok & torch.isfinite(leaf).all()
        state = tree_map(lambda new, old: torch.where(ok, new, old), new_state, state)
        return (torch.where(ok, out, torch.nan), aux), state

    def get_params(self, state):
        _, (params, _) = state
        return params


def Adam(step_size=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> _NumPyroOptim:
    return _NumPyroOptim(_chain(_scale_by_adam(b1, b2, eps), _scale_by_learning_rate(step_size)))


def ClippedAdam(step_size=1e-3, b1=0.9, b2=0.999, eps=1e-8, clip_norm=10.0) -> _NumPyroOptim:
    """Adam after an elementwise clip of the gradient to
    ``[-clip_norm, clip_norm]`` (``optax.clip``, not a clip of the norm)."""
    return _NumPyroOptim(
        _chain(
            _clip(clip_norm),
            _chain(_scale_by_adam(b1, b2, eps), _scale_by_learning_rate(step_size)),
        )
    )


def Adagrad(step_size=1e-3, eps=1e-7) -> _NumPyroOptim:
    return _NumPyroOptim(_chain(_scale_by_rss(0.1, eps), _scale_by_learning_rate(step_size)))


def Momentum(step_size=1e-3, mass=0.9) -> _NumPyroOptim:
    return _NumPyroOptim(_chain(_trace(mass), _scale_by_learning_rate(step_size)))


def RMSProp(step_size=1e-3, gamma=0.9, eps=1e-8) -> _NumPyroOptim:
    return _NumPyroOptim(
        _chain(_scale_by_rms(gamma, eps), _scale_by_learning_rate(step_size), _identity())
    )


def RMSPropMomentum(step_size=1e-3, gamma=0.9, eps=1e-8, momentum=0.9) -> _NumPyroOptim:
    return _NumPyroOptim(
        _chain(_scale_by_rms(gamma, eps), _scale_by_learning_rate(step_size), _trace(momentum))
    )


def SGD(step_size=1e-3) -> _NumPyroOptim:
    return _NumPyroOptim(_chain(_identity(), _scale_by_learning_rate(step_size)))


def SM3(step_size=1e-3, momentum=0.9) -> _NumPyroOptim:
    """``optax.sm3``, with 0-d leaves lifted to shape ``(1,)`` around it (it
    keeps one accumulator per axis), as the JAX package does."""
    inner = _chain(_scale_by_sm3(momentum), _scale(-step_size))

    def lift(tree):
        return {k: v.reshape(1) if v.dim() == 0 else v for k, v in tree.items()}

    def init(params):
        return inner.init(lift(params))

    def update(updates, state, params=None):
        out, state = inner.update(lift(updates), state, None if params is None else lift(params))
        return {k: u.reshape(updates[k].shape) for k, u in out.items()}, state

    return _NumPyroOptim(GradientTransformation(init, update))


class Minimize:
    """A whole minimization in one step (BFGS, ``optimize.minimize``), with
    the state of the other optimizers: ``(step, (params, None))``.  It only
    works through ``eval_and_update`` (``SVI.update``/``run``); every
    evaluation of the loss in a step sees the same draws (``SVI`` replays its
    generator for an optimizer with ``replays_draws``), as the JAX package's
    fixed key gives.  ``minimize_kwargs`` go to ``optimize.minimize``."""

    replays_draws = True

    def __init__(self, method="BFGS", **minimize_kwargs):
        self._method = method
        self._kwargs = minimize_kwargs

    def init(self, params):
        return _count(params), (params, None)

    def get_params(self, state):
        _, (params, _) = state
        return params

    def update(self, g, state):
        raise ValueError("Minimize optimizer only works with eval_and_update; use SVI.run")

    def eval_and_update(self, fn: Callable, state, forward_mode_differentiation=False):
        """One whole fit of ``fn(params) -> (loss, aux)`` from the current
        params (``forward_mode_differentiation`` is ignored, as in the JAX
        package)."""
        step, (params, _) = state
        layout = FlatLayout(params)
        flat = torch.cat([params[k].reshape(-1) for k in layout.names])
        results = minimize(lambda x: fn(layout.unravel_one(x))[0], flat, (),
                           method=self._method, **self._kwargs)
        params = layout.unravel_one(results.x)
        _, aux = fn(params)
        return (results.fun, aux), (step + 1, (params, None))

    eval_and_stable_update = eval_and_update
