"""Model-DSL primitives and the effect-handler message stack (port of the
parts of ``numpyro_tpu/primitives.py`` that the covtype slice needs:
``Messenger``, ``apply_stack``, ``sample``, ``factor``, ``deterministic``).

The handler stack is plain Python that runs whenever the model runs.  Under
``torch.func`` transforms (the chain-batched potential) the model runs once
per batched evaluation, and only the summed log density leaves it.
"""

from __future__ import annotations

import functools

import torch

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.util import identity

__all__ = ["Messenger", "apply_stack", "deterministic", "factor", "prng_key", "sample"]

_PYRO_STACK = []


def default_process_message(msg):
    if msg["value"] is None:
        if msg["type"] == "sample":
            msg["value"], msg["intermediates"] = msg["fn"](
                *msg["args"], sample_intermediates=True, **msg["kwargs"]
            )
        else:
            msg["value"] = msg["fn"](*msg["args"], **msg["kwargs"])


def apply_stack(msg):
    """Route a message bottom-up (process) then top-down (postprocess); a
    handler setting ``msg["stop"]`` truncates the upward pass."""
    stop_at = 0
    for idx in range(len(_PYRO_STACK) - 1, -1, -1):
        _PYRO_STACK[idx].process_message(msg)
        if msg.get("stop"):
            stop_at = idx
            break
    if msg["value"] is None:
        default_process_message(msg)
    for idx in range(stop_at, len(_PYRO_STACK)):
        _PYRO_STACK[idx].postprocess_message(msg)
    return msg


class Messenger:
    """Base effect handler: a context manager on the global stack."""

    def __init__(self, fn=None):
        if fn is not None and not callable(fn):
            raise ValueError(
                "Expected `fn` to be a Python callable object; "
                f"instead found type(fn) = {type(fn)}."
            )
        self.fn = fn
        functools.update_wrapper(self, fn, updated=[])

    def __enter__(self):
        _PYRO_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if exc_type is None:
            assert _PYRO_STACK[-1] is self
            _PYRO_STACK.pop()
        elif self in _PYRO_STACK:
            del _PYRO_STACK[_PYRO_STACK.index(self):]

    def process_message(self, msg):
        pass

    def postprocess_message(self, msg):
        pass

    def __call__(self, *args, **kwargs):
        with self:
            return None if self.fn is None else self.fn(*args, **kwargs)


def _dispatch(msg_type, name=None, fn=identity, value=None, kwargs=None, **extras):
    msg = {
        "type": msg_type,
        "name": name,
        "fn": fn,
        "args": (),
        "kwargs": {} if kwargs is None else kwargs,
        "value": value,
        "cond_indep_stack": [],
    }
    msg.update(extras)
    return apply_stack(msg)


def sample(name, fn, obs=None, rng_key=None, sample_shape=(), infer=None, obs_mask=None):
    """Declare a random variable.  ``rng_key`` is a ``torch.Generator``."""
    if not isinstance(fn, dist.Distribution):
        raise TypeError(f"sample() fn must be a Distribution, got {fn!r}")
    if obs_mask is not None:
        raise NotImplementedError(
            "obs_mask is not ported to numpyro_tpu_torch yet (see ROADMAP.md)"
        )
    if not _PYRO_STACK:
        if obs is not None:
            return obs
        if rng_key is None:
            raise ValueError(
                "Cannot call `sample` outside an inference context without "
                "an explicit rng_key."
            )
        return fn(rng_key=rng_key, sample_shape=sample_shape)
    return _dispatch(
        "sample",
        name,
        fn,
        value=obs,
        kwargs={"rng_key": rng_key, "sample_shape": sample_shape},
        scale=None,
        is_observed=obs is not None,
        intermediates=[],
        infer={} if infer is None else infer,
    )["value"]


def prng_key():
    """The generator of the innermost ``seed`` handler (JAX's ``prng_key``
    draws a fresh split key there; the port's generator advances with every
    draw instead).  ``None`` outside any handler or without a ``seed``."""
    if not _PYRO_STACK:
        return None
    return _dispatch(
        "prng_key", fn=lambda rng_key: rng_key, kwargs={"rng_key": None}
    )["value"]


def deterministic(name, value):
    """Record a deterministic function of other sites in the trace."""
    if not _PYRO_STACK:
        return value
    return _dispatch("deterministic", name, lambda *a, **k: value, value=value)["value"]


def factor(name, log_factor):
    """Add an arbitrary log-density term via a Unit-distribution site."""
    unit_dist = dist.Unit(log_factor)
    unit_value = torch.zeros(
        tuple(log_factor.shape) + (0,), dtype=log_factor.dtype, device=log_factor.device
    )
    sample(name, unit_dist, obs=unit_value, infer={"is_auxiliary": True})
