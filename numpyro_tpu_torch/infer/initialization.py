"""Init strategies (port of ``init_to_uniform`` and ``init_to_sample`` from
``numpyro_tpu/infer/initialization.py``; the others are listed in
ROADMAP.md)."""

from __future__ import annotations

import functools

import torch

import numpyro_tpu_torch.distributions as dist

__all__ = ["init_to_sample", "init_to_uniform"]


def _strategy(rule):
    """Make ``rule(site, **options)`` curryable as ``strategy(**options)``
    and restrict it to continuous, unobserved sample sites."""

    @functools.wraps(rule)
    def apply(site=None, **options):
        if site is None:
            return functools.partial(apply, **options)
        if (
            site["type"] != "sample"
            or site["is_observed"]
            or site["fn"].support.is_discrete
        ):
            return None
        return rule(site, **options)

    return apply


@_strategy
def init_to_uniform(site, radius=2.0):
    """Initialize to Uniform(-radius, radius) in unconstrained space (the
    NUTS default), drawn on the device of the site's generator."""
    if site["value"] is not None:
        return site["value"]
    rng_key = site["kwargs"].get("rng_key")
    sample_shape = site["kwargs"].get("sample_shape")
    to_support = dist.biject_to(site["fn"].support)
    bound = torch.tensor(float(radius), device=rng_key.device)
    box = dist.Uniform(-bound, bound).sample(
        rng_key, tuple(sample_shape) + to_support.inverse_shape(tuple(site["fn"].shape()))
    )
    return to_support(box)


@_strategy
def _prior_draw(site):
    if site["value"] is not None:
        return site["value"]
    return site["fn"](
        rng_key=site["kwargs"].get("rng_key"), sample_shape=site["kwargs"].get("sample_shape")
    )


def init_to_sample(site=None):
    """Initialize to a single prior sample."""
    if site is None:
        return init_to_sample
    return _prior_draw(site)
