"""Init strategies (port of ``numpyro_tpu/infer/initialization.py``).  Every
strategy draws on the device of the site's generator; ``init_to_mean``,
``init_to_feasible`` and ``init_to_value`` with every site given draw
nothing, so a batched init search traces them once for all chains
(``infer.util.find_valid_initial_params``)."""

from __future__ import annotations

import functools
import warnings

import torch

import numpyro_tpu_torch.distributions as dist

__all__ = [
    "init_to_feasible",
    "init_to_mean",
    "init_to_median",
    "init_to_sample",
    "init_to_uniform",
    "init_to_value",
]


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
    NUTS default), drawn on the device of the site's generator.  Radius 0
    is the unconstrained zero, which draws nothing."""
    if site["value"] is not None:
        return site["value"]
    rng_key = site["kwargs"].get("rng_key")
    sample_shape = site["kwargs"].get("sample_shape")
    to_support = dist.biject_to(site["fn"].support)
    shape = tuple(sample_shape) + to_support.inverse_shape(tuple(site["fn"].shape()))
    if radius == 0:
        return to_support(torch.zeros(shape, device=rng_key.device))
    bound = torch.tensor(float(radius), device=rng_key.device)
    return to_support(dist.Uniform(-bound, bound).sample(rng_key, shape))


def _median0(draws):
    """The median over the leading axis as ``jnp.median`` takes it: the mean
    of the two middle values for an even count (``torch.median`` returns the
    lower one)."""
    ordered = draws.sort(dim=0).values
    n = ordered.shape[0]
    if n % 2:
        return ordered[n // 2]
    return (ordered[n // 2 - 1] + ordered[n // 2]) / 2


@_strategy
def init_to_median(site, num_samples=15):
    """Initialize to the median of ``num_samples`` prior draws."""
    if site["value"] is not None:
        warnings.warn(
            f"init_to_median() skipping initialization of site '{site['name']}'"
            " which already stores a value.",
            stacklevel=2,
        )
        return site["value"]
    sample_shape = tuple(site["kwargs"].get("sample_shape") or ())
    try:
        draws = site["fn"](
            rng_key=site["kwargs"].get("rng_key"), sample_shape=(num_samples,) + sample_shape
        )
    except NotImplementedError:
        return init_to_uniform(site)
    return _median0(draws)


@_strategy
def init_to_mean(site):
    """Initialize to the prior mean.  A site without a mean (one that raises
    ``NotImplementedError``, or one that holds a NaN, as a ``Cauchy``'s does)
    takes ``init_to_median``; the NaN is read on the host, since
    initialization runs outside any ``torch.func`` transform."""
    if site["value"] is not None:
        return site["value"]
    try:
        mean = site["fn"].mean
        if isinstance(mean, torch.Tensor) and bool(torch.isnan(mean).any()):
            raise NotImplementedError
    except NotImplementedError:
        return init_to_median(site)
    sample_shape = tuple(site["kwargs"].get("sample_shape") or ())
    if sample_shape:
        mean = mean.expand(sample_shape + tuple(mean.shape))
    return mean


def init_to_feasible(site=None):
    """Initialize to a feasible point: ``init_to_uniform`` of radius 0, the
    image of the unconstrained zero."""
    if site is None:
        return init_to_feasible
    return init_to_uniform(site, radius=0.0)


def init_to_value(site=None, values={}):
    """Initialize to the given values; a site missing from ``values`` takes
    ``init_to_uniform``."""
    if site is None:
        return functools.partial(init_to_value, values=values)
    if site["type"] == "sample" and not site["is_observed"]:
        if site["name"] in values:
            return values[site["name"]]
        return init_to_uniform(site)
    return None


def init_to_sample(site=None):
    """Initialize to a single prior sample: ``init_to_median`` of one draw,
    as in the JAX package, so that a site without a sampler (an
    ``ImproperUniform``) falls back to ``init_to_uniform``."""
    if site is None:
        return init_to_sample
    return init_to_median(site, num_samples=1)
