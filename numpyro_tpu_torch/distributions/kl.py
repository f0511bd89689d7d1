"""Analytic KL divergences (port of the parts of
``numpyro_tpu/distributions/kl.py`` that ``TraceMeanField_ELBO`` reaches on
the ported models: the expanded, independent, masked and delta combinators,
Normal/Normal and MultivariateNormal/MultivariateNormal).  As in the JAX
package, Delta against an expanded distribution counts the Delta's
``log_density``, and Delta against any other distribution does not.

Dispatch is a ``(type, type)`` registry walked over the MRO; a pair with no
entry raises ``NotImplementedError``, which ``TraceMeanField_ELBO`` takes as
the signal to use a Monte Carlo term instead.
"""

from __future__ import annotations

import torch

from .continuous import MultivariateNormal, Normal
from .distribution import (
    Delta,
    Distribution,
    ExpandedDistribution,
    Independent,
    MaskedDistribution,
)
from .util import broadcast_shape, sum_rightmost

__all__ = ["kl_divergence", "register_kl"]

_KL_REGISTRY = {}


def register_kl(type_p, type_q):
    def decorator(fn):
        _KL_REGISTRY[(type_p, type_q)] = fn
        return fn

    return decorator


def _dispatch_kl(type_p, type_q):
    matches = [
        (p, q) for (p, q) in _KL_REGISTRY if issubclass(type_p, p) and issubclass(type_q, q)
    ]
    if not matches:
        return None
    # the most specific match: the least MRO distance
    return _KL_REGISTRY[
        min(matches, key=lambda pair: (type_p.__mro__.index(pair[0]),
                                       type_q.__mro__.index(pair[1])))
    ]


def kl_divergence(p, q):
    fn = _dispatch_kl(type(p), type(q))
    if fn is None:
        raise NotImplementedError(
            f"No KL(p || q) registered for p={type(p).__name__}, q={type(q).__name__}"
        )
    return fn(p, q)


def _broadcast_kl(kl, p, q):
    return torch.broadcast_to(kl, broadcast_shape(p.batch_shape, q.batch_shape))


@register_kl(Distribution, ExpandedDistribution)
def _kl_dist_expanded(p, q):
    return _broadcast_kl(kl_divergence(p, q.base_dist), p, q)


@register_kl(ExpandedDistribution, Distribution)
def _kl_expanded(p, q):
    return _broadcast_kl(kl_divergence(p.base_dist, q), p, q)


@register_kl(ExpandedDistribution, ExpandedDistribution)
def _kl_expanded_expanded(p, q):
    return _broadcast_kl(kl_divergence(p.base_dist, q.base_dist), p, q)


@register_kl(Delta, Distribution)
def _kl_delta(p, q):
    return -q.log_prob(p.v)


@register_kl(Delta, ExpandedDistribution)
def _kl_delta_expanded(p, q):
    return -q.log_prob(p.v) + p.log_density


@register_kl(Independent, Independent)
def _kl_independent_independent(p, q):
    shared = min(p.reinterpreted_batch_ndims, q.reinterpreted_batch_ndims)
    p_ndims = p.reinterpreted_batch_ndims - shared
    q_ndims = q.reinterpreted_batch_ndims - shared
    p_ = Independent(p.base_dist, p_ndims) if p_ndims else p.base_dist
    q_ = Independent(q.base_dist, q_ndims) if q_ndims else q.base_dist
    return sum_rightmost(kl_divergence(p_, q_), shared)


@register_kl(MaskedDistribution, MaskedDistribution)
def _kl_masked_masked(p, q):
    if isinstance(p._mask, bool) and isinstance(q._mask, bool):
        if p._mask and q._mask:
            return kl_divergence(p.base_dist, q.base_dist)
        return torch.zeros(broadcast_shape(p.batch_shape, q.batch_shape))
    mask = torch.as_tensor(p._mask) & torch.as_tensor(q._mask)
    kl = kl_divergence(p.base_dist, q.base_dist)
    return torch.where(mask, kl, torch.zeros_like(kl))


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    var_ratio = (p.scale / q.scale) ** 2
    t1 = ((p.loc - q.loc) / q.scale) ** 2
    return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


@register_kl(MultivariateNormal, MultivariateNormal)
def _kl_mvn_mvn(p, q):
    d = p.event_shape[-1]
    p_half_logdet = torch.log(torch.diagonal(p.scale_tril, dim1=-2, dim2=-1)).sum(-1)
    q_half_logdet = torch.log(torch.diagonal(q.scale_tril, dim1=-2, dim2=-1)).sum(-1)
    shape = broadcast_shape(tuple(p.scale_tril.shape), tuple(q.scale_tril.shape))
    lq_inv_lp = torch.linalg.solve_triangular(
        torch.broadcast_to(q.scale_tril, shape), torch.broadcast_to(p.scale_tril, shape),
        upper=False,
    )
    tr = (lq_inv_lp**2).sum((-2, -1))
    diff = q.loc - p.loc
    diff = torch.broadcast_to(diff, broadcast_shape(tuple(diff.shape), tuple(q.loc.shape)))
    lq = torch.broadcast_to(
        q.scale_tril, broadcast_shape(tuple(q.scale_tril.shape), tuple(diff.shape) + (d,))
    )
    lq_inv_diff = torch.linalg.solve_triangular(
        lq, torch.broadcast_to(diff, tuple(lq.shape[:-1]))[..., None], upper=False
    )
    mahalanobis = (lq_inv_diff[..., 0] ** 2).sum(-1)
    return 0.5 * (tr + mahalanobis - d) + q_half_logdet - p_half_logdet
