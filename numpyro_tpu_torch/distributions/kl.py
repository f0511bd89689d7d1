"""Analytic KL divergences (port of the parts of
``numpyro_tpu/distributions/kl.py`` that ``TraceMeanField_ELBO`` reaches on
the ported models: the expanded, independent, masked and delta combinators,
Normal/Normal, MultivariateNormal/MultivariateNormal, Beta/Beta,
Gamma/Gamma, Dirichlet/Dirichlet, Categorical/Categorical by probs and by
logits, Weibull/Gamma, Kumaraswamy/Beta and an independent Normal against a
CirculantNormal).  As in the JAX
package, Delta against an expanded distribution counts the Delta's
``log_density``, and Delta against any other distribution does not.

Dispatch is a ``(type, type)`` registry walked over the MRO; a pair with no
entry raises ``NotImplementedError``, which ``TraceMeanField_ELBO`` takes as
the signal to use a Monte Carlo term instead.
"""

from __future__ import annotations

import torch

from .continuous import (
    Beta,
    CirculantNormal,
    Dirichlet,
    Gamma,
    Kumaraswamy,
    MultivariateNormal,
    Normal,
    Weibull,
)
from .discrete import CategoricalLogits, CategoricalProbs
from .distribution import (
    Delta,
    Distribution,
    ExpandedDistribution,
    Independent,
    MaskedDistribution,
)
from .util import betaln, broadcast_shape, sum_rightmost

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


@register_kl(Beta, Beta)
def _kl_beta_beta(p, q):
    a1, b1 = p.concentration1, p.concentration0
    a2, b2 = q.concentration1, q.concentration0
    t1 = betaln(a2, b2) - betaln(a1, b1)
    t2 = (a1 - a2) * torch.digamma(a1) + (b1 - b2) * torch.digamma(b1)
    t3 = (a2 - a1 + b2 - b1) * torch.digamma(a1 + b1)
    return t1 + t2 + t3


@register_kl(Gamma, Gamma)
def _kl_gamma_gamma(p, q):
    a1, b1 = p.concentration, p.rate
    a2, b2 = q.concentration, q.rate
    t1 = a2 * torch.log(b1 / b2) + torch.lgamma(a2) - torch.lgamma(a1)
    t2 = (a1 - a2) * torch.digamma(a1)
    t3 = a1 * (b2 / b1 - 1)
    return t1 + t2 + t3


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet_dirichlet(p, q):
    a, b = p.concentration, q.concentration
    a0 = a.sum(-1)
    return (torch.lgamma(a0) - torch.lgamma(a).sum(-1) - torch.lgamma(b.sum(-1))
            + torch.lgamma(b).sum(-1)
            + ((a - b) * (torch.digamma(a) - torch.digamma(a0)[..., None])).sum(-1))


@register_kl(CategoricalProbs, CategoricalProbs)
def _kl_cat_cat(p, q):
    return (p.probs * (torch.log(p.probs) - torch.log(q.probs))).sum(-1)


@register_kl(CategoricalLogits, CategoricalLogits)
def _kl_catlogits_catlogits(p, q):
    p_logp = p.logits - torch.logsumexp(p.logits, -1, keepdim=True)
    q_logp = q.logits - torch.logsumexp(q.logits, -1, keepdim=True)
    return (torch.exp(p_logp) * (p_logp - q_logp)).sum(-1)


@register_kl(Weibull, Gamma)
def _kl_weibull_gamma(p, q):
    a, b = p.concentration, p.scale
    euler = 0.5772156649015329
    t1 = -q.concentration * torch.log(q.rate) + torch.lgamma(q.concentration)
    # E_p[log p] = log(a / b) - gamma (1 - 1 / a) - 1, the negative Weibull entropy
    t2 = torch.log(a / b) - euler * (1 - 1 / a) - 1
    t3 = q.rate * b * torch.exp(torch.lgamma(1 + 1 / a))
    t4 = -(q.concentration - 1) * (torch.log(b) - euler / a)
    return t1 + t2 + t3 + t4


@register_kl(Kumaraswamy, Beta)
def _kl_kumaraswamy_beta(p, q):
    """The truncated Taylor series of arXiv:1605.06197, Eq. (12), of
    ``p.KL_KUMARASWAMY_BETA_TAYLOR_ORDER`` terms."""
    taylor_order = getattr(p, "KL_KUMARASWAMY_BETA_TAYLOR_ORDER", 10)
    a, b = p.concentration1, p.concentration0
    alpha, beta = q.concentration1, q.concentration0
    b_reciprocal = 1.0 / b
    a_b = a * b
    t1 = (alpha / a - 1) * (0.5772156649015329 + torch.digamma(b) + b_reciprocal)
    t2 = torch.log(a_b) + betaln(alpha, beta) + (b_reciprocal - 1)
    m = torch.arange(1, taylor_order + 1, dtype=a.dtype, device=a.device)
    t3 = (beta - 1) * b * (torch.exp(betaln(m / a[..., None], b[..., None]))
                           / (m + a_b[..., None])).sum(-1)
    return t1 + t2 + t3


@register_kl(Independent, CirculantNormal)
def _kl_independent_normal_circulant(p, q):
    """KL(N(mu, diag) || CirculantNormal) in O(n log n) by the real FFT."""
    if not isinstance(p.base_dist, Normal) or p.reinterpreted_batch_ndims != 1:
        raise NotImplementedError(
            "KL(Independent || CirculantNormal) takes an Independent Normal of one event dim")
    residual = q.mean - p.mean
    n = residual.shape[-1]
    log_cov_rfft = torch.log(q.covariance_rfft)
    quad = (residual * torch.fft.irfft(torch.fft.rfft(residual) / q.covariance_rfft, n)).sum(-1)
    return (quad + torch.fft.irfft(1 / q.covariance_rfft, n)[..., 0] * p.variance.sum(-1)
            + log_cov_rfft.sum(-1) + log_cov_rfft[..., 1: (n + 1) // 2].sum(-1)
            - torch.log(p.variance).sum(-1) - n) / 2
