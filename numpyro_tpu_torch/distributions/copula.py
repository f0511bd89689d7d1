"""Gaussian copulas (port of ``numpyro_tpu/distributions/copula.py``):
``GaussianCopula`` couples the last batch axis of a univariate marginal
through a correlation matrix, and ``GaussianCopulaBeta`` takes Beta
marginals.

The density goes through the probability integral transform: the
marginal's ``cdf``, then the standard normal quantile (``ndtri``), then the
correlated normal density over the independent one, from one triangular
solve.  A draw maps correlated normals back through the normal CDF (the
JAX package's ``ndtr`` formula) and the marginal's ``icdf``.  A correlation
matrix that is not positive definite gives a NaN factor, as in the JAX
package.
"""

from __future__ import annotations

import torch

from . import constraints
from .continuous import Beta, _ndtr
from .distribution import Distribution
from .util import (
    broadcast_shape, cholesky, clamp_probs, lazy_property, standard_draw, validate_sample,
)

__all__ = ["GaussianCopula", "GaussianCopulaBeta"]


class GaussianCopula(Distribution):
    """A joint distribution with ``marginal_dist`` marginals (coupled along
    their last batch axis) and a Gaussian copula of ``correlation_matrix``
    (or of its Cholesky factor ``correlation_cholesky``)."""

    arg_constraints = {"correlation_matrix": constraints.corr_matrix,
                       "correlation_cholesky": constraints.corr_cholesky}
    has_rsample = True
    reparametrized_params = ["correlation_matrix", "correlation_cholesky"]

    def __init__(self, marginal_dist, correlation_matrix=None, correlation_cholesky=None, *,
                 validate_args=None):
        if marginal_dist.event_shape != ():
            raise ValueError("`marginal_dist` needs to be a univariate distribution.")
        if (correlation_matrix is None) == (correlation_cholesky is None):
            raise ValueError(
                "exactly one of correlation_matrix / correlation_cholesky is required")
        if correlation_cholesky is None:
            correlation_cholesky = cholesky(correlation_matrix)
        self.marginal_dist = marginal_dist
        self.scale_tril = correlation_cholesky
        dim = correlation_cholesky.shape[-1]
        batch = broadcast_shape(tuple(marginal_dist.batch_shape[:-1]),
                                tuple(correlation_cholesky.shape[:-2]))
        super().__init__(batch, (dim,), validate_args=validate_args)

    def _to_quantiles(self, value):
        return torch.special.ndtri(clamp_probs(self.marginal_dist.cdf(value)))

    def sample(self, key, sample_shape=()):
        eps = standard_draw(key, "normal", self.shape(sample_shape), self.scale_tril)
        correlated = (self.scale_tril @ eps[..., None])[..., 0]
        return self.marginal_dist.icdf(_ndtr(correlated))

    @validate_sample
    def log_prob(self, value):
        q = self._to_quantiles(value)
        # N(q; 0, L L^T) / prod_i N(q_i; 0, 1): the normalisers cancel but
        # for the log-determinant
        n = q.shape[-1]
        tril = torch.broadcast_to(self.scale_tril, tuple(q.shape[:-1]) + (n, n))
        white = torch.linalg.solve_triangular(tril, q[..., None], upper=False)[..., 0]
        half_quad_delta = 0.5 * (q.square().sum(-1) - white.square().sum(-1))
        logdet = torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)).sum(-1)
        return self.marginal_dist.log_prob(value).sum(-1) + half_quad_delta - logdet

    @property
    def mean(self):
        return torch.broadcast_to(self.marginal_dist.mean, self.shape())

    @property
    def variance(self):
        return torch.broadcast_to(self.marginal_dist.variance, self.shape())

    @property
    def support(self):
        return constraints.independent(self.marginal_dist.support, 1)

    @lazy_property
    def correlation_matrix(self):
        return self.scale_tril @ self.scale_tril.transpose(-2, -1)

    @lazy_property
    def correlation_cholesky(self):
        return self.scale_tril


class GaussianCopulaBeta(GaussianCopula):
    """Beta marginals under a Gaussian copula; the marginals' ``cdf`` is
    ``util.betainc`` (float64 inside) and their ``icdf`` bisects."""

    arg_constraints = {"concentration1": constraints.positive,
                       "concentration0": constraints.positive,
                       "correlation_matrix": constraints.corr_matrix,
                       "correlation_cholesky": constraints.corr_cholesky}
    has_rsample = False
    support = constraints.independent(constraints.unit_interval, 1)

    def __init__(self, concentration1, concentration0, correlation_matrix=None,
                 correlation_cholesky=None, *, validate_args=False):
        marginals = Beta(concentration1, concentration0)
        self.concentration1 = marginals.concentration1
        self.concentration0 = marginals.concentration0
        super().__init__(marginals, correlation_matrix, correlation_cholesky,
                         validate_args=validate_args)
