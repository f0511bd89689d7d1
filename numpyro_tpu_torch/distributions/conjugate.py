"""Compound (conjugate-mixture) distributions (port of
``numpyro_tpu/distributions/conjugate.py``: ``BetaBinomial``,
``DirichletMultinomial``, ``GammaPoisson`` and the negative binomials).

Densities are the JAX classes' formulas, each binomial-type coefficient one
``betaln`` away (``C(n, k) = 1 / ((n + 1) B(n - k + 1, k + 1))``).  A draw
first draws the mixing variable (a Beta, Dirichlet or Gamma draw,
reparameterised through ``util.standard_gamma``), then the counts at it
(``util.binomial``, ``util.multinomial``, ``util.poisson``), as the JAX
package does."""

from __future__ import annotations

import torch

from . import constraints
from .continuous import Beta, Dirichlet
from .discrete import (
    BinomialProbs,
    MultinomialProbs,
    _gamma_poisson_draw,
    _log_binom_coeff,
    _with_category_axis,
)
from .distribution import Distribution, _as_tensors
from .transforms import _softplus
from .util import betainc, betaln, promote_shapes

__all__ = [
    "BetaBinomial", "DirichletMultinomial", "GammaPoisson", "NegativeBinomial",
    "NegativeBinomialLogits", "NegativeBinomialProbs",
]

_POS = constraints.positive
_NN_INT = constraints.nonnegative_integer


class BetaBinomial(Distribution):
    """A Binomial whose success probability is Beta-distributed."""

    arg_constraints = {"concentration1": _POS, "concentration0": _POS, "total_count": _NN_INT}
    has_enumerate_support = True
    enumerate_support = BinomialProbs.enumerate_support

    def __init__(self, concentration1, concentration0, total_count=1, *, validate_args=None):
        self._init_broadcast(validate_args, concentration1=concentration1,
                             concentration0=concentration0, total_count=total_count)

    def sample(self, key, sample_shape=()):
        p = Beta(self.concentration1, self.concentration0).sample(key, sample_shape)
        return BinomialProbs(p, total_count=self.total_count).sample(key)

    def log_prob(self, value):
        a, b, n = self.concentration1, self.concentration0, self.total_count
        posterior = betaln(value + a, n - value + b)
        return _log_binom_coeff(n, value) + posterior - betaln(a, b)

    @property
    def mean(self):
        return self.total_count * self.concentration1 / (self.concentration1 + self.concentration0)

    @property
    def variance(self):
        a, b, n = self.concentration1, self.concentration0, self.total_count
        s = a + b
        return n * (a / s) * (b / s) * (s + n) / (s + 1.0)

    @property
    def support(self):
        return constraints.integer_interval(0, self.total_count)


class DirichletMultinomial(Distribution):
    """A Multinomial whose probability vector is Dirichlet-distributed."""

    arg_constraints = {"concentration": constraints.independent(_POS, 1),
                       "total_count": _NN_INT}

    def __init__(self, concentration, total_count=1, *, validate_args=None):
        concentration = _with_category_axis(concentration, "concentration")
        self._init_broadcast(validate_args, event_shape=tuple(concentration.shape[-1:]),
                             event_dims={"concentration": 1}, concentration=concentration,
                             total_count=total_count)

    def sample(self, key, sample_shape=()):
        p = Dirichlet(self.concentration).sample(key, sample_shape)
        counts = torch.broadcast_to(self.total_count, tuple(sample_shape) + self.batch_shape)
        return MultinomialProbs(p, total_count=counts).sample(key)

    def log_prob(self, value):
        alpha = self.concentration
        a_tot = alpha.sum(-1)
        n = self.total_count * 1.0
        log_coeff = torch.lgamma(n + 1.0) - torch.lgamma(value + 1.0).sum(-1)
        per_cat = (torch.lgamma(value + alpha) - torch.lgamma(alpha)).sum(-1)
        return log_coeff + per_cat + torch.lgamma(a_tot) - torch.lgamma(n + a_tot)

    @property
    def mean(self):
        share = self.concentration / self.concentration.sum(-1, keepdim=True)
        return self.total_count.unsqueeze(-1) * share

    @property
    def variance(self):
        a_tot = self.concentration.sum(-1, keepdim=True)
        share = self.concentration / a_tot
        n = self.total_count.unsqueeze(-1)
        return n * share * (1.0 - share) * (n + a_tot) / (1.0 + a_tot)

    @property
    def support(self):
        return constraints.multinomial(self.total_count)


class GammaPoisson(Distribution):
    """A Poisson whose rate is Gamma-distributed (a negative binomial)."""

    arg_constraints = {"concentration": _POS, "rate": _POS}
    support = _NN_INT

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, rate=rate)

    def sample(self, key, sample_shape=()):
        return _gamma_poisson_draw(key, self.concentration, self.rate, sample_shape)

    def log_prob(self, value):
        a, beta = self.concentration, self.rate
        log_coeff = -torch.log(a + value) - betaln(a, value + 1.0)
        return log_coeff + a * torch.log(beta) - (a + value) * torch.log1p(beta)

    @property
    def mean(self):
        return self.concentration / self.rate

    @property
    def variance(self):
        return self.mean * (1.0 + self.rate) / self.rate

    def cdf(self, value):
        return betainc(self.concentration, value + 1.0, self.rate / (1.0 + self.rate))


class NegativeBinomialProbs(GammaPoisson):
    """The negative binomial by its success probability, as a Gamma-Poisson
    mixture."""

    arg_constraints = {"total_count": _POS, "probs": constraints.unit_interval}

    def __init__(self, total_count, probs, *, validate_args=None):
        params = _as_tensors({"total_count": total_count, "probs": probs})
        self.total_count, self.probs = promote_shapes(params["total_count"], params["probs"])
        odds_against = (1.0 - params["probs"]) / params["probs"]
        super().__init__(params["total_count"], odds_against, validate_args=validate_args)


class NegativeBinomialLogits(GammaPoisson):
    """The negative binomial by its logits."""

    arg_constraints = {"total_count": _POS, "logits": constraints.real}

    def __init__(self, total_count, logits, *, validate_args=None):
        params = _as_tensors({"total_count": total_count, "logits": logits})
        self.total_count, self.logits = promote_shapes(params["total_count"], params["logits"])
        super().__init__(params["total_count"], torch.exp(-params["logits"]),
                         validate_args=validate_args)

    def log_prob(self, value):
        n, logit = self.total_count * 1.0, self.logits
        log_coeff = -torch.log(n + value) - betaln(n, value + 1.0)
        # k log sigmoid(logit) + n log sigmoid(-logit), stably
        return log_coeff - value * _softplus(-logit) - n * _softplus(logit)


def NegativeBinomial(total_count, probs=None, logits=None, *, validate_args=None):
    if probs is not None:
        return NegativeBinomialProbs(total_count, probs, validate_args=validate_args)
    if logits is not None:
        return NegativeBinomialLogits(total_count, logits, validate_args=validate_args)
    raise ValueError("One of `probs` or `logits` must be specified.")
