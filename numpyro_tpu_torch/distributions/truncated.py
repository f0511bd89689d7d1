"""Truncated distributions (port of ``numpyro_tpu/distributions/truncated.py``:
``LeftTruncatedDistribution``, ``RightTruncatedDistribution``,
``TwoSidedTruncatedDistribution``, the ``TruncatedDistribution``,
``TruncatedNormal`` and ``TruncatedCauchy`` factories,
``TruncatedPolyaGamma``, ``LowerTruncatedPowerLaw`` and
``DoublyTruncatedPowerLaw``).

As in the JAX package, the three truncation shapes share one base with a
"computation frame": a sign flip and a CDF window ``(w_lo, w_hi)``.  The flip
lets a left truncation right of the base's centre read its CDF in the
accurate left tail, so ``TruncatedNormal(low=5)`` stays finite.  A draw
inverts the base's CDF on a uniform rescaled to the window (``ndtri`` for a
Normal base), with no rejection loop.

One departure: the base is kept at its own batch shape and broadcast against
the bounds; the JAX package expands it to the joint shape, and then fails to
read its ``loc`` wherever the bounds are wider than the base.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from .continuous import Cauchy, Laplace, Logistic, Normal, StudentT
from .distribution import Distribution, _as_tensors
from .util import broadcast_shape, clamp_probs, lazy_property, standard_draw, standard_gamma

__all__ = [
    "DoublyTruncatedPowerLaw",
    "LeftTruncatedDistribution",
    "LowerTruncatedPowerLaw",
    "RightTruncatedDistribution",
    "TruncatedCauchy",
    "TruncatedDistribution",
    "TruncatedNormal",
    "TruncatedPolyaGamma",
    "TwoSidedTruncatedDistribution",
]

_WINDOWABLE = (Cauchy, Laplace, Logistic, Normal, StudentT)

_SQRT_2PI = 2.5066282746310002


def _gauss_pdf(t):
    """The standard normal density, 0 at +-inf."""
    finite = torch.isfinite(t)
    t_safe = torch.where(finite, t, 0.0)
    return torch.where(finite, torch.exp(-0.5 * t_safe**2) / _SQRT_2PI, 0.0)


def _t_gauss_pdf(t):
    """``t * pdf(t)``, 0 at +-inf."""
    finite = torch.isfinite(t)
    return torch.where(finite, torch.where(finite, t, 0.0) * _gauss_pdf(t), 0.0)


class _WindowTruncated(Distribution):
    """Truncation by a CDF window.  Subclasses define ``_frame_window() ->
    (sign, w_lo, w_hi)`` (the window in the possibly flipped frame) and
    ``_std_bounds() -> (a, b)`` (the standardized truncation points, +-inf
    allowed, for the Gaussian moments)."""

    def _bind_base(self, base_dist, **bounds):
        if not isinstance(base_dist, _WINDOWABLE):
            raise AssertionError(
                "The base distribution should be univariate and has real support."
            )
        bounds = _as_tensors({"_like": base_dist.loc} | bounds)
        bounds.pop("_like")
        batch = broadcast_shape(base_dist.batch_shape, *(tuple(v.shape) for v in bounds.values()))
        self.base_dist = base_dist
        for name, value in bounds.items():
            setattr(self, name, value)
        return batch

    has_rsample = True

    @property
    def support(self):
        return self._support

    def sample(self, key, sample_shape=()):
        u = standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape,
                          self.base_dist.loc)
        u = u.clamp(min=torch.finfo(u.dtype).tiny)
        sign, w_lo, w_hi = self._frame_window()
        draw = self.base_dist.icdf(clamp_probs(w_lo + u * (w_hi - w_lo)))
        loc = self.base_dist.loc
        return torch.where(sign > 0, draw, 2.0 * loc - draw)

    def log_prob(self, value):
        sign, w_lo, w_hi = self._frame_window()
        return self.base_dist.log_prob(value) - torch.log(sign * (w_hi - w_lo))

    def _gaussian_moments(self):
        a, b = self._std_bounds()
        loc, scale = self.base_dist.loc, self.base_dist.scale
        sign, w_lo, w_hi = self._frame_window()
        mass = sign * (w_hi - w_lo)
        dpdf = (_gauss_pdf(a) - _gauss_pdf(b)) / mass
        mean = loc + scale * dpdf
        shape_term = (_t_gauss_pdf(a) - _t_gauss_pdf(b)) / mass
        var = scale**2 * (1.0 + shape_term - dpdf**2)
        return mean, var

    def _nan(self):
        return torch.full(self.batch_shape, math.nan, dtype=self.base_dist.loc.dtype,
                          device=self.base_dist.loc.device)

    @property
    def mean(self):
        if isinstance(self.base_dist, Normal):
            return self._gaussian_moments()[0]
        if isinstance(self.base_dist, Cauchy):
            return self._nan()
        raise NotImplementedError("mean only available for Normal and Cauchy")

    @property
    def variance(self):
        if isinstance(self.base_dist, Normal):
            return self._gaussian_moments()[1]
        if isinstance(self.base_dist, Cauchy):
            return self._nan()
        raise NotImplementedError("variance only available for Normal and Cauchy")


class LeftTruncatedDistribution(_WindowTruncated):
    reparametrized_params = ["low"]

    def __init__(self, base_dist, low=0.0, *, validate_args=None):
        batch = self._bind_base(base_dist, low=low)
        self._support = constraints.greater_than(self.low)
        super().__init__(batch, validate_args=validate_args)

    @lazy_property
    def _frame(self):
        # flip a symmetric base wherever low lies right of loc, so that the
        # truncation point is read in the accurate left tail
        loc = self.base_dist.loc
        sign = torch.where(loc >= self.low, 1.0, -1.0).to(loc.dtype)
        w_lo = self.base_dist.cdf(loc - sign * (loc - self.low))
        w_hi = torch.where(sign > 0, 1.0, 0.0).to(loc.dtype)
        return sign, w_lo, w_hi

    def _frame_window(self):
        return self._frame

    def _std_bounds(self):
        a = (self.low - self.base_dist.loc) / self.base_dist.scale
        return a, torch.full_like(a, math.inf)


class RightTruncatedDistribution(_WindowTruncated):
    reparametrized_params = ["high"]

    def __init__(self, base_dist, high=0.0, *, validate_args=None):
        batch = self._bind_base(base_dist, high=high)
        self._support = constraints.less_than(self.high)
        super().__init__(batch, validate_args=validate_args)

    @lazy_property
    def _upper_mass(self):
        return self.base_dist.cdf(self.high)

    def _frame_window(self):
        ceiling = self._upper_mass
        return torch.ones_like(ceiling), torch.zeros_like(ceiling), ceiling

    def _std_bounds(self):
        b = (self.high - self.base_dist.loc) / self.base_dist.scale
        return torch.full_like(b, -math.inf), b


class TwoSidedTruncatedDistribution(_WindowTruncated):
    reparametrized_params = ["low", "high"]

    def __init__(self, base_dist, low=0.0, high=1.0, *, validate_args=None):
        batch = self._bind_base(base_dist, low=low, high=high)
        self._support = constraints.interval(self.low, self.high)
        super().__init__(batch, validate_args=validate_args)

    @lazy_property
    def _window(self):
        return self.base_dist.cdf(self.low), self.base_dist.cdf(self.high)

    def _frame_window(self):
        w_lo, w_hi = self._window
        return torch.ones_like(w_lo), w_lo, w_hi

    def _std_bounds(self):
        loc, scale = self.base_dist.loc, self.base_dist.scale
        return (self.low - loc) / scale, (self.high - loc) / scale


def TruncatedDistribution(base_dist, low=None, high=None, *, validate_args=None):
    """The truncation of ``base_dist`` to the bounds that are given."""
    kind = (low is not None, high is not None)
    if kind == (False, False):
        return base_dist
    if kind == (True, False):
        return LeftTruncatedDistribution(base_dist, low=low, validate_args=validate_args)
    if kind == (False, True):
        return RightTruncatedDistribution(base_dist, high=high, validate_args=validate_args)
    return TwoSidedTruncatedDistribution(base_dist, low=low, high=high,
                                         validate_args=validate_args)


def TruncatedNormal(loc=0.0, scale=1.0, *, low=None, high=None, validate_args=None):
    return TruncatedDistribution(Normal(loc, scale), low=low, high=high,
                                 validate_args=validate_args)


def TruncatedCauchy(loc=0.0, scale=1.0, *, low=None, high=None, validate_args=None):
    return TruncatedDistribution(Cauchy(loc, scale), low=low, high=high,
                                 validate_args=validate_args)


class TruncatedPolyaGamma(Distribution):
    """Polya-Gamma PG(1, 0) truncated to (0, 2.5], with a log density of a
    fixed number of series terms.  A draw weighs ``num_gamma_variates``
    standard gamma draws of shape 1, made with the batch dims before the
    sample dims, as the JAX package makes them."""

    truncation_point = 2.5
    num_log_prob_terms = 7
    num_gamma_variates = 8
    support = constraints.interval(0.0, truncation_point)
    has_rsample = True

    def __init__(self, batch_shape=(), *, validate_args=None):
        super().__init__(batch_shape, validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        like = torch.zeros((), device=key.device if isinstance(key, torch.Generator) else None)
        shape = self.batch_shape + tuple(sample_shape) + (self.num_gamma_variates,)
        odd_halves = torch.arange(0.5, self.num_gamma_variates, dtype=like.dtype,
                                  device=like.device)
        weights = 0.5 / (math.pi * odd_halves) ** 2
        gammas = standard_gamma(key, torch.ones(shape, dtype=like.dtype, device=like.device))
        return (gammas * weights).sum(-1).clamp(max=self.truncation_point)

    def log_prob(self, value):
        # the alternating series: log f = log(sum_even - sum_odd) - log sqrt(2 pi)
        x = value[..., None]
        n = torch.arange(self.num_log_prob_terms, dtype=value.dtype, device=value.device)
        coef = 2.0 * n + 1.0
        terms = torch.log(coef) - 1.5 * torch.log(x) - 0.125 * coef**2 / x
        pos = torch.exp(torch.logsumexp(terms[..., 0::2], -1))
        neg = torch.exp(torch.logsumexp(terms[..., 1::2], -1))
        return torch.log(pos - neg) - 0.5 * math.log(2.0 * math.pi)


class LowerTruncatedPowerLaw(Distribution):
    """The power law x^alpha on [low, inf), alpha < -1."""

    has_rsample = True
    reparametrized_params = ["alpha", "low"]

    def __init__(self, alpha, low, *, validate_args=None):
        self._init_broadcast(validate_args, alpha=alpha, low=low)
        self._support = constraints.greater_than(self.low)

    @property
    def support(self):
        return self._support

    def _tail_exponent(self):
        """-(1 + alpha) > 0, the decay exponent of the survival function."""
        return -(1.0 + self.alpha)

    def log_prob(self, value):
        decay = self._tail_exponent()
        return self.alpha * torch.log(value) + torch.log(decay) + decay * torch.log(self.low)

    def cdf(self, value):
        survival = torch.pow(value / self.low, -self._tail_exponent())
        return torch.where(value <= self.low, 0.0, 1.0 - survival)

    def icdf(self, q):
        bad = torch.isnan(q) | (q < 0.0) | (q > 1.0)
        root = torch.pow(1.0 - q, -1.0 / self._tail_exponent())
        return torch.where(bad, math.nan, self.low * root)

    def sample(self, key, sample_shape=()):
        return self.icdf(standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape,
                                       self.alpha))

    def _raw_moment(self, k):
        decay = self._tail_exponent()
        value = decay / (decay - k) * torch.pow(self.low, k)
        return torch.where(k < decay, value, math.inf)

    @property
    def mean(self):
        return self._raw_moment(1.0)

    @property
    def variance(self):
        m1, m2 = self._raw_moment(1.0), self._raw_moment(2.0)
        return torch.where(torch.isfinite(m2), m2 - m1**2, math.inf)


class DoublyTruncatedPowerLaw(Distribution):
    """The power law x^alpha on [low, high].  At alpha == -1 the masked
    branch ("double where") keeps both branches and their gradients free of
    NaN, as in the JAX package."""

    has_rsample = True
    reparametrized_params = ["alpha", "low", "high"]

    def __init__(self, alpha, low, high, *, validate_args=None):
        self._init_broadcast(validate_args, alpha=alpha, low=low, high=high)
        self._support = constraints.interval(self.low, self.high)

    @property
    def support(self):
        return self._support

    def _regular_exponent(self):
        """(is_regular, 1 + alpha with the -1 singularity masked to 1)."""
        regular = self.alpha != -1.0
        return regular, torch.where(regular, 1.0 + self.alpha, 1.0)

    def log_prob(self, value):
        regular, expo = self._regular_exponent()
        norm_reg = (torch.pow(self.high, expo) - torch.pow(self.low, expo)) / expo
        norm_log = torch.log(self.high) - torch.log(self.low)
        safe_alpha = torch.where(regular, self.alpha, -1.0)
        return safe_alpha * torch.log(value) - torch.log(torch.where(regular, norm_reg, norm_log))

    def cdf(self, value):
        regular, expo = self._regular_exponent()
        lo_p, hi_p = torch.pow(self.low, expo), torch.pow(self.high, expo)
        frac_reg = (torch.pow(value, expo) - lo_p) / (hi_p - lo_p)
        frac_log = torch.log(value / self.low) / torch.log(self.high / self.low)
        return torch.clamp(torch.where(regular, frac_reg, frac_log), 0.0, 1.0)

    def icdf(self, q):
        regular, expo = self._regular_exponent()
        lo_p, hi_p = torch.pow(self.low, expo), torch.pow(self.high, expo)
        inv_reg = torch.pow(lo_p + q * (hi_p - lo_p), 1.0 / expo)
        inv_log = self.low * torch.pow(self.high / self.low, q)
        return torch.where(regular, inv_reg, inv_log)

    def sample(self, key, sample_shape=()):
        return self.icdf(standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape,
                                       self.alpha))
