"""Continuous distributions (port of ``numpyro_tpu/distributions/continuous.py``:
the location-scale families ``Normal``, ``Cauchy``, ``Laplace``, ``Gumbel``,
``Logistic``, ``SoftLaplace`` and ``StudentT``; ``HalfCauchy`` and
``HalfNormal``; ``Uniform``, ``Exponential``, ``Gamma``, ``Chi2``,
``InverseGamma``, ``Beta``, ``BetaProportion``, ``Dirichlet``, ``LogNormal``,
``LogUniform``, ``AsymmetricLaplace``, ``AsymmetricLaplaceQuantile``,
``Pareto``, ``Weibull``, ``Kumaraswamy``, ``Gompertz``, ``Levy`` and
``RelaxedBernoulliLogits``/``RelaxedBernoulli``; ``MultivariateNormal``,
``LowRankMultivariateNormal`` and ``GaussianRandomWalk``.  The rest are
listed in ROADMAP.md).

As in the JAX package, the location-scale families derive from ``_LocScale``,
which owns the affine bookkeeping, and each family supplies its standardized
kernel; the half distributions fold a zero-centred family at zero.  Every
formula is the JAX class's, written out (``torch.distributions`` differs in
parameterisations, clamps and supports).

A sampler takes a ``torch.Generator`` or a draw source (``util.standard_draw``,
``util.standard_gamma``): a draw is made on the device of its generator, where
0-dim parameters (a Python number becomes one on the CPU) broadcast as they
are.  Gamma, Chi2, InverseGamma, Beta and Dirichlet draw with
``torch._standard_gamma``, reparameterised in the concentration; it has no
forward-mode derivative, and a draw under forward mode raises naming the
site.  A covariance or precision matrix that is not positive definite gives a
NaN factor and a NaN ``log_prob``, as in the JAX package, and never raises.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution, TransformedDistribution, _as_tensors
from .transforms import AffineTransform, ExpTransform, PowerTransform, SigmoidTransform, _softplus
from .util import (
    betainc,
    betaincinv,
    betaln,
    broadcast_shape,
    cholesky,
    clamp_probs,
    gammainc,
    gammaincinv,
    lazy_property,
    promote_shapes,
    standard_draw,
    standard_gamma,
)

__all__ = [
    "AsymmetricLaplace", "AsymmetricLaplaceQuantile", "Beta", "BetaProportion", "Cauchy", "Chi2",
    "Dirichlet", "Exponential", "Gamma", "GaussianRandomWalk", "Gompertz", "Gumbel",
    "HalfCauchy", "HalfNormal", "InverseGamma", "Kumaraswamy", "Laplace", "Levy", "LogNormal",
    "LogUniform", "Logistic", "LowRankMultivariateNormal", "MultivariateNormal", "Normal",
    "Pareto", "RelaxedBernoulli", "RelaxedBernoulliLogits", "SoftLaplace", "StudentT",
    "Uniform", "Weibull",
]

_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
_LOG_2 = 0.6931471805599453
_EULER = 0.5772156649015329
_SQRT_HALF = math.sqrt(0.5)


def _ndtr(x):
    """The standard normal CDF as the JAX package computes it, from ``erf``
    near 0 and ``erfc`` in the tails (PyTorch's float32 ``ndtr`` is 4%
    off at -5 and 0 below -5.5)."""
    t = x * _SQRT_HALF
    z = t.abs()
    tails = torch.where(t > 0, 2.0 - torch.special.erfc(z), torch.special.erfc(z))
    return 0.5 * torch.where(z < _SQRT_HALF, 1.0 + torch.special.erf(t), tails)


class _LocScale(Distribution):
    """x = loc + scale * z for a fixed standardized kernel z; a family names
    the kind of its standard draw (``_z_kind``) or overrides ``_z_sample``."""

    support = constraints.real
    has_rsample = True
    reparametrized_params = ["loc", "scale"]
    # standardized moments (None: undefined)
    _z_mean = 0.0
    _z_var = 1.0

    def __init__(self, loc=0.0, scale=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale)

    def _standardize(self, x):
        return (x - self.loc) / self.scale

    def _z_sample(self, key, shape):
        return standard_draw(key, self._z_kind, shape, self.loc)

    def sample(self, key, sample_shape=()):
        z = self._z_sample(key, self.shape(sample_shape))
        return self.loc + self.scale * z

    def log_prob(self, value):
        return self._z_log_density(self._standardize(value)) - torch.log(self.scale)

    def cdf(self, value):
        return self._z_cdf(self._standardize(value))

    def icdf(self, q):
        return self.loc + self.scale * self._z_icdf(q)

    @property
    def mean(self):
        if self._z_mean is None:
            return torch.full(self.batch_shape, math.nan, device=self.loc.device)
        return torch.broadcast_to(self.loc + self.scale * self._z_mean, self.batch_shape)

    @property
    def variance(self):
        if self._z_var is None:
            return torch.full(self.batch_shape, math.nan, device=self.loc.device)
        return torch.broadcast_to(self.scale**2 * self._z_var, self.batch_shape)

    def _z_entropy(self):
        raise NotImplementedError(f"{type(self).__name__}.entropy")

    def entropy(self):
        return torch.broadcast_to(self._z_entropy() + torch.log(self.scale), self.batch_shape)


class Normal(_LocScale):
    _z_kind = "normal"

    def _z_log_density(self, z):
        return -0.5 * z * z - _LOG_SQRT_2PI

    def _z_cdf(self, z):
        return _ndtr(z)

    def _z_icdf(self, q):
        return torch.special.ndtri(q)

    def log_cdf(self, value):
        return torch.special.log_ndtr(self._standardize(value))

    def _z_entropy(self):
        return 0.5 + _LOG_SQRT_2PI


class Cauchy(_LocScale):
    _z_kind = "cauchy"
    _z_mean = None
    _z_var = None

    def _z_log_density(self, z):
        return -math.log(math.pi) - torch.log1p(z * z)

    def _z_cdf(self, z):
        return 0.5 + torch.arctan(z) / math.pi

    def _z_icdf(self, q):
        return torch.tan(math.pi * (q - 0.5))

    def _z_entropy(self):
        return math.log(4.0 * math.pi)


class Laplace(_LocScale):
    _z_kind = "laplace"
    _z_var = 2.0

    def _z_log_density(self, z):
        return -torch.abs(z) - _LOG_2

    def _z_cdf(self, z):
        return 0.5 - 0.5 * torch.sign(z) * torch.expm1(-torch.abs(z))

    def _z_icdf(self, q):
        half = q - 0.5
        return -torch.sign(half) * torch.log1p(-2.0 * torch.abs(half))

    def _z_entropy(self):
        return 1.0 + _LOG_2


class Gumbel(_LocScale):
    _z_kind = "gumbel"
    _z_mean = _EULER
    _z_var = math.pi**2 / 6.0

    def _z_log_density(self, z):
        return -z - torch.exp(-z)

    def _z_cdf(self, z):
        return torch.exp(-torch.exp(-z))

    def _z_icdf(self, q):
        return -torch.log(-torch.log(q))

    def _z_entropy(self):
        return 1.0 + _EULER


class Logistic(_LocScale):
    _z_kind = "logistic"
    _z_var = math.pi**2 / 3.0

    def _z_log_density(self, z):
        return -z - 2.0 * _softplus(-z)

    def _z_cdf(self, z):
        return torch.sigmoid(z)

    def _z_icdf(self, q):
        return torch.logit(q)

    def _z_entropy(self):
        return 2.0


class SoftLaplace(_LocScale):
    """Smooth log-convex density with Laplace-like tails: f(z) = 1/(pi cosh
    z); it has no entropy in the JAX package."""

    _z_var = math.pi**2 / 4.0

    def __init__(self, loc, scale, *, validate_args=None):
        super().__init__(loc, scale, validate_args=validate_args)

    def _z_sample(self, key, shape):
        u = standard_draw(key, "uniform", shape, self.loc)
        return self._z_icdf(u.clamp(min=torch.finfo(u.dtype).tiny))

    def _z_log_density(self, z):
        return _LOG_2 - math.log(math.pi) - torch.logaddexp(z, -z)

    def _z_cdf(self, z):
        return torch.arctan(torch.exp(z)) * (2.0 / math.pi)

    def _z_icdf(self, q):
        return torch.log(torch.tan(math.pi * q / 2.0))


def _betaln_half(a):
    """``betaln(a, 1/2)``, in float64 inside (``util.betaln``)."""
    return betaln(a, torch.full_like(a, 0.5))


class StudentT(_LocScale):
    """Student's t with ``df`` degrees of freedom.

    A draw is ``normal * sqrt(df / chi2)``, the chi-square made as twice a
    standard gamma draw of ``df / 2`` (normals first, then the gammas, from a
    draw source).  ``cdf`` goes through ``betainc`` (so it has no derivative
    in ``df``, as in the JAX package); ``icdf`` raises, as there."""

    reparametrized_params = ["df", "loc", "scale"]

    def __init__(self, df, loc=0.0, scale=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, df=df, loc=loc, scale=scale)

    def _z_sample(self, key, shape):
        eps = standard_draw(key, "normal", shape, self.loc)
        chi2 = 2.0 * standard_gamma(key, torch.broadcast_to(0.5 * self.df, shape))
        return eps * torch.sqrt(self.df / chi2)

    def _z_log_density(self, z):
        half_df = 0.5 * self.df
        log_norm = 0.5 * torch.log(self.df) + _betaln_half(half_df)
        return -(half_df + 0.5) * torch.log1p(z * z / self.df) - log_norm

    def _z_cdf(self, z):
        tail_x = self.df / (self.df + z * z)
        tail = 0.5 * betainc(0.5 * self.df, torch.full_like(tail_x, 0.5), tail_x)
        return torch.where(z < 0, tail, 1.0 - tail)

    def icdf(self, q):
        raise NotImplementedError("StudentT.icdf")

    @property
    def mean(self):
        z_mean = torch.where(self.df > 1.0, 0.0, math.nan)
        return torch.broadcast_to(self.loc + self.scale * z_mean, self.batch_shape)

    @property
    def variance(self):
        heavy = torch.where(self.df > 2.0, self.df / (self.df - 2.0), math.inf)
        z_var = torch.where(self.df > 1.0, heavy, math.nan)
        return torch.broadcast_to(self.scale**2 * z_var, self.batch_shape)

    def _z_entropy(self):
        half_df = 0.5 * self.df
        half_up = half_df + 0.5
        return (
            half_up * (torch.digamma(half_up) - torch.digamma(half_df))
            + 0.5 * torch.log(self.df)
            + _betaln_half(half_df)
        )


class _FoldedAtZero(Distribution):
    """|X| for a zero-centred symmetric loc-scale X; subclasses set
    ``_full_cls``."""

    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["scale"]

    def __init__(self, scale=1.0, *, validate_args=None):
        self._mirror = self._full_cls(0.0, scale)
        self.scale = self._mirror.scale
        super().__init__(self._mirror.batch_shape, validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        return torch.abs(self._mirror.sample(key, sample_shape))

    def log_prob(self, value):
        return _LOG_2 + self._mirror.log_prob(value)

    def cdf(self, value):
        return 2.0 * self._mirror.cdf(value) - 1.0

    def icdf(self, q):
        return self._mirror.icdf(0.5 * (1.0 + q))


class HalfCauchy(_FoldedAtZero):
    _full_cls = Cauchy

    @property
    def mean(self):
        return torch.full(self.batch_shape, math.inf, device=self.scale.device)

    @property
    def variance(self):
        return torch.full(self.batch_shape, math.inf, device=self.scale.device)


class HalfNormal(_FoldedAtZero):
    _full_cls = Normal

    @property
    def mean(self):
        return self.scale * math.sqrt(2.0 / math.pi)

    @property
    def variance(self):
        return self.scale**2 * (1.0 - 2.0 / math.pi)

    def entropy(self):
        return 0.5 + 0.5 * math.log(0.5 * math.pi) + torch.log(self.scale)


class Uniform(Distribution):
    has_rsample = True
    reparametrized_params = ["low", "high"]

    def __init__(self, low=0.0, high=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, low=low, high=high)
        self._support = constraints.interval(self.low, self.high)

    @property
    def support(self):
        return self._support

    def _width(self):
        return self.high - self.low

    def sample(self, key, sample_shape=()):
        u = standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape, self.low)
        return self.low + u * self._width()

    def log_prob(self, value):
        out = broadcast_shape(tuple(value.shape), self.batch_shape)
        return (-torch.log(self._width())).expand(out)

    def cdf(self, value):
        return torch.clamp((value - self.low) / self._width(), 0.0, 1.0)

    def icdf(self, value):
        return self.low + value * self._width()

    @property
    def mean(self):
        return torch.broadcast_to(0.5 * (self.high + self.low), self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(self._width() ** 2 / 12.0, self.batch_shape)

    def entropy(self):
        return torch.broadcast_to(torch.log(self._width()), self.batch_shape)


class Exponential(Distribution):
    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["rate"]

    def __init__(self, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, rate=rate)

    def sample(self, key, sample_shape=()):
        return standard_draw(key, "exponential", self.shape(sample_shape), self.rate) / self.rate

    def log_prob(self, value):
        return torch.log(self.rate) - self.rate * value

    def cdf(self, value):
        return -torch.expm1(-self.rate * value)

    def icdf(self, q):
        return -torch.log1p(-q) / self.rate

    @property
    def mean(self):
        return torch.broadcast_to(1.0 / self.rate, self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(self.rate**-2, self.batch_shape)

    def entropy(self):
        return torch.broadcast_to(1.0 - torch.log(self.rate), self.batch_shape)


class Gamma(Distribution):
    """Gamma with shape ``concentration`` and ``rate``.  ``cdf`` is
    ``util.gammainc``, differentiable in both arguments; ``icdf`` bisects
    (``util.gammaincinv``) and has no derivative."""

    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["concentration", "rate"]

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, rate=rate)

    def sample(self, key, sample_shape=()):
        alpha = torch.broadcast_to(self.concentration, self.shape(sample_shape))
        return standard_gamma(key, alpha) / self.rate

    def log_prob(self, value):
        a, beta = self.concentration, self.rate
        return torch.xlogy(a - 1.0, value) - beta * value + torch.xlogy(a, beta) - torch.lgamma(a)

    @property
    def mean(self):
        return torch.broadcast_to(self.concentration / self.rate, self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(self.concentration / self.rate**2, self.batch_shape)

    def cdf(self, x):
        return gammainc(self.concentration, self.rate * x)

    def icdf(self, q):
        return gammaincinv(self.concentration, q) / self.rate

    def entropy(self):
        a = self.concentration
        ent = a - torch.log(self.rate) + torch.lgamma(a) + (1.0 - a) * torch.digamma(a)
        return torch.broadcast_to(ent, self.batch_shape)


class Chi2(Gamma):
    reparametrized_params = ["df"]

    def __init__(self, df, *, validate_args=None):
        self.df = df
        super().__init__(0.5 * df, 0.5, validate_args=validate_args)


class InverseGamma(TransformedDistribution):
    """1 / Gamma(concentration, rate), through ``PowerTransform(-1)``."""

    support = constraints.positive
    reparametrized_params = ["concentration", "rate"]

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        gamma = Gamma(concentration, rate)
        self.concentration = gamma.concentration
        self.rate = gamma.rate
        super().__init__(gamma, PowerTransform(-1.0), validate_args=validate_args)

    @property
    def mean(self):
        a = self.concentration
        return torch.where(a > 1.0, self.rate / (a - 1.0), math.inf)

    @property
    def variance(self):
        a = self.concentration
        spread = (self.rate / (a - 1.0)) ** 2 / (a - 2.0)
        return torch.where(a > 2.0, spread, math.inf)

    def entropy(self):
        a, b = self.concentration, self.rate
        return a + torch.log(b) + torch.lgamma(a) - (1.0 + a) * torch.digamma(a)

    def cdf(self, x):
        return 1.0 - self.base_dist.cdf(1.0 / x)


class Beta(Distribution):
    """Beta on the unit interval.  A draw is ``g1 / (g1 + g0)`` for standard
    gamma draws of ``concentration1`` then ``concentration0``, clipped into
    ``[tiny, 1 - eps]``; ``cdf`` is ``util.betainc`` (no derivative in the
    concentrations, as in the JAX package) and ``icdf`` bisects."""

    support = constraints.unit_interval
    has_rsample = True
    reparametrized_params = ["concentration1", "concentration0"]

    def __init__(self, concentration1, concentration0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration1=concentration1,
                             concentration0=concentration0)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        g1 = standard_gamma(key, torch.broadcast_to(self.concentration1, shape))
        g0 = standard_gamma(key, torch.broadcast_to(self.concentration0, shape))
        return clamp_probs(g1 / (g1 + g0))

    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        return torch.xlogy(a - 1.0, value) + torch.special.xlog1py(b - 1.0, -value) - betaln(a, b)

    @property
    def mean(self):
        a, b = self.concentration1, self.concentration0
        return torch.broadcast_to(a / (a + b), self.batch_shape)

    @property
    def variance(self):
        a, b = self.concentration1, self.concentration0
        total = a + b
        return torch.broadcast_to((a / total) * (b / total) / (total + 1.0), self.batch_shape)

    def cdf(self, value):
        return betainc(self.concentration1, self.concentration0, value)

    def icdf(self, q):
        return betaincinv(self.concentration1, self.concentration0, q)

    def entropy(self):
        a, b = self.concentration1, self.concentration0
        total = a + b
        return (betaln(a, b) + (total - 2.0) * torch.digamma(total)
                - (a - 1.0) * torch.digamma(a) - (b - 1.0) * torch.digamma(b))


class BetaProportion(Beta):
    """Beta by its mean and precision (Ferrari and Cribari-Neto)."""

    reparametrized_params = ["mean", "concentration"]

    def __init__(self, mean, concentration, *, validate_args=None):
        self.concentration = torch.as_tensor(concentration)
        super().__init__(concentration * mean, concentration * (1.0 - mean),
                         validate_args=validate_args)


class Dirichlet(Distribution):
    """The Dirichlet distribution on the simplex of the last axis of
    ``concentration``.

    A draw normalizes standard gamma draws (``util.standard_gamma``) and is
    clipped into ``[tiny, 1 - eps]`` as the JAX package clips its draws."""

    support = constraints.simplex
    has_rsample = True
    reparametrized_params = ["concentration"]

    def __init__(self, concentration, *, validate_args=None):
        if not isinstance(concentration, torch.Tensor):
            concentration = torch.as_tensor(concentration, dtype=torch.get_default_dtype())
        if concentration.dim() == 0:
            raise ValueError("concentration must be at least one-dimensional")
        self._init_broadcast(
            validate_args, event_shape=tuple(concentration.shape[-1:]),
            event_dims={"concentration": 1}, concentration=concentration,
        )

    def sample(self, key, sample_shape=()):
        gammas = standard_gamma(key, torch.broadcast_to(self.concentration,
                                                        self.shape(sample_shape)))
        return clamp_probs(gammas / gammas.sum(-1, keepdim=True))

    def log_prob(self, value):
        alpha = self.concentration
        log_norm = torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))
        return torch.xlogy(alpha - 1.0, value).sum(-1) - log_norm

    @property
    def mean(self):
        return self.concentration / self.concentration.sum(-1, keepdim=True)

    @property
    def variance(self):
        a = self.concentration
        total = a.sum(-1, keepdim=True)
        return a * (total - a) / (total.square() * (total + 1.0))

    def entropy(self):
        a = self.concentration
        total = a.sum(-1)
        log_norm = torch.lgamma(a).sum(-1) - torch.lgamma(total)
        return (log_norm + (total - a.shape[-1]) * torch.digamma(total)
                - ((a - 1.0) * torch.digamma(a)).sum(-1))


class LogNormal(TransformedDistribution):
    support = constraints.positive
    reparametrized_params = ["loc", "scale"]

    def __init__(self, loc=0.0, scale=1.0, *, validate_args=None):
        gaussian = Normal(loc, scale)
        self.loc, self.scale = gaussian.loc, gaussian.scale
        super().__init__(gaussian, ExpTransform(), validate_args=validate_args)

    @property
    def mean(self):
        return torch.exp(self.loc + 0.5 * self.scale**2)

    @property
    def variance(self):
        s2 = self.scale**2
        return torch.expm1(s2) * torch.exp(2.0 * self.loc + s2)

    def entropy(self):
        return 0.5 + _LOG_SQRT_2PI + self.loc + torch.log(self.scale)

    def cdf(self, x):
        return self.base_dist.cdf(torch.log(x))


class LogUniform(TransformedDistribution):
    reparametrized_params = ["low", "high"]

    def __init__(self, low, high, *, validate_args=None):
        params = _as_tensors({"low": low, "high": high})
        flat = Uniform(torch.log(params["low"]), torch.log(params["high"]))
        self.low, self.high = promote_shapes(params["low"], params["high"])
        self._support = constraints.interval(self.low, self.high)
        super().__init__(flat, ExpTransform(), validate_args=validate_args)

    @property
    def support(self):
        return self._support

    def _log_span(self):
        return torch.log(self.high) - torch.log(self.low)

    @property
    def mean(self):
        return (self.high - self.low) / self._log_span()

    @property
    def variance(self):
        span = self._log_span()
        sq_avg = 0.5 * (self.high + self.low) * (self.high - self.low) / span
        return sq_avg - ((self.high - self.low) / span) ** 2

    def entropy(self):
        return 0.5 * torch.log(self.low * self.high) + torch.log(self._log_span())

    def cdf(self, x):
        return self.base_dist.cdf(torch.log(x))


class AsymmetricLaplace(Distribution):
    support = constraints.real
    has_rsample = True
    reparametrized_params = ["loc", "scale", "asymmetry"]

    def __init__(self, loc=0.0, scale=1.0, asymmetry=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale, asymmetry=asymmetry)

    @lazy_property
    def left_scale(self):
        return self.scale * self.asymmetry

    @lazy_property
    def right_scale(self):
        return self.scale / self.asymmetry

    def log_prob(self, value):
        gap = value - self.loc
        side_scale = torch.where(gap < 0.0, self.left_scale, self.right_scale)
        return -torch.abs(gap) / side_scale - torch.log(self.left_scale + self.right_scale)

    def sample(self, key, sample_shape=()):
        pair = standard_draw(key, "exponential", (2,) + self.shape(sample_shape), self.loc)
        return self.loc + self.right_scale * pair[1] - self.left_scale * pair[0]

    @property
    def mean(self):
        return torch.broadcast_to(self.loc + self.right_scale - self.left_scale,
                                  self.batch_shape)

    @property
    def variance(self):
        left, right = self.left_scale, self.right_scale
        total = left + right
        mix = (left / total) * (right / total) * total**2
        return torch.broadcast_to(left**2 * left / total + right**2 * right / total + mix,
                                  self.batch_shape)

    def cdf(self, value):
        gap = value - self.loc
        ksq = self.asymmetry**2
        left_mass = ksq / (1.0 + ksq)
        upper = 1.0 - torch.exp(-torch.abs(gap) / self.right_scale) / (1.0 + ksq)
        lower = left_mass * torch.exp(-torch.abs(gap) / self.left_scale)
        return torch.where(gap >= 0.0, upper, lower)

    def icdf(self, value):
        ksq = self.asymmetry**2
        left_mass = ksq / (1.0 + ksq)
        below = self.loc + self.left_scale * torch.log(value / left_mass)
        above = self.loc - self.right_scale * torch.log((1.0 - value) * (1.0 + ksq))
        return torch.where(value <= left_mass, below, above)


class AsymmetricLaplaceQuantile(Distribution):
    """AsymmetricLaplace by the quantile (Bayesian quantile regression)."""

    support = constraints.real
    has_rsample = True
    reparametrized_params = ["loc", "scale", "quantile"]

    def __init__(self, loc=0.0, scale=1.0, quantile=0.5, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale, quantile=quantile)
        kappa = torch.sqrt(self.quantile / (1.0 - self.quantile))
        self._ald = AsymmetricLaplace(loc=self.loc, scale=self.scale * kappa / self.quantile,
                                      asymmetry=kappa)

    def log_prob(self, value):
        return self._ald.log_prob(value)

    def sample(self, key, sample_shape=()):
        return self._ald.sample(key, sample_shape)

    @property
    def mean(self):
        return self._ald.mean

    @property
    def variance(self):
        return self._ald.variance

    def cdf(self, value):
        return self._ald.cdf(value)

    def icdf(self, value):
        return self._ald.icdf(value)


class Pareto(TransformedDistribution):
    reparametrized_params = ["scale", "alpha"]

    def __init__(self, scale, alpha, *, validate_args=None):
        params = _as_tensors({"scale": scale, "alpha": alpha})
        self.scale, self.alpha = promote_shapes(params["scale"], params["alpha"])
        batch = broadcast_shape(tuple(self.scale.shape), tuple(self.alpha.shape))
        chain = [ExpTransform(), AffineTransform(0.0, torch.broadcast_to(self.scale, batch))]
        super().__init__(Exponential(torch.broadcast_to(self.alpha, batch)), chain,
                         validate_args=validate_args)

    @property
    def mean(self):
        heavy = self.alpha * self.scale / (self.alpha - 1.0)
        return torch.where(self.alpha > 1.0, heavy, math.inf)

    @property
    def variance(self):
        a = self.alpha
        heavy = (self.scale / (a - 1.0)) ** 2 * a / (a - 2.0)
        return torch.where(a > 2.0, heavy, math.inf)

    @property
    def support(self):
        return constraints.greater_than(self.scale)

    def entropy(self):
        return 1.0 + torch.log(self.scale / self.alpha) + 1.0 / self.alpha

    def cdf(self, value):
        return 1.0 - torch.pow(self.scale / value, self.alpha)

    def icdf(self, q):
        return self.scale * torch.pow(1.0 - q, -1.0 / self.alpha)


class Weibull(Distribution):
    """Weibull with ``scale`` first, then ``concentration`` (the JAX
    package's order).  A draw is ``scale * E ** (1 / concentration)`` for a
    standard exponential E (``random.weibull_min``)."""

    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["scale", "concentration"]

    def __init__(self, scale, concentration, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, scale=scale)

    def sample(self, key, sample_shape=()):
        e = standard_draw(key, "exponential", tuple(sample_shape) + self.batch_shape, self.scale)
        return torch.pow(e, 1.0 / self.concentration) * self.scale

    def log_prob(self, value):
        k = self.concentration
        scaled = value / self.scale
        return torch.log(k / self.scale) + torch.xlogy(k - 1.0, scaled) - torch.pow(scaled, k)

    def cdf(self, value):
        return -torch.expm1(-torch.pow(value / self.scale, self.concentration))

    def _scaled_gamma(self, order):
        return torch.exp(torch.lgamma(1.0 + order / self.concentration))

    @property
    def mean(self):
        return self.scale * self._scaled_gamma(1.0)

    @property
    def variance(self):
        g1, g2 = self._scaled_gamma(1.0), self._scaled_gamma(2.0)
        return self.scale**2 * (g2 - g1**2)

    def entropy(self):
        k = self.concentration
        return _EULER * (1.0 - 1.0 / k) + torch.log(self.scale / k) + 1.0


class Kumaraswamy(Distribution):
    support = constraints.unit_interval
    has_rsample = True
    reparametrized_params = ["concentration1", "concentration0"]
    # the order of the Taylor series of the KL to a Beta
    KL_KUMARASWAMY_BETA_TAYLOR_ORDER = 10

    def __init__(self, concentration1, concentration0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration1=concentration1,
                             concentration0=concentration0)

    def sample(self, key, sample_shape=()):
        u = clamp_probs(standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape,
                                      self.concentration1))
        # the inverse CDF (1 - u^(1/b))^(1/a), in log space
        inner = torch.log1p(-torch.pow(u, 1.0 / self.concentration0))
        return clamp_probs(torch.exp(inner / self.concentration1))

    def log_prob(self, value):
        a, b = self.concentration1, self.concentration0
        return (torch.log(a * b) + torch.xlogy(a - 1.0, value)
                + torch.special.xlog1py(b - 1.0, -torch.pow(value, a)))

    def _raw_moment(self, order):
        return self.concentration0 * torch.exp(
            betaln(1.0 + order / self.concentration1, self.concentration0))

    @property
    def mean(self):
        return self._raw_moment(1.0)

    @property
    def variance(self):
        return self._raw_moment(2.0) - self._raw_moment(1.0) ** 2


def _exp_e1(c):
    """``exp(c) E1(c)`` for c > 0 (``-exp(c) expi(-c)``), in float64 inside:
    the power series below 1, a continued fraction of fixed depth above
    (both within 1e-12 of scipy's ``exp1``)."""
    x = c.to(torch.float64)
    k = torch.arange(1, 31, dtype=torch.float64, device=x.device).reshape((-1,) + (1,) * x.dim())
    small = x.clamp(max=1.0)
    terms = torch.exp(torch.xlogy(k, small) - torch.log(k) - torch.lgamma(k + 1.0))
    signed = torch.where(k % 2 == 1, -terms, terms)
    series = (-_EULER - torch.log(small) - signed.sum(0)) * torch.exp(small)
    big = x.clamp(min=1.0)
    frac = big + 121.0
    for n in range(60, 0, -1):
        frac = big + (2 * n - 1) - n * n / frac
    return torch.where(x < 1.0, series, 1.0 / frac).to(c.dtype)


class Gompertz(Distribution):
    """Gompertz: CDF ``1 - exp(-concentration * expm1(rate * x))``."""

    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["concentration", "rate"]

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, rate=rate)

    def sample(self, key, sample_shape=()):
        u = standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape, self.rate)
        return self.icdf(u)

    def log_prob(self, value):
        grown = value * self.rate
        return torch.log(self.concentration * self.rate) + grown - self.concentration * torch.expm1(
            grown)

    def cdf(self, value):
        return -torch.expm1(-self.concentration * torch.expm1(value * self.rate))

    def icdf(self, q):
        return torch.log1p(-torch.log1p(-q) / self.concentration) / self.rate

    @property
    def mean(self):
        return _exp_e1(self.concentration) / self.rate


class Levy(Distribution):
    """Levy (alpha-stable with alpha = 1/2, beta = 1), on ``(loc, inf)``; not
    reparameterised, as in the JAX package."""

    def __init__(self, loc, scale, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale)
        self._support = constraints.greater_than(self.loc)

    @property
    def support(self):
        return self._support

    def log_prob(self, value):
        gap = value - self.loc
        return (0.5 * torch.log(self.scale / (2.0 * math.pi)) - 0.5 * self.scale / gap
                - 1.5 * torch.log(gap))

    def sample(self, key, sample_shape=()):
        u = standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape, self.loc)
        return self.icdf(u)

    def icdf(self, q):
        folded = torch.special.ndtri(1.0 - 0.5 * q)
        return self.loc + self.scale / folded**2

    def cdf(self, value):
        standardized = self.scale / (value - self.loc)
        return 2.0 * (1.0 - _ndtr(torch.sqrt(standardized)))

    @property
    def mean(self):
        return torch.full(self.batch_shape, math.inf, device=self.loc.device)

    @property
    def variance(self):
        return torch.full(self.batch_shape, math.inf, device=self.loc.device)


class RelaxedBernoulliLogits(TransformedDistribution):
    """The continuous relaxation of a Bernoulli (Concrete): a logistic of
    location ``logits / temperature`` and scale ``1 / temperature`` through a
    sigmoid."""

    support = constraints.unit_interval

    def __init__(self, temperature, logits, *, validate_args=None):
        params = _as_tensors({"temperature": temperature, "logits": logits})
        self.temperature, self.logits = promote_shapes(params["temperature"], params["logits"])
        inv_temp = 1.0 / params["temperature"]
        super().__init__(Logistic(params["logits"] * inv_temp, inv_temp), [SigmoidTransform()],
                         validate_args=validate_args)


def RelaxedBernoulli(temperature, probs=None, logits=None, *, validate_args=None):
    if (probs is None) == (logits is None):
        raise ValueError("Exactly one of ['probs', 'logits'] must be specified")
    if probs is not None:
        safe = clamp_probs(torch.as_tensor(probs, dtype=torch.get_default_dtype())
                           if not isinstance(probs, torch.Tensor) else probs)
        logits = torch.log(safe) - torch.log1p(-safe)
    return RelaxedBernoulliLogits(temperature, logits, validate_args=validate_args)


def _tril_logdet(scale_tril):
    return torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)).sum(-1)


class MultivariateNormal(Distribution):
    """Normal over vectors, held by the Cholesky factor of its covariance
    (``scale_tril``; a covariance or precision matrix is factored once, to a
    NaN factor where it is not positive definite)."""

    support = constraints.real_vector
    has_rsample = True

    def __init__(self, loc=0.0, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None, *, validate_args=None):
        matrix = next(
            (m for m in (covariance_matrix, precision_matrix, scale_tril) if m is not None), None
        )
        if matrix is None:
            raise ValueError(
                "One of covariance_matrix, precision_matrix, scale_tril must be specified."
            )
        if not isinstance(loc, torch.Tensor):
            loc = torch.as_tensor(loc, dtype=matrix.dtype, device=matrix.device)
        if loc.dim() == 0:
            loc = loc.reshape(1)
        # align loc (..., D) against (..., D, D) matrices through a dummy axis
        col, matrix = promote_shapes(loc[..., None], matrix)
        if covariance_matrix is not None:
            self.covariance_matrix = matrix
            self.scale_tril = cholesky(matrix)
        elif precision_matrix is not None:
            self.precision_matrix = matrix
            # chol(P^-1) from the Cholesky factor of P with both axes reversed
            flipped = cholesky(matrix.flip(-2, -1))
            upper = flipped.flip(-2, -1).transpose(-2, -1)
            eye = torch.eye(matrix.shape[-1], dtype=matrix.dtype, device=matrix.device)
            self.scale_tril = torch.linalg.solve_triangular(
                upper, torch.broadcast_to(eye, upper.shape), upper=False
            )
        else:
            self.scale_tril = matrix
        self.loc = col[..., 0]
        batch = broadcast_shape(tuple(col.shape[:-2]), tuple(self.scale_tril.shape[:-2]))
        super().__init__(batch, tuple(self.scale_tril.shape[-1:]), validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        white = standard_draw(key, "normal", self.shape(sample_shape), self.loc)
        return self.loc + (self.scale_tril @ white[..., None])[..., 0]

    def log_prob(self, value):
        diff = value - self.loc
        shape = broadcast_shape(tuple(diff.shape[:-1]), tuple(self.scale_tril.shape[:-2]))
        n = diff.shape[-1]
        solved = torch.linalg.solve_triangular(
            torch.broadcast_to(self.scale_tril, shape + (n, n)),
            torch.broadcast_to(diff, shape + (n,))[..., None],
            upper=False,
        )
        quad = (solved**2).sum((-1, -2))
        return -0.5 * (quad + n * math.log(2.0 * math.pi)) - _tril_logdet(self.scale_tril)

    @lazy_property
    def covariance_matrix(self):
        return self.scale_tril @ self.scale_tril.transpose(-2, -1)

    @lazy_property
    def precision_matrix(self):
        eye = torch.eye(self.scale_tril.shape[-1], dtype=self.scale_tril.dtype,
                        device=self.scale_tril.device)
        root_inv = torch.linalg.solve_triangular(
            self.scale_tril, torch.broadcast_to(eye, self.scale_tril.shape), upper=False
        )
        return root_inv.transpose(-2, -1) @ root_inv

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.shape())

    @property
    def variance(self):
        return torch.broadcast_to((self.scale_tril**2).sum(-1), self.batch_shape + self.event_shape)

    def entropy(self):
        gauss = 0.5 * self.event_shape[-1] * (1.0 + math.log(2.0 * math.pi))
        return torch.broadcast_to(gauss + _tril_logdet(self.scale_tril), self.batch_shape)


def _add_diag(matrix, diag):
    return matrix + torch.diag_embed(torch.broadcast_to(diag, matrix.shape[:-1]))


class LowRankMultivariateNormal(Distribution):
    """Normal over vectors with covariance ``cov_factor @ cov_factor.T +
    diag(cov_diag)``: ``log_prob`` takes the Woodbury identity and the
    matrix-determinant lemma, ``O(D K^2)`` for a ``(D, K)`` factor.
    ``sample`` draws from its generator the factor's noise ``(*sample_shape,
    *batch_shape, K)`` first, then the diagonal's ``(*sample_shape,
    *batch_shape, D)``."""

    support = constraints.real_vector
    has_rsample = True

    def __init__(self, loc, cov_factor, cov_diag, *, validate_args=None):
        if loc.dim() < 1:
            raise ValueError("`loc` must be at least one-dimensional.")
        dim = tuple(loc.shape[-1:])
        if cov_factor.dim() < 2 or tuple(cov_factor.shape[-2:-1]) != dim:
            raise ValueError("`cov_factor` must have shape (..., D, K)")
        if tuple(cov_diag.shape[-1:]) != dim:
            raise ValueError("`cov_diag` must have shape (..., D)")
        loc_col, factor, diag_col = promote_shapes(loc[..., None], cov_factor, cov_diag[..., None])
        self.loc = loc_col[..., 0]
        self.cov_factor = factor
        self.cov_diag = diag_col[..., 0]
        batch = broadcast_shape(tuple(loc_col.shape), tuple(factor.shape),
                                tuple(diag_col.shape))[:-2]
        super().__init__(batch, dim, validate_args=validate_args)

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.shape())

    @lazy_property
    def variance(self):
        marginal = self.cov_factor.square().sum(-1) + self.cov_diag
        return torch.broadcast_to(marginal, self.batch_shape + self.event_shape)

    @lazy_property
    def _whitened_factor(self):
        """``W^T D^{-1}``, ``(K, D)``."""
        return self.cov_factor.transpose(-2, -1) / self.cov_diag[..., None, :]

    @lazy_property
    def _capacitance_tril(self):
        """``chol(I + W^T D^{-1} W)``, ``(K, K)``."""
        cap = self._whitened_factor @ self.cov_factor
        return cholesky(_add_diag(cap, cap.new_ones(())))

    @lazy_property
    def covariance_matrix(self):
        return _add_diag(self.cov_factor @ self.cov_factor.transpose(-2, -1), self.cov_diag)

    @lazy_property
    def scale_tril(self):
        return cholesky(self.covariance_matrix)

    @lazy_property
    def precision_matrix(self):
        # Woodbury: D^-1 - D^-1 W (I + W^T D^-1 W)^-1 W^T D^-1
        half = torch.linalg.solve_triangular(
            self._capacitance_tril, self._whitened_factor, upper=False
        )
        return torch.diag_embed(1.0 / self.cov_diag) - half.transpose(-2, -1) @ half

    def sample(self, key, sample_shape=()):
        batched = tuple(sample_shape) + self.batch_shape
        eps_low = torch.randn(batched + tuple(self.cov_factor.shape[-1:]), generator=key,
                              device=key.device, dtype=self.loc.dtype)
        eps_diag = torch.randn(batched + self.event_shape, generator=key, device=key.device,
                               dtype=self.loc.dtype)
        return (self.loc + (self.cov_factor @ eps_low[..., None])[..., 0]
                + torch.sqrt(self.cov_diag) * eps_diag)

    def _half_log_det(self):
        # the matrix-determinant lemma: log|C| = log|cap| + log|D|
        return _tril_logdet(self._capacitance_tril) + 0.5 * torch.log(self.cov_diag).sum(-1)

    def log_prob(self, value):
        gap = value - self.loc
        projected = (self._whitened_factor @ gap[..., None])[..., 0]
        cap = torch.broadcast_to(
            self._capacitance_tril, projected.shape[:-1] + self._capacitance_tril.shape[-2:]
        )
        correction = torch.linalg.solve_triangular(cap, projected[..., None], upper=False)[..., 0]
        quad = (gap.square() / self.cov_diag).sum(-1) - correction.square().sum(-1)
        dim = self.loc.shape[-1]
        return -0.5 * (dim * math.log(2.0 * math.pi) + quad) - self._half_log_det()

    def entropy(self):
        dim = self.loc.shape[-1]
        gauss = 0.5 * dim * (1.0 + math.log(2.0 * math.pi))
        return torch.broadcast_to(gauss + self._half_log_det(), self.batch_shape)


class GaussianRandomWalk(Distribution):
    """A walk of ``num_steps`` Gaussian steps of size ``scale`` from 0, one
    event: ``log_prob`` sums the increments' normal densities and ``sample``
    is a cumulative sum of steps, so neither needs a ``scan``."""

    support = constraints.real_vector
    has_rsample = True

    def __init__(self, scale=1.0, num_steps=1, *, validate_args=None):
        if not (isinstance(num_steps, int) and num_steps > 0):
            raise AssertionError("`num_steps` argument should be a positive integer.")
        self.scale = _as_tensors({"scale": scale})["scale"]
        self.num_steps = num_steps
        super().__init__(tuple(self.scale.shape), (num_steps,), validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        steps = torch.randn(self.shape(sample_shape), generator=key, device=key.device,
                            dtype=self.scale.dtype)
        return self.scale[..., None] * torch.cumsum(steps, -1)

    def log_prob(self, value):
        # the increments, the first one from 0, are iid N(0, scale)
        increments = torch.diff(value, dim=-1, prepend=torch.zeros_like(value[..., :1]))
        z = increments / self.scale[..., None]
        per_step = -0.5 * z * z - _LOG_SQRT_2PI - torch.log(self.scale)[..., None]
        return per_step.sum(-1)

    @property
    def mean(self):
        return self.scale.new_zeros(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        growth = torch.arange(1, self.num_steps + 1, device=self.scale.device,
                              dtype=self.scale.dtype)
        return torch.broadcast_to((self.scale**2)[..., None] * growth,
                                  self.batch_shape + self.event_shape)
