"""Continuous distributions (port of ``numpyro_tpu/distributions/continuous.py``:
the location-scale families ``Normal``, ``Cauchy``, ``Laplace``, ``Gumbel``,
``Logistic``, ``SoftLaplace`` and ``StudentT``; ``HalfCauchy`` and
``HalfNormal``; ``Uniform``, ``Exponential``, ``Gamma``, ``Chi2``,
``InverseGamma``, ``Beta``, ``BetaProportion``, ``Dirichlet``, ``LogNormal``,
``LogUniform``, ``AsymmetricLaplace``, ``AsymmetricLaplaceQuantile``,
``Pareto``, ``Weibull``, ``Kumaraswamy``, ``Gompertz``, ``Levy`` and
``RelaxedBernoulliLogits``/``RelaxedBernoulli``; ``MultivariateNormal``,
``LowRankMultivariateNormal`` and ``GaussianRandomWalk``; and the structured
and matrix families ``MultivariateStudentT``, ``LKJCholesky``, ``LKJ``,
``Wishart``, ``WishartCholesky``, ``ZeroSumNormal``, ``MatrixNormal``,
``CAR``, ``EulerMaruyama``, ``GaussianStateSpace`` and ``CirculantNormal``:
every class of the JAX module).

As in the JAX package, the location-scale families derive from ``_LocScale``,
which owns the affine bookkeeping, and each family supplies its standardized
kernel; the half distributions fold a zero-centred family at zero.  Every
formula is the JAX class's, written out (``torch.distributions`` differs in
parameterisations, clamps and supports).

A sampler takes a ``torch.Generator`` or a draw source (``util.standard_draw``,
``util.standard_gamma``): a draw is made on the device of its generator, where
0-dim parameters (a Python number becomes one on the CPU) broadcast as they
are.  Gamma, Chi2, InverseGamma, Beta and Dirichlet draw with
``torch._standard_gamma``, and LKJCholesky, Wishart, WishartCholesky and
MultivariateStudentT draw their Beta and chi-square variates from it too, all
reparameterised in the concentration in reverse and forward mode
(``util.standard_gamma``).  A covariance, precision or scale matrix that is
not positive definite gives a NaN factor and a NaN ``log_prob``, as in the
JAX package, and never raises.  Where the JAX package steps through time
with ``lax.scan`` (the draws of ``EulerMaruyama`` and ``GaussianStateSpace``)
the port loops in Python; no ``log_prob`` loops.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution, TransformedDistribution, _as_tensors
from .transforms import (
    AffineTransform,
    CholeskyTransform,
    CorrMatrixCholeskyTransform,
    ExpTransform,
    PowerTransform,
    SigmoidTransform,
    ZeroSumTransform,
    _embed_diag,
    _softplus,
    matrix_to_tril_vec,
    vec_to_tril_matrix,
)
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
    validate_sample,
)

__all__ = [
    "AsymmetricLaplace", "AsymmetricLaplaceQuantile", "Beta", "BetaProportion", "CAR", "Cauchy",
    "Chi2", "CirculantNormal", "Dirichlet", "EulerMaruyama", "Exponential", "Gamma",
    "GaussianRandomWalk", "GaussianStateSpace", "Gompertz", "Gumbel", "HalfCauchy",
    "HalfNormal", "InverseGamma", "Kumaraswamy", "LKJ", "LKJCholesky", "Laplace", "Levy",
    "LogNormal", "LogUniform", "Logistic", "LowRankMultivariateNormal", "MatrixNormal",
    "MultivariateNormal", "MultivariateStudentT", "Normal", "Pareto", "RelaxedBernoulli",
    "RelaxedBernoulliLogits", "SoftLaplace", "StudentT", "Uniform", "Weibull", "Wishart",
    "WishartCholesky", "ZeroSumNormal",
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

    arg_constraints = dict(loc=constraints.real, scale=constraints.positive)
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

    @validate_sample
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

    arg_constraints = dict(df=constraints.positive, loc=constraints.real,
                           scale=constraints.positive)
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

    arg_constraints = dict(scale=constraints.positive)
    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["scale"]

    def __init__(self, scale=1.0, *, validate_args=None):
        self._mirror = self._full_cls(0.0, scale)
        self.scale = self._mirror.scale
        super().__init__(self._mirror.batch_shape, validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        return torch.abs(self._mirror.sample(key, sample_shape))

    @validate_sample
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
    arg_constraints = dict(low=constraints.dependent(is_discrete=False, event_dim=0),
                           high=constraints.dependent(is_discrete=False, event_dim=0))
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

    @validate_sample
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
    arg_constraints = dict(rate=constraints.positive)
    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["rate"]

    def __init__(self, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, rate=rate)

    def sample(self, key, sample_shape=()):
        return standard_draw(key, "exponential", self.shape(sample_shape), self.rate) / self.rate

    @validate_sample
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

    arg_constraints = dict(concentration=constraints.positive, rate=constraints.positive)
    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["concentration", "rate"]

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, rate=rate)

    def sample(self, key, sample_shape=()):
        alpha = torch.broadcast_to(self.concentration, self.shape(sample_shape))
        return standard_gamma(key, alpha) / self.rate

    @validate_sample
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
    arg_constraints = dict(df=constraints.positive)
    reparametrized_params = ["df"]

    def __init__(self, df, *, validate_args=None):
        self.df = df
        super().__init__(0.5 * df, 0.5, validate_args=validate_args)


class InverseGamma(TransformedDistribution):
    """1 / Gamma(concentration, rate), through ``PowerTransform(-1)``."""

    arg_constraints = dict(concentration=constraints.positive, rate=constraints.positive)
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

    arg_constraints = dict(concentration1=constraints.positive, concentration0=constraints.positive)
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

    @validate_sample
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

    arg_constraints = dict(mean=constraints.open_interval(0.0, 1.0),
                           concentration=constraints.positive)
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

    arg_constraints = dict(concentration=constraints.independent(constraints.positive, 1))
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

    @validate_sample
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
    arg_constraints = dict(loc=constraints.real, scale=constraints.positive)
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
    arg_constraints = dict(low=constraints.positive, high=constraints.positive)
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
    arg_constraints = dict(loc=constraints.real, scale=constraints.positive,
                           asymmetry=constraints.positive)
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
        if self._validate_args:
            self._validate_sample(value)
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

    arg_constraints = dict(loc=constraints.real, scale=constraints.positive,
                           quantile=constraints.open_interval(0.0, 1.0))
    support = constraints.real
    has_rsample = True
    reparametrized_params = ["loc", "scale", "quantile"]

    def __init__(self, loc=0.0, scale=1.0, quantile=0.5, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale, quantile=quantile)
        kappa = torch.sqrt(self.quantile / (1.0 - self.quantile))
        self._ald = AsymmetricLaplace(loc=self.loc, scale=self.scale * kappa / self.quantile,
                                      asymmetry=kappa)

    def log_prob(self, value):
        if self._validate_args:
            self._validate_sample(value)
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
    arg_constraints = dict(scale=constraints.positive, alpha=constraints.positive)
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

    arg_constraints = dict(scale=constraints.positive, concentration=constraints.positive)
    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["scale", "concentration"]

    def __init__(self, scale, concentration, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, scale=scale)

    def sample(self, key, sample_shape=()):
        e = standard_draw(key, "exponential", tuple(sample_shape) + self.batch_shape, self.scale)
        return torch.pow(e, 1.0 / self.concentration) * self.scale

    @validate_sample
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
    arg_constraints = dict(concentration1=constraints.positive, concentration0=constraints.positive)
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

    @validate_sample
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

    arg_constraints = dict(concentration=constraints.positive, rate=constraints.positive)
    support = constraints.positive
    has_rsample = True
    reparametrized_params = ["concentration", "rate"]

    def __init__(self, concentration, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, concentration=concentration, rate=rate)

    def sample(self, key, sample_shape=()):
        u = standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape, self.rate)
        return self.icdf(u)

    @validate_sample
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

    arg_constraints = dict(loc=constraints.positive, scale=constraints.positive)
    def __init__(self, loc, scale, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale)
        self._support = constraints.greater_than(self.loc)

    @property
    def support(self):
        return self._support

    @validate_sample
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

    arg_constraints = dict(temperature=constraints.positive, logits=constraints.real)
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


def _mat_vec(m, v):
    return (m @ v[..., None])[..., 0]


def _batch_mahalanobis(bL, bx):
    """``x^T (L L^T)^{-1} x`` over the broadcast batch of ``bL`` ``(..., n,
    n)`` and ``bx`` ``(..., n)``, by one triangular solve."""
    n = bx.shape[-1]
    shape = broadcast_shape(tuple(bx.shape[:-1]), tuple(bL.shape[:-2]))
    solved = torch.linalg.solve_triangular(
        torch.broadcast_to(bL, shape + (n, n)), torch.broadcast_to(bx, shape + (n,))[..., None],
        upper=False,
    )
    return solved.square().sum((-1, -2))


def _multigammaln(a, d):
    """``log Gamma_d(a)``, as the JAX package sums it (PyTorch's
    ``mvlgamma`` checks its domain on the host)."""
    offsets = 0.5 * torch.arange(d, dtype=a.dtype, device=a.device)
    return torch.lgamma(a[..., None] - offsets).sum(-1) + 0.25 * d * (d - 1) * math.log(math.pi)


def _cholesky_of_inverse(matrix):
    """``chol(P^-1)`` from the Cholesky factor of ``P`` with both axes
    reversed, as the JAX package's ``cholesky_of_inverse``; NaN where ``P``
    is not positive definite."""
    flipped = cholesky(matrix.flip(-2, -1))
    upper = flipped.flip(-2, -1).transpose(-2, -1)
    eye = torch.eye(matrix.shape[-1], dtype=matrix.dtype, device=matrix.device)
    return torch.linalg.solve_triangular(upper, torch.broadcast_to(eye, upper.shape),
                                         upper=False)


def _as_loc_vector(loc, like):
    """``loc`` as a tensor of at least one dim, in ``like``'s dtype and on
    its device where it is a number."""
    if not isinstance(loc, torch.Tensor):
        loc = torch.as_tensor(loc, dtype=like.dtype, device=like.device)
    return loc.reshape(1) if loc.dim() == 0 else loc


class MultivariateNormal(Distribution):
    """Normal over vectors, held by the Cholesky factor of its covariance
    (``scale_tril``; a covariance or precision matrix is factored once, to a
    NaN factor where it is not positive definite)."""

    arg_constraints = {"loc": constraints.real_vector,
                       "covariance_matrix": constraints.positive_definite,
                       "precision_matrix": constraints.positive_definite,
                       "scale_tril": constraints.lower_cholesky}
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
        loc = _as_loc_vector(loc, matrix)
        # align loc (..., D) against (..., D, D) matrices through a dummy axis
        col, matrix = promote_shapes(loc[..., None], matrix)
        if covariance_matrix is not None:
            self.covariance_matrix = matrix
            self.scale_tril = cholesky(matrix)
        elif precision_matrix is not None:
            self.precision_matrix = matrix
            self.scale_tril = _cholesky_of_inverse(matrix)
        else:
            self.scale_tril = matrix
        self.loc = col[..., 0]
        batch = broadcast_shape(tuple(col.shape[:-2]), tuple(self.scale_tril.shape[:-2]))
        super().__init__(batch, tuple(self.scale_tril.shape[-1:]), validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        white = standard_draw(key, "normal", self.shape(sample_shape), self.loc)
        return self.loc + _mat_vec(self.scale_tril, white)

    @validate_sample
    def log_prob(self, value):
        quad = _batch_mahalanobis(self.scale_tril, value - self.loc)
        n = self.scale_tril.shape[-1]
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

    arg_constraints = {"loc": constraints.real_vector,
                       "cov_factor": constraints.independent(constraints.real, 2),
                       "cov_diag": constraints.independent(constraints.positive, 1)}
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

    @validate_sample
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

    arg_constraints = {"scale": constraints.positive}
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

    @validate_sample
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


# ---------------------------------------------------------------------------
# Structured and matrix families


class MultivariateStudentT(Distribution):
    """Student's t over vectors: ``loc + L z sqrt(df / c)`` for a standard
    normal vector ``z`` and a chi-square ``c`` of ``df`` degrees (drawn in
    that order, ``c`` as twice a standard gamma draw of ``df / 2``)."""

    arg_constraints = {"df": constraints.positive, "loc": constraints.real_vector,
                       "scale_tril": constraints.lower_cholesky}
    support = constraints.real_vector
    has_rsample = True
    reparametrized_params = ["df", "loc", "scale_tril"]

    def __init__(self, df, loc=0.0, scale_tril=None, *, validate_args=None):
        self._init_broadcast(
            validate_args, event_shape=tuple(scale_tril.shape[-1:]),
            event_dims={"loc": 1, "scale_tril": 2}, df=df,
            loc=_as_loc_vector(loc, scale_tril), scale_tril=scale_tril,
        )

    def sample(self, key, sample_shape=()):
        batched = tuple(sample_shape) + self.batch_shape
        white = standard_draw(key, "normal", batched + self.event_shape, self.loc)
        mix = 2.0 * standard_gamma(key, torch.broadcast_to(0.5 * self.df, batched))
        heavy = white * torch.sqrt(self.df / mix)[..., None]
        return self.loc + _mat_vec(self.scale_tril, heavy)

    @validate_sample
    def log_prob(self, value):
        dim = self.scale_tril.shape[-1]
        quad = _batch_mahalanobis(self.scale_tril, value - self.loc)
        half_sum = 0.5 * (self.df + dim)
        return (torch.lgamma(half_sum) - torch.lgamma(0.5 * self.df)
                - 0.5 * dim * torch.log(self.df * math.pi) - _tril_logdet(self.scale_tril)
                - half_sum * torch.log1p(quad / self.df))

    @property
    def mean(self):
        df_col = self.df[..., None]
        return torch.broadcast_to(torch.where(df_col > 1.0, self.loc, torch.nan), self.shape())

    @property
    def variance(self):
        df_col = self.df[..., None]
        cov_diag = self.scale_tril.square().sum(-1)
        heavy = torch.where(df_col > 2.0, cov_diag * df_col / (df_col - 2.0), torch.inf)
        return torch.broadcast_to(torch.where(df_col > 1.0, heavy, torch.nan),
                                  self.batch_shape + self.event_shape)


class LKJCholesky(Distribution):
    """The LKJ prior over Cholesky factors of correlation matrices.

    ``sample`` is the onion method (Lewandowski, Kurowicka and Joe 2009), as
    the JAX package draws: each row's squared off-diagonal norm is a Beta
    draw (two standard gamma draws, ``_beta_concentration1`` then
    ``_beta_concentration0``), its direction a normalised normal vector.  Its
    shape is ``sample_shape + batch_shape + (D, D)``; the JAX package's has
    ``batch_shape`` twice where the concentration is batched (ROADMAP.md,
    Queue 3).  ``sample_method="cvine"`` keeps the JAX package's Beta
    parameters and ``log_prob``, but its ``sample`` raises: the JAX class
    draws cvine by the onion path with parameters of the wrong shape, and
    fails there."""

    arg_constraints = {"concentration": constraints.positive}
    support = constraints.corr_cholesky
    has_rsample = True
    reparametrized_params = ["concentration"]

    def __init__(self, dimension=2, concentration=1.0, sample_method="onion", *,
                 validate_args=None):
        if dimension < 2:
            raise ValueError("Dimension must be greater than or equal to 2.")
        if not isinstance(concentration, torch.Tensor):
            concentration = torch.as_tensor(concentration, dtype=torch.get_default_dtype())
        self.dimension = dimension
        self.concentration = concentration
        rows = dimension - 1
        marginal = concentration + 0.5 * (dimension - 2)
        ladder = 0.5 * torch.arange(rows, dtype=concentration.dtype,
                                    device=concentration.device)
        if sample_method == "onion":
            self._beta_concentration0 = marginal[..., None] - ladder
            self._beta_concentration1 = ladder + 0.5
        elif sample_method == "cvine":
            ladder_tril = matrix_to_tril_vec(ladder.expand(rows, rows), diagonal=0)
            both = marginal[..., None] - ladder_tril
            self._beta_concentration0 = both
            self._beta_concentration1 = both
        else:
            raise ValueError("`method` should be one of 'cvine' or 'onion'.")
        self.sample_method = sample_method
        super().__init__(tuple(concentration.shape), (dimension, dimension),
                         validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        if self.sample_method != "onion":
            raise NotImplementedError(
                "LKJCholesky(sample_method='cvine').sample: the JAX package draws cvine "
                "through its onion sampler with Beta parameters of the wrong shape and fails "
                "(see ROADMAP.md); use sample_method='onion'")
        size = tuple(sample_shape) + self.batch_shape
        d = self.dimension
        c0 = torch.broadcast_to(self._beta_concentration0, size + (d - 1,))
        c1 = torch.broadcast_to(self._beta_concentration1, size + (d - 1,))
        g1 = standard_gamma(key, c1)
        g0 = standard_gamma(key, c0)
        radius_sq = g1 / (g1 + g0)
        raw = standard_draw(key, "normal", size + (d * (d - 1) // 2,), c0)
        tril = vec_to_tril_matrix(raw, diagonal=0)
        directions = torch.nan_to_num(tril / torch.linalg.vector_norm(tril, dim=-1, keepdim=True))
        body = torch.sqrt(radius_sq)[..., None] * directions
        # below the diagonal of the D x D factor, then the diagonal that
        # gives each row a unit norm
        body = torch.nn.functional.pad(body, (0, 1, 1, 0))
        diag = torch.sqrt((1.0 - body.square().sum(-1)).clamp(min=0.0))
        return body + diag[..., None] * torch.eye(d, dtype=body.dtype, device=body.device)

    @validate_sample
    def log_prob(self, value):
        diag = torch.diagonal(value, dim1=-2, dim2=-1)[..., 1:]
        # sum over rows i >= 2 of (D - i + 2 (eta - 1)) log L_ii
        row = torch.arange(2, self.dimension + 1, dtype=diag.dtype, device=diag.device)
        eta = self.concentration[..., None]
        exponent = self.dimension - row + 2.0 * (eta - 1.0)
        unnorm = (exponent * torch.log(diag)).sum(-1)
        rows = self.dimension - 1
        alpha = self.concentration + 0.5 * rows
        log_norm = (0.5 * rows * math.log(math.pi) + _multigammaln(alpha - 0.5, rows)
                    - rows * torch.lgamma(alpha))
        return unnorm - log_norm

    @property
    def mean(self):
        eye = torch.eye(self.dimension, dtype=self.concentration.dtype,
                        device=self.concentration.device)
        return torch.broadcast_to(eye, self.batch_shape + (self.dimension, self.dimension))


class LKJ(TransformedDistribution):
    """The LKJ prior over correlation matrices: ``L L^T`` for ``L`` drawn
    from :class:`LKJCholesky`."""

    arg_constraints = {"concentration": constraints.positive}
    reparametrized_params = ["concentration"]
    support = constraints.corr_matrix

    def __init__(self, dimension=2, concentration=1.0, sample_method="onion", *,
                 validate_args=None):
        base = LKJCholesky(dimension, concentration, sample_method)
        self.dimension = dimension
        self.concentration = base.concentration
        self.sample_method = sample_method
        super().__init__(base, CorrMatrixCholeskyTransform().inv, validate_args=validate_args)

    @property
    def mean(self):
        return self.base_dist.mean


class WishartCholesky(Distribution):
    """The Cholesky factor of a Wishart matrix, drawn by the Bartlett
    decomposition: ``L_S A`` with normal draws below the diagonal of ``A``
    and the square roots of chi-square draws of ``concentration - i``
    degrees on it (the normals first, then the chi-squares as twice standard
    gamma draws).  A scale or rate matrix that is not positive definite
    gives a NaN factor (``util.cholesky``), as in the JAX package."""

    arg_constraints = {"concentration": constraints.dependent(is_discrete=False),
                       "scale_matrix": constraints.positive_definite,
                       "rate_matrix": constraints.positive_definite,
                       "scale_tril": constraints.lower_cholesky}
    support = constraints.lower_cholesky
    reparametrized_params = ["scale_matrix", "rate_matrix", "scale_tril"]

    def __init__(self, concentration, scale_matrix=None, rate_matrix=None, scale_tril=None, *,
                 validate_args=None):
        if scale_matrix is not None:
            root = cholesky(scale_matrix)
        elif rate_matrix is not None:
            root = _cholesky_of_inverse(rate_matrix)
        elif scale_tril is not None:
            root = scale_tril
        else:
            raise ValueError("One of scale_matrix, rate_matrix, scale_tril must be specified.")
        self._init_broadcast(validate_args, event_shape=tuple(root.shape[-2:]),
                             event_dims={"scale_tril": 2}, concentration=concentration,
                             scale_tril=root)

    def sample(self, key, sample_shape=()):
        d = self.event_shape[-1]
        batched = tuple(sample_shape) + self.batch_shape
        normals = standard_draw(key, "normal", batched + (d * (d - 1) // 2,), self.scale_tril)
        below = vec_to_tril_matrix(normals, diagonal=-1)
        dof = self.concentration[..., None] - torch.arange(
            d, dtype=self.scale_tril.dtype, device=self.scale_tril.device)
        diag_sq = 2.0 * standard_gamma(key, torch.broadcast_to(0.5 * dof, batched + (d,)))
        bartlett = below + _embed_diag(torch.sqrt(diag_sq))
        return self.scale_tril @ bartlett

    @validate_sample
    def log_prob(self, value):
        d = self.event_shape[-1]
        df = self.concentration
        value_logdiag = torch.log(torch.diagonal(value, dim1=-2, dim2=-1))
        w_logdet = 2.0 * value_logdiag.sum(-1)
        # trace(S^-1 W) = || L_S^-1 L ||_F^2
        shape = broadcast_shape(tuple(value.shape[:-2]), tuple(self.scale_tril.shape[:-2]))
        whitened = torch.linalg.solve_triangular(
            torch.broadcast_to(self.scale_tril, shape + (d, d)),
            torch.broadcast_to(value, shape + (d, d)), upper=False)
        trace_term = whitened.square().sum((-2, -1))
        wishart_ld = (0.5 * (df - d - 1.0) * w_logdet - 0.5 * trace_term
                      - 0.5 * df * d * math.log(2.0) - df * _tril_logdet(self.scale_tril)
                      - _multigammaln(0.5 * df, d))
        row = torch.arange(1, d + 1, dtype=value_logdiag.dtype, device=value_logdiag.device)
        jacobian = d * math.log(2.0) + ((d - row + 1.0) * value_logdiag).sum(-1)
        return wishart_ld + jacobian


class Wishart(TransformedDistribution):
    """The Wishart distribution over positive definite matrices: ``L L^T``
    for ``L`` drawn from :class:`WishartCholesky`."""

    arg_constraints = WishartCholesky.arg_constraints
    support = constraints.positive_definite
    reparametrized_params = ["scale_matrix", "rate_matrix", "scale_tril"]

    def __init__(self, concentration, scale_matrix=None, rate_matrix=None, scale_tril=None, *,
                 validate_args=None):
        super().__init__(
            WishartCholesky(concentration, scale_matrix, rate_matrix, scale_tril),
            CholeskyTransform().inv, validate_args=validate_args,
        )

    @property
    def concentration(self):
        return self.base_dist.concentration

    @property
    def scale_tril(self):
        return self.base_dist.scale_tril

    @property
    def mean(self):
        root = self.scale_tril
        return self.concentration[..., None, None] * (root @ root.transpose(-2, -1))


class ZeroSumNormal(TransformedDistribution):
    """A normal whose ``len(event_shape)`` event axes each sum to zero: iid
    normals of one size less along each axis through
    :class:`~.transforms.ZeroSumTransform`."""

    arg_constraints = {"scale": constraints.positive}
    reparametrized_params = ["scale"]

    def __init__(self, scale, event_shape, *, validate_args=None):
        ndim = len(event_shape)
        reduced = tuple(size - 1 for size in event_shape)
        self.scale = _as_tensors({"scale": scale})["scale"]
        super().__init__(Normal(torch.zeros_like(self.scale), self.scale).expand(reduced)
                         .to_event(ndim), ZeroSumTransform(ndim), validate_args=validate_args)

    @property
    def support(self):
        return constraints.zero_sum(len(self.event_shape))

    @property
    def mean(self):
        return self.scale.new_zeros(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        shrink = 1.0
        for size in self.event_shape:
            shrink = shrink * (1.0 - 1.0 / size)
        return torch.broadcast_to(self.scale.square() * shrink,
                                  self.batch_shape + self.event_shape)


class MatrixNormal(Distribution):
    """The matrix normal: ``vec(X) ~ MVN(vec(loc), kron(V, U))`` with ``U = R
    R^T`` for ``R = scale_tril_row`` and ``V = C C^T`` for ``C =
    scale_tril_column``; a draw is ``loc + R Z C^T``."""

    arg_constraints = {"loc": constraints.real_vector,
                       "scale_tril_row": constraints.lower_cholesky,
                       "scale_tril_column": constraints.lower_cholesky}
    support = constraints.real_matrix
    has_rsample = True
    reparametrized_params = ["loc", "scale_tril_row", "scale_tril_column"]

    def __init__(self, loc, scale_tril_row, scale_tril_column, validate_args=None):
        self._init_broadcast(
            validate_args, event_shape=tuple(loc.shape[-2:]),
            event_dims={"loc": 2, "scale_tril_row": 2, "scale_tril_column": 2},
            loc=loc, scale_tril_row=scale_tril_row, scale_tril_column=scale_tril_column,
        )

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.shape())

    def sample(self, key, sample_shape=()):
        white = standard_draw(key, "normal", self.shape(sample_shape), self.loc)
        return self.loc + self.scale_tril_row @ white @ self.scale_tril_column.transpose(-2, -1)

    @validate_sample
    def log_prob(self, values):
        n, p = self.event_shape
        log_norm = (p * _tril_logdet(self.scale_tril_row) + n * _tril_logdet(self.scale_tril_column)
                    + 0.5 * n * p * math.log(2.0 * math.pi))

        def whiten(tril, rhs):
            batch = broadcast_shape(tuple(tril.shape[:-2]), tuple(rhs.shape[:-2]))
            return torch.linalg.solve_triangular(
                torch.broadcast_to(tril, batch + tuple(tril.shape[-2:])),
                torch.broadcast_to(rhs, batch + tuple(rhs.shape[-2:])), upper=False)

        row_white = whiten(self.scale_tril_row, values - self.loc)
        both_white = whiten(self.scale_tril_column, row_white.transpose(-2, -1))
        return -0.5 * both_white.square().sum((-2, -1)) - log_norm


class CAR(Distribution):
    """The conditional autoregressive distribution, a multivariate normal
    with precision ``tau (D - rho A)`` for an adjacency matrix ``A`` of
    degrees ``D`` (dense; ``is_sparse=True`` raises as in the JAX package).
    ``log_prob`` takes the log-determinant from the eigenvalues of ``D^-1/2
    A D^-1/2``.  The JAX package computes them on every ``log_prob`` call;
    ``torch.linalg.eigvalsh`` reads its error codes on the host, one sync on
    the card (``chip_smoke.py`` 17c), so here they are computed once per
    instance, from ``adj_matrix`` alone, which takes no derivative in a
    model (it is data).  A draw goes through :class:`MultivariateNormal` by
    the precision matrix."""

    arg_constraints = {"loc": constraints.real_vector,
                       "correlation": constraints.open_interval(-1, 1),
                       "conditional_precision": constraints.positive,
                       "adj_matrix": constraints.dependent(is_discrete=False, event_dim=2)}
    support = constraints.real_vector
    has_rsample = True
    reparametrized_params = ["loc", "correlation", "conditional_precision", "adj_matrix"]

    def __init__(self, loc, correlation, conditional_precision, adj_matrix, *, is_sparse=False,
                 validate_args=None):
        if is_sparse:
            raise NotImplementedError(
                "CAR takes the dense adjacency path: pass a dense (batched) adjacency matrix "
                "and is_sparse=False")
        self.is_sparse = False
        self._init_broadcast(
            validate_args, event_shape=tuple(adj_matrix.shape[-1:]),
            event_dims={"loc": 1, "adj_matrix": 2}, loc=_as_loc_vector(loc, adj_matrix),
            correlation=correlation, conditional_precision=conditional_precision,
            adj_matrix=adj_matrix,
        )

    def sample(self, key, sample_shape=()):
        return MultivariateNormal(self.mean, precision_matrix=self.precision_matrix).sample(
            key, sample_shape)

    @lazy_property
    def _spectrum(self):
        # the symmetric normalisation D^-1/2 A D^-1/2
        d_rsqrt = torch.pow(self.adj_matrix.sum(-1), -0.5)
        return torch.linalg.eigvalsh(
            self.adj_matrix * (d_rsqrt[..., None, :] * d_rsqrt[..., None]))

    @validate_sample
    def log_prob(self, value):
        centered = value - self.loc
        adj = self.adj_matrix
        degree = adj.sum(-1)
        spectrum = self._spectrum
        n = degree.shape[-1]
        rho = self.correlation[..., None]
        log_det = (n * torch.log(self.conditional_precision)
                   + torch.log1p(-rho * spectrum).sum(-1) + torch.log(degree).sum(-1))
        neighbor_sum = _mat_vec(adj, centered)
        quad = self.conditional_precision * (
            centered * (degree * centered - rho * neighbor_sum)).sum(-1)
        return 0.5 * (log_det - quad - n * math.log(2.0 * math.pi))

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.shape())

    @lazy_property
    def precision_matrix(self):
        degree = self.adj_matrix.sum(-1)
        tau = self.conditional_precision[..., None, None]
        rho = self.correlation[..., None, None]
        eye = torch.eye(self.adj_matrix.shape[-1], dtype=degree.dtype, device=degree.device)
        return tau * (degree[..., None] * eye - rho * self.adj_matrix)

    @staticmethod
    def infer_shapes(loc, correlation, conditional_precision, adj_matrix):
        return (broadcast_shape(tuple(loc[:-1]), tuple(correlation), tuple(conditional_precision),
                                tuple(adj_matrix[:-2])), tuple(adj_matrix[-1:]))


def _vmapped(fn, n_dims):
    """``fn`` mapped over ``n_dims`` leading axes of its arguments; a number
    it returns becomes a tensor, which the map broadcasts."""
    def tensors(*args):
        return tuple(v if isinstance(v, torch.Tensor)
                     else torch.as_tensor(v, dtype=args[0].dtype, device=args[0].device)
                     for v in fn(*args))

    for _ in range(n_dims):
        tensors = torch.func.vmap(tensors)
    return tensors


class EulerMaruyama(Distribution):
    """The Euler-Maruyama discretisation of an SDE on the time grid ``t``:
    the whole path is one event.  ``sde_fn(state, time)`` gives the drift
    and the diffusion of one state (it is mapped over the batch and the time
    axis with ``torch.func.vmap``, as the JAX package maps it).
    ``log_prob`` sums the transitions' normal densities with no loop;
    ``sample`` steps through time in a Python loop (the JAX package's
    ``lax.scan``), after drawing the path's normals and then the start from
    ``init_dist``."""

    arg_constraints = {"t": constraints.ordered_vector}

    def __init__(self, t, sde_fn, init_dist, *, validate_args=None):
        if not isinstance(init_dist, Distribution):
            raise TypeError("init_dist must be a Distribution instance")
        self.t = t
        self.sde_fn = sde_fn
        self.init_dist = init_dist
        batch = broadcast_shape(tuple(t.shape[:-1]), tuple(init_dist.batch_shape))
        event = tuple(t.shape[-1:]) + tuple(init_dist.event_shape)
        super().__init__(batch, event, validate_args=validate_args)

    @property
    def support(self):
        return constraints.independent(constraints.real, self.event_dim)

    def sample(self, key, sample_shape=()):
        batch = tuple(sample_shape) + self.batch_shape
        n_steps = self.event_shape[0]
        state_shape = self.event_shape[1:]
        noise = standard_draw(key, "normal", batch + (n_steps - 1,) + state_shape, self.t)
        state = self.init_dist.expand(batch).sample(key)
        grid = torch.broadcast_to(self.t, batch + (n_steps,))
        dts = torch.diff(grid, dim=-1)
        step = _vmapped(self.sde_fn, len(batch))
        path = [state]
        pad = (1,) * len(state_shape)
        for i in range(n_steps - 1):
            drift, diffusion = step(state, grid[..., i])
            dt = dts[..., i].reshape(dts.shape[:-1] + pad)
            state = state + dt * drift + torch.sqrt(dt) * diffusion * noise.select(len(batch), i)
            path.append(state)
        return torch.stack(path, len(batch))

    @validate_sample
    def log_prob(self, value):
        batch = broadcast_shape(tuple(value.shape[: value.dim() - self.event_dim]),
                                self.batch_shape)
        value = torch.broadcast_to(value, batch + self.event_shape)
        n_steps = self.event_shape[0]
        grid = torch.broadcast_to(self.t, batch + (n_steps,))
        time_axis = len(batch)
        prev = value.narrow(time_axis, 0, n_steps - 1)
        curr = value.narrow(time_axis, 1, n_steps - 1)
        drift, diffusion = _vmapped(self.sde_fn, len(batch) + 1)(prev, grid[..., :-1])

        # a drift or diffusion of lower rank than the state (a scalar SDE)
        # is padded on the right to align
        def align(a):
            missing = curr.dim() - a.dim()
            keep = len(batch) + 1
            return a.reshape(tuple(a.shape[:keep]) + (1,) * missing + tuple(a.shape[keep:]))

        drift, diffusion = align(drift), align(diffusion)
        dt = torch.diff(self.t, dim=-1)
        dt = dt.reshape(tuple(dt.shape) + (1,) * (self.event_dim - 1))
        step_mean = prev + dt * drift
        step_sd = torch.sqrt(dt) * diffusion
        trans_ld = Normal(step_mean, step_sd).to_event(self.event_dim).log_prob(curr)
        return trans_ld + self.init_dist.log_prob(value.select(time_axis, 0))


class GaussianStateSpace(Distribution):
    """The linear Gaussian state space ``z_t = A z_{t-1} + eps_t``, ``eps_t ~
    MVN(0, L L^T)``, as one event ``(num_steps, D)``.  ``log_prob`` is the
    innovations' normal density (the map from innovations to states has a
    unit Jacobian) with no loop; ``sample`` and ``variance`` step through
    time in a Python loop, as the JAX package's ``lax.scan`` does.  A
    covariance or precision matrix that is not positive definite gives a NaN
    factor."""

    arg_constraints = {"covariance_matrix": constraints.positive_definite,
                       "precision_matrix": constraints.positive_definite,
                       "scale_tril": constraints.lower_cholesky,
                       "transition_matrix": constraints.real_matrix}
    support = constraints.real_matrix

    def __init__(self, num_steps, transition_matrix, covariance_matrix=None,
                 precision_matrix=None, scale_tril=None, *, validate_args=None):
        assert isinstance(num_steps, int) and num_steps > 0
        assert transition_matrix.dim() == 2
        self.num_steps = num_steps
        self.transition_matrix = transition_matrix
        noise = MultivariateNormal(covariance_matrix=covariance_matrix,
                                   precision_matrix=precision_matrix, scale_tril=scale_tril)
        self.scale_tril = noise.scale_tril
        super().__init__(noise.batch_shape, (num_steps, transition_matrix.shape[-1]),
                         validate_args=validate_args)

    def _innovations(self, value):
        pushed = value[..., :-1, :] @ self.transition_matrix.transpose(-2, -1)
        return torch.cat([value[..., :1, :], value[..., 1:, :] - pushed], -2)

    def sample(self, key, sample_shape=()):
        white = standard_draw(key, "normal", self.shape(sample_shape), self.scale_tril)
        eps = white @ self.scale_tril.transpose(-2, -1)
        state, path = eps[..., 0, :], [eps[..., 0, :]]
        for t in range(1, self.num_steps):
            state = _mat_vec(self.transition_matrix, state) + eps[..., t, :]
            path.append(state)
        return torch.stack(path, -2)

    @validate_sample
    def log_prob(self, value):
        # the noise factor gets a time axis, so that a batch of noise
        # covariances lines up with the batch of the values (the JAX
        # package's lines it up with the time axis and fails)
        noise = MultivariateNormal(self.scale_tril.new_zeros(self.event_shape[-1]),
                                   scale_tril=self.scale_tril[..., None, :, :])
        return noise.log_prob(self._innovations(value)).sum(-1)

    @property
    def mean(self):
        return self.scale_tril.new_zeros(self.batch_shape + self.event_shape)

    @lazy_property
    def covariance_matrix(self):
        return self.scale_tril @ self.scale_tril.transpose(-2, -1)

    @property
    def variance(self):
        roots, root = [], self.scale_tril
        for _ in range(self.num_steps):
            roots.append(root)
            root = self.transition_matrix @ root
        roots = torch.stack(roots)
        marginal = torch.diagonal(roots @ roots.transpose(-2, -1), dim1=-1, dim2=-2)
        return marginal.cumsum(0).swapaxes(0, -2)


class CirculantNormal(Distribution):
    """A multivariate normal with a positive definite circulant covariance,
    diagonalised by the real FFT (``torch.fft.rfft``/``irfft`` with ``n``
    passed explicitly): ``log_prob``, ``sample`` and ``entropy`` take
    ``O(n log n)``."""

    arg_constraints = {"loc": constraints.real_vector,
                       "covariance_row": constraints.positive_definite_circulant_vector,
                       "covariance_rfft": constraints.independent(constraints.positive, 1)}
    support = constraints.real_vector

    def __init__(self, loc, covariance_row=None, covariance_rfft=None, *, validate_args=None):
        assert loc.dim() > 0
        n = loc.shape[-1]
        if (covariance_row is None) == (covariance_rfft is None):
            raise ValueError("Exactly one of covariance_row, covariance_rfft must be specified.")
        if covariance_rfft is None:
            assert covariance_row.shape[-1] == n
            loc, covariance_row = promote_shapes(loc, covariance_row)
            covariance_rfft = torch.fft.rfft(covariance_row).real
            self.covariance_row = covariance_row
        else:
            batch = broadcast_shape(tuple(loc.shape[:-1]), tuple(covariance_rfft.shape[:-1]))
            loc = torch.broadcast_to(loc, batch + (n,))
            covariance_rfft = torch.broadcast_to(covariance_rfft, batch + (n // 2 + 1,))
        self.loc = loc
        self.covariance_rfft = covariance_rfft
        batch = broadcast_shape(tuple(loc.shape[:-1]), tuple(covariance_rfft.shape[:-1]))
        super().__init__(batch, (n,), validate_args=validate_args)

    def _spectrum(self):
        """The covariance's eigenvalues, the weights of the rFFT bins (2 for
        a bin that stands for a conjugate pair, 1 for the DC bin and, where n
        is even, the Nyquist bin) and n."""
        (n,) = self.event_shape
        lam = self.covariance_rfft.clamp(min=0.0)
        m = lam.shape[-1]
        weights = torch.full((m,), 2.0, dtype=lam.dtype, device=lam.device)
        weights[0] = 1.0
        if n % 2 == 0:
            weights[-1] = 1.0
        return lam, weights, n

    def sample(self, key, sample_shape=()):
        lam, _, n = self._spectrum()
        white = standard_draw(key, "normal", tuple(sample_shape) + self.batch_shape + (n,),
                              self.loc)
        # C^{1/2} = F* diag(sqrt(lam)) F / sqrt(n)
        return self.loc + torch.fft.irfft(torch.fft.rfft(white) * torch.sqrt(lam), n=n)

    def _half_log_det(self, lam, weights):
        return 0.5 * (weights * torch.log(lam)).sum(-1)

    @validate_sample
    def log_prob(self, value):
        lam, weights, n = self._spectrum()
        lam = lam.clamp(min=torch.finfo(lam.dtype).tiny)
        power = torch.fft.rfft(value - self.loc).abs().square()
        quad = (weights * power / lam).sum(-1) / n
        return -0.5 * (n * math.log(2.0 * math.pi) + quad) - self._half_log_det(lam, weights)

    @lazy_property
    def covariance_row(self):
        return torch.fft.irfft(self.covariance_rfft, n=self.event_shape[-1])

    @lazy_property
    def covariance_matrix(self):
        (n,) = self.event_shape
        steps = torch.arange(n, device=self.loc.device)
        lag = (steps[:, None] - steps[None, :]) % n
        return self.covariance_row[..., lag]

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.shape())

    @lazy_property
    def variance(self):
        return torch.broadcast_to(self.covariance_row[..., :1], self.shape())

    @staticmethod
    def infer_shapes(loc=(), covariance_row=None, covariance_rfft=None):
        if (covariance_row is None) == (covariance_rfft is None):
            raise ValueError("Exactly one of covariance_row, covariance_rfft must be specified.")
        cov = covariance_rfft if covariance_rfft is not None else covariance_row
        return broadcast_shape(tuple(loc[:-1]), tuple(cov[:-1])), tuple(loc[-1:])

    def entropy(self):
        lam, weights, n = self._spectrum()
        lam = lam.clamp(min=torch.finfo(lam.dtype).tiny)
        return 0.5 * n * (1.0 + math.log(2.0 * math.pi)) + self._half_log_det(lam, weights)
