"""Continuous distributions (port of ``Normal``, ``Cauchy``, ``StudentT``,
``HalfCauchy``, ``HalfNormal``, ``Uniform``, ``Exponential``, ``Dirichlet``,
``MultivariateNormal``, ``LowRankMultivariateNormal`` and
``GaussianRandomWalk`` from
``numpyro_tpu/distributions/continuous.py``; the rest are listed in
ROADMAP.md).

As in the JAX package, the location-scale families derive from ``_LocScale``,
which owns the affine bookkeeping, and each family supplies its standardized
kernel; the half distributions fold a zero-centred family at zero.  A draw is
made on the device of its generator, where 0-dim parameters (a Python number
becomes one on the CPU) broadcast as they are."""

from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution, _as_tensors
from .util import broadcast_shape, lazy_property, promote_shapes

__all__ = [
    "Cauchy", "Dirichlet", "Exponential", "GaussianRandomWalk", "HalfCauchy", "HalfNormal",
    "LowRankMultivariateNormal", "MultivariateNormal", "Normal", "StudentT", "Uniform",
]

_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
_LOG_2 = 0.6931471805599453


class _LocScale(Distribution):
    """x = loc + scale * z for a fixed standardized kernel z."""

    support = constraints.real
    has_rsample = True
    # standardized moments (None: undefined)
    _z_mean = 0.0
    _z_var = 1.0

    def __init__(self, loc=0.0, scale=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale)

    def _standardize(self, x):
        return (x - self.loc) / self.scale

    def sample(self, key, sample_shape=()):
        z = self._z_sample(key, self.shape(sample_shape))
        return self.loc + self.scale * z

    def log_prob(self, value):
        return self._z_log_density(self._standardize(value)) - torch.log(self.scale)

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


class Normal(_LocScale):
    def _z_sample(self, key, shape):
        return torch.randn(shape, generator=key, device=key.device, dtype=self.loc.dtype)

    def _z_log_density(self, z):
        return -0.5 * z * z - _LOG_SQRT_2PI

    def _z_icdf(self, q):
        return torch.special.ndtri(q)


class Cauchy(_LocScale):
    _z_mean = None
    _z_var = None

    def _z_sample(self, key, shape):
        u = torch.rand(shape, generator=key, device=key.device, dtype=self.loc.dtype)
        return torch.tan(math.pi * (u - 0.5))

    def _z_log_density(self, z):
        return -math.log(math.pi) - torch.log1p(z * z)

    def _z_icdf(self, q):
        return torch.tan(math.pi * (q - 0.5))


def _betaln_half(a):
    """``betaln(a, 1/2)`` through ``lgamma``, which PyTorch has (it has no
    ``betaln``).  Computed in float64 and returned in ``a``'s dtype: in float32
    the difference of two ``lgamma`` values of a few thousand loses the
    digits that the JAX package's ``betaln`` keeps."""
    a64 = a.to(torch.float64)
    out = torch.lgamma(a64) + 0.5 * math.log(math.pi) - torch.lgamma(a64 + 0.5)
    return out.to(a.dtype)


class StudentT(_LocScale):
    """Student's t with ``df`` degrees of freedom.

    A draw is ``normal * sqrt(df / chi2)``, the chi-square made as twice a
    ``torch._standard_gamma`` draw of ``df / 2``: that op takes the run's
    generator, and under ``torch.func.vmap(randomness="different")`` each
    element draws its own value.  ``cdf`` needs the regularized incomplete
    beta function, which PyTorch lacks, so it raises as ``icdf`` does in the
    JAX package (ROADMAP.md)."""

    def __init__(self, df, loc=0.0, scale=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, df=df, loc=loc, scale=scale)

    def _z_sample(self, key, shape):
        kw = {"generator": key, "device": key.device, "dtype": self.loc.dtype}
        eps = torch.randn(shape, **kw)
        half_df = torch.broadcast_to(0.5 * self.df, shape).to(key.device)
        chi2 = 2.0 * torch._standard_gamma(half_df, generator=key)
        return eps * torch.sqrt(self.df / chi2)

    def _z_log_density(self, z):
        half_df = 0.5 * self.df
        log_norm = 0.5 * torch.log(self.df) + _betaln_half(half_df)
        return -(half_df + 0.5) * torch.log1p(z * z / self.df) - log_norm

    def cdf(self, value):
        raise NotImplementedError(
            "StudentT.cdf needs betainc, which PyTorch lacks; not ported to "
            "numpyro_tpu_torch (see ROADMAP.md)"
        )

    def icdf(self, q):
        raise NotImplementedError

    @property
    def mean(self):
        z_mean = torch.where(self.df > 1.0, 0.0, math.nan)
        return torch.broadcast_to(self.loc + self.scale * z_mean, self.batch_shape)

    @property
    def variance(self):
        heavy = torch.where(self.df > 2.0, self.df / (self.df - 2.0), math.inf)
        z_var = torch.where(self.df > 1.0, heavy, math.nan)
        return torch.broadcast_to(self.scale**2 * z_var, self.batch_shape)

    def entropy(self):
        half_df = 0.5 * self.df
        half_up = half_df + 0.5
        z_entropy = (
            half_up * (torch.digamma(half_up) - torch.digamma(half_df))
            + 0.5 * torch.log(self.df)
            + _betaln_half(half_df)
        )
        return torch.broadcast_to(z_entropy + torch.log(self.scale), self.batch_shape)


class _FoldedAtZero(Distribution):
    """|X| for a zero-centred symmetric loc-scale X; subclasses set
    ``_full_cls``."""

    support = constraints.positive
    has_rsample = True

    def __init__(self, scale=1.0, *, validate_args=None):
        self._mirror = self._full_cls(0.0, scale)
        self.scale = self._mirror.scale
        super().__init__(self._mirror.batch_shape, validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        return torch.abs(self._mirror.sample(key, sample_shape))

    def log_prob(self, value):
        return _LOG_2 + self._mirror.log_prob(value)


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


class Uniform(Distribution):
    has_rsample = True

    def __init__(self, low=0.0, high=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, low=low, high=high)
        self._support = constraints.interval(self.low, self.high)

    @property
    def support(self):
        return self._support

    def sample(self, key, sample_shape=()):
        u = torch.rand(
            tuple(sample_shape) + self.batch_shape, generator=key,
            device=key.device, dtype=self.low.dtype,
        )
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        out = broadcast_shape(tuple(value.shape), self.batch_shape)
        return (-torch.log(self.high - self.low)).expand(out)


class Exponential(Distribution):
    support = constraints.positive
    has_rsample = True

    def __init__(self, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, rate=rate)

    def sample(self, key, sample_shape=()):
        u = torch.rand(self.shape(sample_shape), generator=key, device=key.device,
                       dtype=self.rate.dtype)
        return -torch.log1p(-u) / self.rate

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


class Dirichlet(Distribution):
    """The Dirichlet distribution on the simplex of the last axis of
    ``concentration``.

    A draw normalizes ``torch._standard_gamma`` draws, which take the run's
    generator (one value per element under ``torch.func.vmap(randomness=
    "different")``), and is clipped into ``[tiny, 1 - eps]`` as the JAX
    package clips its draws."""

    support = constraints.simplex

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
        alpha = torch.broadcast_to(self.concentration, self.shape(sample_shape)).to(key.device)
        gammas = torch._standard_gamma(alpha, generator=key)
        draws = gammas / gammas.sum(-1, keepdim=True)
        info = torch.finfo(draws.dtype)
        return draws.clamp(min=info.tiny, max=1.0 - info.eps)

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


def _tril_logdet(scale_tril):
    return torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)).sum(-1)


class MultivariateNormal(Distribution):
    """Normal over vectors, held by the Cholesky factor of its covariance
    (``scale_tril``; a covariance or precision matrix is factored once)."""

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
            self.scale_tril = torch.linalg.cholesky(matrix)
        elif precision_matrix is not None:
            self.precision_matrix = matrix
            # chol(P^-1) from the Cholesky factor of P with both axes reversed
            flipped = torch.linalg.cholesky(matrix.flip(-2, -1))
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
        white = torch.randn(
            self.shape(sample_shape), generator=key, device=key.device, dtype=self.loc.dtype
        )
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
        return torch.linalg.cholesky(_add_diag(cap, cap.new_ones(())))

    @lazy_property
    def covariance_matrix(self):
        return _add_diag(self.cov_factor @ self.cov_factor.transpose(-2, -1), self.cov_diag)

    @lazy_property
    def scale_tril(self):
        return torch.linalg.cholesky(self.covariance_matrix)

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
