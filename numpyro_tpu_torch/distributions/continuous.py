"""Continuous distributions (port of ``Normal``, ``Cauchy``, ``HalfCauchy``,
``HalfNormal`` and ``Uniform`` from ``numpyro_tpu/distributions/continuous.py``;
the rest are listed in ROADMAP.md).

As in the JAX package, the location-scale families derive from ``_LocScale``,
which owns the affine bookkeeping, and each family supplies its standardized
kernel; the half distributions fold a zero-centred family at zero."""

from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution
from .util import broadcast_shape

__all__ = ["Cauchy", "HalfCauchy", "HalfNormal", "Normal", "Uniform"]

_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
_LOG_2 = 0.6931471805599453


class _LocScale(Distribution):
    """x = loc + scale * z for a fixed standardized kernel z."""

    support = constraints.real
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
        return torch.randn(shape, generator=key, device=self.loc.device, dtype=self.loc.dtype)

    def _z_log_density(self, z):
        return -0.5 * z * z - _LOG_SQRT_2PI


class Cauchy(_LocScale):
    _z_mean = None
    _z_var = None

    def _z_sample(self, key, shape):
        u = torch.rand(shape, generator=key, device=self.loc.device, dtype=self.loc.dtype)
        return torch.tan(math.pi * (u - 0.5))

    def _z_log_density(self, z):
        return -math.log(math.pi) - torch.log1p(z * z)


class _FoldedAtZero(Distribution):
    """|X| for a zero-centred symmetric loc-scale X; subclasses set
    ``_full_cls``."""

    support = constraints.positive

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
    def __init__(self, low=0.0, high=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, low=low, high=high)
        self._support = constraints.interval(self.low, self.high)

    @property
    def support(self):
        return self._support

    def sample(self, key, sample_shape=()):
        u = torch.rand(
            tuple(sample_shape) + self.batch_shape, generator=key,
            device=self.low.device, dtype=self.low.dtype,
        )
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        out = broadcast_shape(tuple(value.shape), self.batch_shape)
        return (-torch.log(self.high - self.low)).expand(out)
