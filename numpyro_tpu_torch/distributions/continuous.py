"""Continuous distributions (port of ``Normal`` and ``Uniform`` from
``numpyro_tpu/distributions/continuous.py``; the rest are listed in
ROADMAP.md)."""

from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution

__all__ = ["Normal", "Uniform"]

_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


class Normal(Distribution):
    support = constraints.real

    def __init__(self, loc=0.0, scale=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, scale=scale)

    def sample(self, key, sample_shape=()):
        eps = torch.randn(
            self.shape(sample_shape), generator=key,
            device=self.loc.device, dtype=self.loc.dtype,
        )
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - _LOG_SQRT_2PI - torch.log(self.scale)


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
        out = torch.broadcast_shapes(tuple(value.shape), self.batch_shape)
        return (-torch.log(self.high - self.low)).expand(out)
