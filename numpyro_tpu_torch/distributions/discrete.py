"""Discrete distributions (port of ``BernoulliProbs``, ``BernoulliLogits``
and the ``Bernoulli`` factory from ``numpyro_tpu/distributions/discrete.py``;
the rest, and ``enumerate_support``, are listed in ROADMAP.md)."""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution
from .util import lazy_property

__all__ = ["Bernoulli", "BernoulliLogits", "BernoulliProbs"]


def _clamp_probs(probs):
    eps = torch.finfo(probs.dtype)
    return probs.clamp(eps.tiny, 1.0 - eps.eps)


class _BernoulliBase(Distribution):
    support = constraints.boolean

    def sample(self, key, sample_shape=()):
        probs = self.probs
        u = torch.rand(
            tuple(sample_shape) + self.batch_shape, generator=key,
            device=probs.device, dtype=probs.dtype,
        )
        return (u < probs).to(torch.int64)

    def enumerate_support(self, expand=True):
        raise NotImplementedError(
            "enumerate_support is not ported to numpyro_tpu_torch yet (see ROADMAP.md)"
        )


class BernoulliProbs(_BernoulliBase):
    def __init__(self, probs, *, validate_args=None):
        self._init_broadcast(validate_args, probs=probs)

    def log_prob(self, value):
        heads = value * 1.0
        return torch.xlogy(heads, self.probs) + torch.special.xlog1py(1.0 - heads, -self.probs)

    @lazy_property
    def logits(self):
        safe = _clamp_probs(self.probs)
        return torch.log(safe) - torch.log1p(-safe)


class BernoulliLogits(_BernoulliBase):
    def __init__(self, logits=None, *, validate_args=None):
        self._init_broadcast(validate_args, logits=logits)

    def log_prob(self, value):
        # -y log sigmoid(x) - (1 - y) log sigmoid(-x), in the JAX class's order
        # of operations: logaddexp(0, -|x|) + max(x, 0) - x y.  logaddexp(0, -a)
        # is written out as log1p(exp(-a)), which is what it computes for
        # a >= 0: torch.logaddexp has no forward-mode formula and falls back
        # to a slow decomposition under the Taylor proxy's nested JVPs
        x = self.logits
        return -(torch.log1p(torch.exp(-x.abs())) + torch.relu(x) - x * value)

    @lazy_property
    def probs(self):
        return torch.sigmoid(self.logits)


def Bernoulli(probs=None, logits=None, *, validate_args=None):
    if (probs is None) == (logits is None):
        raise ValueError("One of `probs` or `logits` must be specified.")
    if probs is not None:
        return BernoulliProbs(probs, validate_args=validate_args)
    return BernoulliLogits(logits, validate_args=validate_args)
