"""Discrete distributions (port of ``BernoulliProbs``, ``BernoulliLogits``,
``CategoricalProbs``, ``CategoricalLogits`` and their ``Bernoulli`` and
``Categorical`` factories from ``numpyro_tpu/distributions/discrete.py``,
with ``enumerate_support``; the rest are listed in ROADMAP.md).

Draws take the run's ``torch.Generator``: a Categorical draw is the argmax of
the log-probabilities plus Gumbel noise made from ``torch.rand``, which draws
a value per element under ``torch.func.vmap(randomness="different")``."""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution
from .transforms import _softplus
from .util import broadcast_shape, clamp_probs, lazy_property

__all__ = [
    "Bernoulli", "BernoulliLogits", "BernoulliProbs", "Categorical", "CategoricalLogits",
    "CategoricalProbs",
]


def _as_float_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.get_default_dtype())


def _enum_range(count, batch_shape, expand, device):
    """The support ``0 .. count - 1`` on a new leading axis, before the
    batch dims (of size one unless ``expand``)."""
    vals = torch.arange(count, device=device).reshape((-1,) + (1,) * len(batch_shape))
    if expand:
        vals = vals.expand((count,) + tuple(batch_shape))
    return vals


class _BernoulliBase(Distribution):
    support = constraints.boolean
    has_enumerate_support = True

    def sample(self, key, sample_shape=()):
        probs = self.probs
        u = torch.rand(
            tuple(sample_shape) + self.batch_shape, generator=key,
            device=key.device, dtype=probs.dtype,
        )
        return (u < probs).to(torch.int64)

    @property
    def mean(self):
        return torch.broadcast_to(self.probs, self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(self.probs * (1.0 - self.probs), self.batch_shape)

    def enumerate_support(self, expand=True):
        param = self.__dict__.get("probs", self.__dict__.get("logits"))
        return _enum_range(2, self.batch_shape, expand, param.device)


class BernoulliProbs(_BernoulliBase):
    def __init__(self, probs, *, validate_args=None):
        self._init_broadcast(validate_args, probs=probs)

    def log_prob(self, value):
        heads = value * 1.0
        return torch.xlogy(heads, self.probs) + torch.special.xlog1py(1.0 - heads, -self.probs)

    @lazy_property
    def logits(self):
        safe = clamp_probs(self.probs)
        return torch.log(safe) - torch.log1p(-safe)

    def entropy(self):
        p = clamp_probs(self.probs)
        return -p * torch.log(p) - (1.0 - p) * torch.log1p(-p)


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

    def entropy(self):
        p = torch.sigmoid(self.logits)
        return p * _softplus(-self.logits) + (1.0 - p) * _softplus(self.logits)


def Bernoulli(probs=None, logits=None, *, validate_args=None):
    if (probs is None) == (logits is None):
        raise ValueError("One of `probs` or `logits` must be specified.")
    if probs is not None:
        return BernoulliProbs(probs, validate_args=validate_args)
    return BernoulliLogits(logits, validate_args=validate_args)


class _CategoricalBase(Distribution):
    """A category index per batch element; the category axis is the last
    axis of the parameter and no dim of the batch."""

    has_enumerate_support = True

    def _param(self):
        raise NotImplementedError

    @property
    def support(self):
        return constraints.integer_interval(0, self._param().shape[-1] - 1)

    def sample(self, key, sample_shape=()):
        table = self._log_pmf
        shape = tuple(sample_shape) + self.batch_shape + tuple(table.shape[-1:])
        u = torch.rand(shape, generator=key, device=key.device, dtype=table.dtype)
        return torch.argmax(table - torch.log(-torch.log(u)), dim=-1)

    def log_prob(self, value):
        table = self._log_pmf
        batch = broadcast_shape(tuple(value.shape), self.batch_shape)
        table = table.expand(batch + tuple(table.shape[-1:]))
        idx = value.expand(batch).long().unsqueeze(-1)
        return torch.gather(table, -1, idx).squeeze(-1)

    def enumerate_support(self, expand=True):
        param = self._param()
        return _enum_range(param.shape[-1], self.batch_shape, expand, param.device)

    @property
    def mean(self):
        return torch.full(self.batch_shape, torch.nan, dtype=self._param().dtype,
                          device=self._param().device)

    @property
    def variance(self):
        return torch.full(self.batch_shape, torch.nan, dtype=self._param().dtype,
                          device=self._param().device)

    def entropy(self):
        table = self._log_pmf
        return -(torch.exp(table) * table).sum(-1)


class CategoricalProbs(_CategoricalBase):
    def __init__(self, probs, *, validate_args=None):
        probs = _as_float_tensor(probs)
        if probs.dim() == 0:
            raise ValueError("`probs` must carry a category axis.")
        self._init_broadcast(validate_args, event_dims={"probs": 1}, probs=probs)

    def _param(self):
        return self.probs

    @lazy_property
    def _log_pmf(self):
        return torch.log(self.probs).clamp(min=torch.finfo(self.probs.dtype).min)

    @property
    def logits(self):
        return self._log_pmf

    def entropy(self):
        p = clamp_probs(self.probs)
        return -(p * torch.log(p)).sum(-1)


class CategoricalLogits(_CategoricalBase):
    def __init__(self, logits, *, validate_args=None):
        logits = _as_float_tensor(logits)
        if logits.dim() == 0:
            raise ValueError("`logits` must carry a category axis.")
        self._init_broadcast(validate_args, event_dims={"logits": 1}, logits=logits)

    def _param(self):
        return self.logits

    @lazy_property
    def _log_pmf(self):
        return self.logits - torch.logsumexp(self.logits, -1, keepdim=True)

    @lazy_property
    def probs(self):
        return torch.softmax(self.logits, -1)


def Categorical(probs=None, logits=None, *, validate_args=None):
    if (probs is None) == (logits is None):
        raise ValueError("One of `probs` or `logits` must be specified.")
    if probs is not None:
        return CategoricalProbs(probs, validate_args=validate_args)
    return CategoricalLogits(logits, validate_args=validate_args)
