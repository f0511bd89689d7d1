"""Discrete distributions (port of ``numpyro_tpu/distributions/discrete.py``:
the probs/logits twins of ``Bernoulli``, ``Binomial``, ``Categorical``,
``Multinomial`` and ``Geometric`` with their factories, ``DiscreteUniform``,
``Poisson``, ``OrderedLogistic``, ``NegativeBinomial2`` and the zero-inflated
family, with ``enumerate_support`` where the JAX classes have it).

Every ``log_prob`` is the JAX class's formula written out
(``torch.distributions`` clamps and counts differently), and takes float or
integer counts.  Draws take the run's ``torch.Generator`` (or a draw source,
``util.standard_draw``) and come back as ``int64``: Binomial and Poisson
through PyTorch's own samplers (``util.binomial``, ``util.poisson``), a
Categorical draw as the argmax of the log-probabilities plus Gumbel noise, a
Multinomial one as masked categorical draws; each draws a value per element
under ``torch.func.vmap(randomness="different")``.  ``enumerate_support``
reads an integer parameter (a Binomial's ``total_count``) on the host; one
batched under ``vmap`` raises ``NotImplementedError``, as the JAX package
raises for a traced one."""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution, _as_tensors
from .transforms import _softplus
from .util import (
    betaln,
    binomial,
    broadcast_shape,
    clamp_probs,
    gammainc,
    lazy_property,
    multinomial,
    poisson,
    promote_shapes,
    standard_draw,
)

__all__ = [
    "Bernoulli", "BernoulliLogits", "BernoulliProbs", "Binomial", "BinomialLogits",
    "BinomialProbs", "Categorical", "CategoricalLogits", "CategoricalProbs", "DiscreteUniform",
    "Geometric", "GeometricLogits", "GeometricProbs", "Multinomial", "MultinomialLogits",
    "MultinomialProbs", "NegativeBinomial2", "OrderedLogistic", "Poisson",
    "ZeroInflatedDistribution", "ZeroInflatedLogits", "ZeroInflatedNegativeBinomial2",
    "ZeroInflatedPoisson", "ZeroInflatedProbs",
]

_NN_INT = constraints.nonnegative_integer


def _as_float_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.get_default_dtype())


def _enum_range(count, batch_shape, expand, device):
    """The support ``0 .. count - 1`` on a new leading axis, before the
    batch dims (of size one unless ``expand``)."""
    vals = torch.arange(count, device=device).reshape((-1,) + (1,) * len(batch_shape))
    if expand:
        vals = vals.expand((count,) + tuple(batch_shape))
    return vals


def _logit(probs):
    safe = clamp_probs(probs)
    return torch.log(safe) - torch.log1p(-safe)


def _log_simplex(probs):
    return torch.log(probs).clamp(min=torch.finfo(probs.dtype).min)


def _is_batched(x):
    """Whether ``x`` carries a ``vmap`` batch at any of its functorch levels
    (its value then cannot be read on the host)."""
    functorch = torch._C._functorch
    while functorch.is_functorch_wrapped_tensor(x):
        if functorch.is_batchedtensor(x):
            return True
        x = functorch.get_unwrapped(x)
    return False


def _homogeneous_int(param, what):
    """The one integer value of a parameter, read on the host, or raise: a
    parameter batched under ``vmap`` (the JAX package's traced one) or with
    more than one value has no single support to enumerate."""
    if _is_batched(param):
        raise NotImplementedError(
            f"enumerate_support requires a static {what}, got a batched value")
    lo, hi = int(param.min()), int(param.max())
    if lo != hi:
        raise NotImplementedError(f"Inhomogeneous {what} not supported by `enumerate_support`.")
    return hi


def _log_binom_coeff(n, k):
    """``log C(n, k)`` through the beta function: ``1 / ((n + 1) B(n - k + 1,
    k + 1))``."""
    n = n * 1.0
    return -torch.log1p(n) - betaln(n - k + 1.0, k + 1.0)


def _twin_factory(probs_cls, logits_cls, name):
    """The constructor shared by every probs/logits twin pair."""

    def make(probs=None, logits=None, *, validate_args=None, **kw):
        if (probs is None) == (logits is None):
            raise ValueError("One of `probs` or `logits` must be specified.")
        cls, param = (probs_cls, probs) if probs is not None else (logits_cls, logits)
        return cls(param, validate_args=validate_args, **kw)

    make.__name__ = make.__qualname__ = name
    return make


def _bernoulli_draw(key, probs, shape):
    """``u < probs`` on uniform draws, as ``jax.random.bernoulli`` draws."""
    return standard_draw(key, "uniform", shape, probs) < probs


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
    arg_constraints = {"probs": constraints.unit_interval}

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
    arg_constraints = {"logits": constraints.real}

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
        # the Gumbel-max trick, on a standard draw of kind "gumbel" (a draw
        # source hands in JAX's for CategoricalLogits)
        table = self._log_pmf
        shape = tuple(sample_shape) + self.batch_shape + tuple(table.shape[-1:])
        return torch.argmax(table + standard_draw(key, "gumbel", shape, table), dim=-1)

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


# ---------------------------------------------------------------------------
# Binomial


class _BinomialBase(Distribution):
    has_enumerate_support = True

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return binomial(key, self.probs, self.total_count, shape).to(torch.int64)

    @property
    def mean(self):
        return torch.broadcast_to(self.total_count * self.probs, self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(self.total_count * self.probs * (1.0 - self.probs),
                                  self.batch_shape)

    @property
    def support(self):
        return constraints.integer_interval(0, self.total_count)

    def enumerate_support(self, expand=True):
        n = _homogeneous_int(self.total_count, "total_count")
        return _enum_range(n + 1, self.batch_shape, expand, self.total_count.device)


class BinomialProbs(_BinomialBase):
    arg_constraints = {"probs": constraints.unit_interval, "total_count": _NN_INT}

    def __init__(self, probs, total_count=1, *, validate_args=None):
        self._init_broadcast(validate_args, probs=probs, total_count=total_count)

    def log_prob(self, value):
        heads = value * 1.0
        tails = self.total_count - heads
        return (_log_binom_coeff(self.total_count, value) + torch.xlogy(heads, self.probs)
                + torch.special.xlog1py(tails, -self.probs))

    @lazy_property
    def logits(self):
        return _logit(self.probs)


class BinomialLogits(_BinomialBase):
    arg_constraints = {"logits": constraints.real, "total_count": _NN_INT}

    def __init__(self, logits, total_count=1, *, validate_args=None):
        self._init_broadcast(validate_args, logits=logits, total_count=total_count)

    def log_prob(self, value):
        # k log p + (n - k) log q = k logit - n softplus(logit)
        kernel = value * self.logits - self.total_count * _softplus(self.logits)
        return _log_binom_coeff(self.total_count, value) + kernel

    @lazy_property
    def probs(self):
        return torch.sigmoid(self.logits)


def Binomial(total_count=1, probs=None, logits=None, *, validate_args=None):
    if (probs is None) == (logits is None):
        raise ValueError("One of `probs` or `logits` must be specified.")
    if probs is not None:
        return BinomialProbs(probs, total_count, validate_args=validate_args)
    return BinomialLogits(logits, total_count, validate_args=validate_args)


# ---------------------------------------------------------------------------
# DiscreteUniform


class DiscreteUniform(Distribution):
    """Uniform on the integers ``low .. high``.  A draw is ``low`` plus the
    floor of ``span`` uniforms (the JAX package's ``randint`` draws its own
    bits, so only the distribution of the draws is shared)."""

    arg_constraints = {
        "low": constraints.dependent(is_discrete=True, event_dim=0),
        "high": constraints.dependent(is_discrete=True, event_dim=0),
    }
    has_enumerate_support = True

    def __init__(self, low=0, high=1, *, validate_args=None):
        self._init_broadcast(validate_args, low=low, high=high)
        self._support = constraints.integer_interval(self.low, self.high)

    @property
    def support(self):
        return self._support

    def _span(self):
        return self.high - self.low + 1

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = standard_draw(key, "uniform", shape, self.low)
        span = self._span()
        return (self.low + torch.minimum(torch.floor(u * span), span - 1)).to(torch.int64)

    def log_prob(self, value):
        out = broadcast_shape(tuple(value.shape), self.batch_shape)
        return torch.broadcast_to(-torch.log(self._span()), out)

    def cdf(self, value):
        return ((torch.floor(value) + 1 - self.low) / self._span()).clamp(0.0, 1.0)

    def icdf(self, value):
        return self.low + value * self._span() - 1

    @property
    def mean(self):
        return 0.5 * (self.low + self.high)

    @property
    def variance(self):
        return (self._span().square() - 1.0) / 12.0

    def enumerate_support(self, expand=True):
        lo = _homogeneous_int(self.low, "low")
        hi = _homogeneous_int(self.high, "high")
        return _enum_range(hi - lo + 1, self.batch_shape, expand, self.low.device) + lo

    def entropy(self):
        return torch.broadcast_to(torch.log(self._span()), self.batch_shape)


# ---------------------------------------------------------------------------
# Multinomial


class _MultinomialBase(Distribution):
    def sample(self, key, sample_shape=()):
        return multinomial(key, self.probs, self.total_count,
                           tuple(sample_shape) + self.batch_shape,
                           total_count_max=self.total_count_max)

    def log_prob(self, value):
        n = self.total_count * 1.0
        log_coeff = torch.lgamma(n + 1.0) - torch.lgamma(value + 1.0).sum(-1)
        return log_coeff + self._count_kernel(value)

    @property
    def mean(self):
        return self.total_count.unsqueeze(-1) * self.probs

    @property
    def variance(self):
        return self.total_count.unsqueeze(-1) * self.probs * (1.0 - self.probs)

    @property
    def support(self):
        return constraints.multinomial(self.total_count)


def _with_category_axis(param, name):
    param = param if isinstance(param, torch.Tensor) else torch.as_tensor(
        param, dtype=torch.get_default_dtype())
    if param.dim() == 0:
        raise ValueError(f"`{name}` must carry a category axis.")
    return param


class MultinomialProbs(_MultinomialBase):
    arg_constraints = {"probs": constraints.simplex, "total_count": _NN_INT}

    def __init__(self, probs, total_count=1, *, total_count_max=None, validate_args=None):
        probs = _with_category_axis(probs, "probs")
        self.total_count_max = total_count_max
        self._init_broadcast(validate_args, event_shape=tuple(probs.shape[-1:]),
                             event_dims={"probs": 1}, probs=probs, total_count=total_count)

    def _count_kernel(self, value):
        return torch.xlogy(value * 1.0, self.probs).sum(-1)

    @lazy_property
    def logits(self):
        return _log_simplex(self.probs)


class MultinomialLogits(_MultinomialBase):
    arg_constraints = {"logits": constraints.real_vector, "total_count": _NN_INT}

    def __init__(self, logits, total_count=1, *, total_count_max=None, validate_args=None):
        logits = _with_category_axis(logits, "logits")
        self.total_count_max = total_count_max
        self._init_broadcast(validate_args, event_shape=tuple(logits.shape[-1:]),
                             event_dims={"logits": 1}, logits=logits, total_count=total_count)

    def _count_kernel(self, value):
        norm = self.total_count * torch.logsumexp(self.logits, -1)
        return (value * self.logits).sum(-1) - norm

    @lazy_property
    def probs(self):
        return torch.softmax(self.logits, -1)


def Multinomial(total_count=1, probs=None, logits=None, *, total_count_max=None,
                validate_args=None):
    if (probs is None) == (logits is None):
        raise ValueError("One of `probs` or `logits` must be specified.")
    if probs is not None:
        return MultinomialProbs(probs, total_count, total_count_max=total_count_max,
                                validate_args=validate_args)
    return MultinomialLogits(logits, total_count, total_count_max=total_count_max,
                             validate_args=validate_args)


# ---------------------------------------------------------------------------
# Poisson


class Poisson(Distribution):
    arg_constraints = {"rate": constraints.positive}
    support = _NN_INT

    def __init__(self, rate, *, is_sparse=False, validate_args=None):
        self.is_sparse = is_sparse
        self._init_broadcast(validate_args, rate=rate)

    def sample(self, key, sample_shape=()):
        return poisson(key, self.rate, tuple(sample_shape) + self.batch_shape).to(torch.int64)

    def log_prob(self, value):
        counts = value * 1.0
        return torch.xlogy(counts, self.rate) - torch.lgamma(counts + 1.0) - self.rate

    @property
    def mean(self):
        return torch.broadcast_to(self.rate, self.batch_shape)

    variance = mean

    def cdf(self, value):
        return 1.0 - gammainc(torch.floor(value) + 1.0, self.rate)


# ---------------------------------------------------------------------------
# Geometric


class _GeometricBase(Distribution):
    support = _NN_INT

    def sample(self, key, sample_shape=()):
        # inverse CDF: the failures before the first success
        u = standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape, self.probs)
        return torch.floor(torch.log1p(-u) / torch.log1p(-self.probs)).to(torch.int64)

    @property
    def mean(self):
        return (1.0 - self.probs) / self.probs

    @property
    def variance(self):
        return (1.0 - self.probs) / self.probs.square()


class GeometricProbs(_GeometricBase):
    arg_constraints = {"probs": constraints.unit_interval}

    def __init__(self, probs, *, validate_args=None):
        self._init_broadcast(validate_args, probs=probs)

    def log_prob(self, value):
        # the p = 1, k = 0 corner, where xlog1py(0, -1) would be NaN
        safe_p = torch.where((self.probs == 1) & (value == 0), 0.0, self.probs)
        return torch.special.xlog1py(value, -safe_p) + torch.log(self.probs)

    @lazy_property
    def logits(self):
        return _logit(self.probs)


class GeometricLogits(_GeometricBase):
    arg_constraints = {"logits": constraints.real}

    def __init__(self, logits, *, validate_args=None):
        self._init_broadcast(validate_args, logits=logits)

    def log_prob(self, value):
        return self.logits - (value + 1.0) * _softplus(self.logits)

    @lazy_property
    def probs(self):
        return torch.sigmoid(self.logits)


Geometric = _twin_factory(GeometricProbs, GeometricLogits, "Geometric")


# ---------------------------------------------------------------------------
# OrderedLogistic


class OrderedLogistic(CategoricalProbs):
    """A Categorical over ordered categories from a latent ``predictor`` and
    a vector of ``cutpoints``."""

    arg_constraints = {"predictor": constraints.real, "cutpoints": constraints.ordered_vector}

    def __init__(self, predictor, cutpoints, *, validate_args=None):
        params = _as_tensors({"predictor": predictor, "cutpoints": cutpoints})
        predictor, cutpoints = params["predictor"], params["cutpoints"]
        if predictor.dim() == 0:
            (predictor,) = promote_shapes(predictor, shape=(1,))
        else:
            predictor = predictor.unsqueeze(-1)
        predictor, self.cutpoints = promote_shapes(predictor, cutpoints)
        self.predictor = predictor[..., 0]
        # the mass of a category is a difference of the cumulative sigmoid,
        # with edge columns at 0 and 1
        cum = torch.sigmoid(self.cutpoints - predictor)
        cum = torch.cat([torch.zeros_like(cum[..., :1]), cum, torch.ones_like(cum[..., :1])], -1)
        super().__init__(torch.diff(cum, dim=-1), validate_args=validate_args)

    @staticmethod
    def infer_shapes(predictor, cutpoints):
        return broadcast_shape(tuple(predictor), tuple(cutpoints[:-1])), ()

    def entropy(self):
        raise NotImplementedError("OrderedLogistic.entropy")


# ---------------------------------------------------------------------------
# NegativeBinomial2


def _gamma_poisson_draw(key, concentration, rate, sample_shape):
    """Poisson draws at Gamma(``concentration``, ``rate``) rates, as the
    JAX package's conjugate families draw them (the gamma draw first)."""
    from .continuous import Gamma

    lam = Gamma(concentration, rate).sample(key, sample_shape)
    return poisson(key, lam).to(torch.int64)


class NegativeBinomial2(Distribution):
    """The Gamma-Poisson mixture by its mean and concentration."""

    arg_constraints = {"mean": constraints.positive, "concentration": constraints.positive}
    support = _NN_INT

    def __init__(self, mean, concentration, *, validate_args=None):
        self._init_broadcast(validate_args, _mu=mean, concentration=concentration)

    @property
    def mean(self):
        return torch.broadcast_to(self._mu, self.batch_shape)

    @property
    def variance(self):
        return self.mean * (1.0 + self._mu / self.concentration)

    def sample(self, key, sample_shape=()):
        return _gamma_poisson_draw(key, self.concentration, self.concentration / self._mu,
                                   sample_shape)

    def log_prob(self, value):
        a, mu = self.concentration, self._mu
        log_coeff = -torch.log(a + value) - betaln(a, value + 1.0)
        log_ratio = torch.log(mu) - torch.log(a + mu)
        return log_coeff + a * (torch.log(a) - torch.log(a + mu)) + value * log_ratio


# ---------------------------------------------------------------------------
# Zero inflation


class ZeroInflatedPoisson(Distribution):
    arg_constraints = {"gate": constraints.unit_interval, "rate": constraints.positive}
    support = _NN_INT

    def __init__(self, gate, rate=1.0, *, validate_args=None):
        self._init_broadcast(validate_args, gate=gate, rate=rate)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        zeroed = _bernoulli_draw(key, self.gate, shape)
        counts = poisson(key, self.rate, shape).to(torch.int64)
        return torch.where(zeroed, 0, counts)

    def log_prob(self, value):
        pois = torch.xlogy(value * 1.0, self.rate) - torch.lgamma(value + 1.0) - self.rate
        nonzero = torch.log1p(-self.gate) + pois
        at_zero = torch.logaddexp(torch.log(self.gate), torch.log1p(-self.gate) - self.rate)
        return torch.where(value == 0, at_zero, nonzero)

    @property
    def mean(self):
        return (1.0 - self.gate) * self.rate

    @property
    def variance(self):
        return (1.0 - self.gate) * self.rate * (1.0 + self.rate * self.gate)


class ZeroInflatedProbs(Distribution):
    """A point mass at zero, of probability ``gate``, mixed into a discrete
    distribution with a scalar event."""

    arg_constraints = {"gate": constraints.unit_interval}

    def __init__(self, base_dist, gate, *, validate_args=None):
        if base_dist.event_shape:
            raise ValueError("ZeroInflatedProbs expected empty base_dist.event_shape "
                             f"but got {base_dist.event_shape}")
        assert base_dist.support.is_discrete
        (gate,) = _as_tensors({"gate": gate}).values()
        batch = broadcast_shape(tuple(gate.shape), base_dist.batch_shape)
        (self.gate,) = promote_shapes(gate, shape=batch)
        self.base_dist = base_dist.expand(batch)
        super().__init__(batch, validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        zeroed = _bernoulli_draw(key, self.gate, tuple(sample_shape) + self.batch_shape)
        draws = self.base_dist.sample(key, sample_shape)
        return torch.where(zeroed, 0, draws)

    def log_prob(self, value):
        nonzero = torch.log1p(-self.gate) + self.base_dist.log_prob(value)
        at_zero = torch.log(self.gate + torch.exp(nonzero))
        return torch.where(value == 0, at_zero, nonzero)

    @property
    def support(self):
        return self.base_dist.support

    @lazy_property
    def mean(self):
        return (1.0 - self.gate) * self.base_dist.mean

    @lazy_property
    def variance(self):
        second = self.base_dist.mean.square() + self.base_dist.variance
        return (1.0 - self.gate) * second - self.mean.square()

    @property
    def has_enumerate_support(self):
        return self.base_dist.has_enumerate_support

    def enumerate_support(self, expand=True):
        return self.base_dist.enumerate_support(expand=expand)


class ZeroInflatedLogits(ZeroInflatedProbs):
    """``ZeroInflatedProbs`` with the gate given as logits, its density taken
    in log space."""

    arg_constraints = {"gate_logits": constraints.real}

    def __init__(self, base_dist, gate_logits, *, validate_args=None):
        (gate_logits,) = _as_tensors({"gate_logits": gate_logits}).values()
        batch = broadcast_shape(tuple(gate_logits.shape), base_dist.batch_shape)
        (self.gate_logits,) = promote_shapes(gate_logits, shape=batch)
        super().__init__(base_dist, torch.sigmoid(gate_logits), validate_args=validate_args)

    def log_prob(self, value):
        log_gate = -_softplus(-self.gate_logits)
        shifted = self.base_dist.log_prob(value) - self.gate_logits
        return torch.where(value == 0, _softplus(shifted) + log_gate, shifted + log_gate)


def ZeroInflatedDistribution(base_dist, *, gate=None, gate_logits=None, validate_args=None):
    """A zero-inflated ``base_dist``, by ``gate`` or ``gate_logits``."""
    given = [k for k, v in (("gate", gate), ("gate_logits", gate_logits)) if v is not None]
    if len(given) != 1:
        raise ValueError(f"Exactly one of ['gate', 'gate_logits'] must be specified; got {given}")
    if gate is not None:
        return ZeroInflatedProbs(base_dist, gate, validate_args=validate_args)
    return ZeroInflatedLogits(base_dist, gate_logits, validate_args=validate_args)


def ZeroInflatedNegativeBinomial2(mean, concentration, *, gate=None, gate_logits=None,
                                  validate_args=None):
    return ZeroInflatedDistribution(
        NegativeBinomial2(mean, concentration, validate_args=validate_args),
        gate=gate, gate_logits=gate_logits, validate_args=validate_args)
