"""Distribution base class and structural combinators (port of the parts of
``numpyro_tpu/distributions/distribution.py`` that the covtype slice needs:
``Distribution``, ``ExpandedDistribution``, ``Independent`` / ``to_event``,
``MaskedDistribution`` / ``mask`` and ``Unit``).

Distributions hold tensors and never move them between devices: Python
numbers given as parameters become tensors on the device (and in the dtype)
of the tensor parameters, and samplers draw on the device of their
parameters with the generator they are given.
"""

from __future__ import annotations

import torch

from . import constraints
from .util import broadcast_shape, promote_shapes, sum_rightmost

__all__ = [
    "Distribution", "ExpandedDistribution", "Independent", "MaskedDistribution", "Unit",
]


def _as_tensors(params):
    """Python numbers -> tensors on the device/dtype of the tensor params."""
    like = next((v for v in params.values() if isinstance(v, torch.Tensor)), None)
    kw = (
        {"device": like.device, "dtype": like.dtype}
        if like is not None and like.is_floating_point()
        else {"dtype": torch.get_default_dtype()}
    )
    return {
        k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v, **kw)
        for k, v in params.items()
    }


class Distribution:
    """Base class with the batch/event shape algebra and combinators."""

    support = None

    def __init__(self, batch_shape=(), event_shape=(), *, validate_args=None):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)
        if validate_args:
            raise NotImplementedError(
                "validate_args is not ported to numpyro_tpu_torch yet (see ROADMAP.md)"
            )

    def _init_broadcast(self, validate_args=None, event_shape=(), **params):
        """Promote the named parameters against each other, bind them as
        attributes, and initialise with the broadcast batch shape."""
        params = _as_tensors(params)
        batch = broadcast_shape(*(tuple(v.shape) for v in params.values()))
        for name, v in zip(params, promote_shapes(*params.values(), shape=batch)):
            setattr(self, name, v)
        Distribution.__init__(self, batch, event_shape, validate_args=validate_args)
        return batch

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def event_dim(self):
        return len(self._event_shape)

    def shape(self, sample_shape=()):
        return (*sample_shape, *self._batch_shape, *self._event_shape)

    def sample(self, key, sample_shape=()):
        raise NotImplementedError(f"{type(self).__name__}.sample")

    def sample_with_intermediates(self, key, sample_shape=()):
        return self.sample(key, sample_shape), []

    def __call__(self, *args, **kwargs):
        """Sampler entry point used by the effect-handler stack."""
        key = kwargs.pop("rng_key")
        if not isinstance(key, torch.Generator):
            raise ValueError(
                f"sampling {type(self).__name__} needs a torch.Generator rng_key "
                "(use handlers.seed)"
            )
        if kwargs.pop("sample_intermediates", False):
            return self.sample_with_intermediates(key, *args, **kwargs)
        return self.sample(key, *args, **kwargs)

    def log_prob(self, value):
        raise NotImplementedError(f"{type(self).__name__}.log_prob")

    def expand(self, batch_shape):
        requested = tuple(batch_shape)
        if requested == self._batch_shape:
            return self
        return ExpandedDistribution(self, requested)

    def to_event(self, reinterpreted_batch_ndims=None):
        if reinterpreted_batch_ndims is None:
            reinterpreted_batch_ndims = len(self._batch_shape)
        if reinterpreted_batch_ndims == 0:
            return self
        return Independent(self, reinterpreted_batch_ndims)

    def mask(self, mask):
        return self if mask is True else MaskedDistribution(self, mask)

    @property
    def is_discrete(self):
        return self.support.is_discrete


class _Decorated(Distribution):
    """Delegation base for combinators wrapping one ``base_dist``."""

    @property
    def support(self):
        return self.base_dist.support

    def sample(self, key, sample_shape=()):
        return self.base_dist.sample(key, sample_shape)


class ExpandedDistribution(_Decorated):
    """Broadcast a distribution to a larger batch shape."""

    def __init__(self, base_dist, batch_shape=()):
        requested = tuple(batch_shape)
        while isinstance(base_dist, ExpandedDistribution):
            base_dist = base_dist.base_dist
        target = broadcast_shape(tuple(base_dist.batch_shape), requested)
        if target != requested:
            raise ValueError(
                f"Cannot broadcast distribution of shape {base_dist.batch_shape} "
                f"to shape {requested}"
            )
        self.base_dist = base_dist
        super().__init__(target, base_dist.event_shape)

    def sample(self, key, sample_shape=()):
        # a fresh draw for every expanded entry.  The base sampler only takes
        # a sample_shape prefix, so the new leading dims and the sizes of the
        # grown size-1 base dims are drawn as extra leading axes; each grown
        # axis is then swapped into the place of its size-1 base axis, and the
        # leftover size-1 axes vanish in the final reshape.
        sample_shape = tuple(sample_shape)
        base_batch = self.base_dist.batch_shape
        lead = len(self.batch_shape) - len(base_batch)
        grown = [
            (i, t) for i, (b, t) in enumerate(zip(base_batch, self.batch_shape[lead:]))
            if b == 1 and t != 1
        ]
        fresh = self.batch_shape[:lead] + tuple(t for _, t in grown)
        raw = self.base_dist.sample(key, sample_shape + fresh)
        for j, (i, _) in enumerate(grown):
            raw = raw.swapaxes(
                len(sample_shape) + lead + j, len(sample_shape) + len(fresh) + i
            )
        return raw.reshape(sample_shape + self.batch_shape + self.event_shape)

    def log_prob(self, value):
        lead = max(value.dim() - self.event_dim, 0)
        out = broadcast_shape(self.batch_shape, tuple(value.shape[:lead]))
        return self.base_dist.log_prob(value).expand(out)


class Independent(_Decorated):
    """Reinterpret rightmost batch dims of a distribution as event dims."""

    def __init__(self, base_dist, reinterpreted_batch_ndims, *, validate_args=None):
        if reinterpreted_batch_ndims > len(base_dist.batch_shape):
            raise ValueError(
                "reinterpreted_batch_ndims exceeds batch shape ndims "
                f"({reinterpreted_batch_ndims} > {len(base_dist.batch_shape)})"
            )
        joint = base_dist.batch_shape + base_dist.event_shape
        split = len(joint) - reinterpreted_batch_ndims - base_dist.event_dim
        self.base_dist = base_dist
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims
        super().__init__(joint[:split], joint[split:], validate_args=validate_args)

    @property
    def support(self):
        return constraints.independent(
            self.base_dist.support, self.reinterpreted_batch_ndims
        )

    def log_prob(self, value):
        return sum_rightmost(self.base_dist.log_prob(value), self.reinterpreted_batch_ndims)

    def expand(self, batch_shape):
        inner = tuple(batch_shape) + self.event_shape[: self.reinterpreted_batch_ndims]
        return self.base_dist.expand(inner).to_event(self.reinterpreted_batch_ndims)


class MaskedDistribution(_Decorated):
    """Zero out ``log_prob`` where ``mask`` is False.  A Python bool masks the
    whole distribution without evaluating the base ``log_prob``."""

    def __init__(self, base_dist, mask):
        if isinstance(mask, bool):
            self._mask = mask
        else:
            shape = broadcast_shape(tuple(mask.shape), tuple(base_dist.batch_shape))
            self._mask = mask.to(torch.bool).expand(shape)
            if tuple(base_dist.batch_shape) != shape:
                base_dist = base_dist.expand(shape)
        self.base_dist = base_dist
        super().__init__(base_dist.batch_shape, base_dist.event_shape)

    def _substitute_feasible(self, value):
        """Masked-out entries become values inside the support, so that the
        unused ``log_prob`` there cannot put nan into a gradient."""
        try:
            filler = self.base_dist.support.feasible_like(value)
        except NotImplementedError:
            return value
        keep = self._mask.reshape(tuple(self._mask.shape) + (1,) * self.event_dim)
        return torch.where(keep, value, filler)

    def log_prob(self, value):
        if self._mask is True:
            return self.base_dist.log_prob(value)
        if self._mask is False:
            lead = max(value.dim() - self.event_dim, 0)
            shape = broadcast_shape(self.batch_shape, tuple(value.shape[:lead]))
            return value.new_zeros(shape, dtype=_float_dtype(value))
        lp = self.base_dist.log_prob(self._substitute_feasible(value))
        return torch.where(self._mask, lp, torch.zeros_like(lp))


def _float_dtype(value):
    return value.dtype if value.is_floating_point() else torch.get_default_dtype()


class Unit(Distribution):
    """Trivial nonnormalized distribution over the empty event: the carrier
    of a bare ``log_factor`` (used by the ``factor`` primitive)."""

    support = constraints.real

    def __init__(self, log_factor, *, validate_args=None):
        self.log_factor = log_factor
        super().__init__(tuple(log_factor.shape), (0,), validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        return self.log_factor.new_empty(self.shape(sample_shape))

    def log_prob(self, value):
        out = broadcast_shape(self.batch_shape, tuple(value.shape[:-1]))
        return self.log_factor.expand(out)
