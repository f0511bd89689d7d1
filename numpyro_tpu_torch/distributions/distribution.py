"""Distribution base class and structural combinators (port of the parts of
``numpyro_tpu/distributions/distribution.py`` that the ported slices need:
``Distribution``, ``ExpandedDistribution``, ``Independent`` / ``to_event``,
``MaskedDistribution`` / ``mask``, ``TransformedDistribution``,
``FoldedDistribution``, ``Delta``, ``Unit`` and ``ImproperUniform``, with
``DistributionLike`` and the validation switches ``enable_validation`` and
``validation_enabled``).

A draw is differentiable in the parameters wherever ``has_rsample`` holds:
samplers push standard draws through the parameters with tensor ops, so
autograd and ``torch.func`` see the reparameterisation.

Distributions hold tensors and never move them between devices: Python
numbers given as parameters become tensors on the device (and in the dtype)
of the tensor parameters, and samplers draw on the device of their
parameters with the generator they are given.

Validation (``validate_args=True``, or ``enable_validation()`` for every
instance) checks the parameters against ``arg_constraints`` when an instance
is made and gives ``-inf`` to a value outside the support in every
``log_prob`` that carries ``@validate_sample``, through ``torch.where``.  The
``ValueError`` on a bad parameter and the warning on an out-of-support value
read the check on the host, so only where the JAX package reads it: outside
a ``torch.func`` transform, and never for a tensor batched under ``vmap``.
The JAX package's NUTS potential runs under ``jit``, which stages every
operation (nothing is read, not even a constant's check); the port's runs
under ``vmap(grad(...))``, where nothing is read either.  With validation
off, the default, nothing is checked or read.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Protocol, runtime_checkable

import torch

from . import constraints
from .transforms import AbsTransform, ComposeTransform, Transform
from .util import (
    broadcast_shape, in_transform, lazy_property, promote_shapes, sum_rightmost, validate_sample,
)

__all__ = [
    "Delta", "Distribution", "DistributionLike", "ExpandedDistribution", "FoldedDistribution",
    "ImproperUniform", "Independent", "MaskedDistribution", "TransformedDistribution", "Unit",
    "enable_validation", "validation_enabled",
]

_VALIDATION_ENABLED = False


def enable_validation(is_validate=True):
    """Switch the validation of every distribution made from now on."""
    global _VALIDATION_ENABLED
    _VALIDATION_ENABLED = is_validate
    Distribution.set_default_validate_args(is_validate)


@contextmanager
def validation_enabled(is_validate=True):
    """``enable_validation(is_validate)`` inside the block, the earlier
    setting after it."""
    old = _VALIDATION_ENABLED
    enable_validation(is_validate)
    try:
        yield
    finally:
        enable_validation(old)


def _all_true(ok):
    """Whether every entry of a constraint's answer holds, read on the host;
    ``True`` inside a ``torch.func`` transform, where it is not read."""
    if not isinstance(ok, torch.Tensor):
        return bool(ok)
    return in_transform() or bool(ok.all())


@runtime_checkable
class DistributionLike(Protocol):
    """The structural type of what the inference code takes as a
    distribution: a :class:`Distribution`, or any object with the same
    surface (``isinstance(obj, DistributionLike)`` checks it)."""

    @property
    def batch_shape(self) -> tuple:
        ...

    @property
    def event_shape(self) -> tuple:
        ...

    @property
    def event_dim(self) -> int:
        ...

    def sample(self, key, sample_shape=()):
        ...

    def log_prob(self, value):
        ...

    @property
    def mean(self):
        ...

    @property
    def variance(self):
        ...

    def cdf(self, value):
        ...

    def icdf(self, q):
        ...


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
    # the constraint of each parameter
    arg_constraints = {}
    # whether draws are differentiable in the parameters
    has_rsample = False
    # whether ``enumerate_support`` lists the support (finite discrete ones)
    has_enumerate_support = False
    # the default of every instance; ``enable_validation`` sets it
    _validate_args = False

    @staticmethod
    def set_default_validate_args(value):
        Distribution._validate_args = value

    def __init__(self, batch_shape=(), event_shape=(), *, validate_args=None):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)
        if validate_args is not None:
            self._validate_args = validate_args
        if self._validate_args:
            self._assert_param_constraints()

    def _assert_param_constraints(self):
        for name, constraint in self.arg_constraints.items():
            if isinstance(constraint, constraints._Dependent):
                continue
            descriptor = getattr(type(self), name, None)
            if isinstance(descriptor, lazy_property) and name not in self.__dict__:
                continue  # a lazy parameter is not computed to be checked
            # a parametrization the instance does not hold is not checked
            # (the JAX package raises AttributeError there)
            value = getattr(self, name, None)
            if value is None:
                continue
            if not _all_true(constraint(value)):
                raise ValueError(f"{type(self).__name__}: invalid {name} parameter")

    def _validate_sample(self, value):
        ok = self.support(value)
        if not _all_true(ok):
            warnings.warn(
                f"Out-of-support values provided to log_prob of {type(self).__name__}",
                stacklevel=2,
            )
        return ok

    def _init_broadcast(self, validate_args=None, event_shape=(), event_dims=None, **params):
        """Promote the named parameters against each other, bind them as
        attributes, and initialise with the broadcast batch shape.
        ``event_dims`` maps a parameter to the count of its trailing dims that
        are not batch dims (a Categorical's category axis); such a parameter
        is only left-padded."""
        params = _as_tensors(params)
        event_dims = event_dims or {}
        batch_shapes = {
            name: tuple(v.shape)[: v.dim() - event_dims.get(name, 0)]
            for name, v in params.items()
        }
        batch = broadcast_shape(*batch_shapes.values())
        for name, v in params.items():
            pad = len(batch) - len(batch_shapes[name])
            setattr(self, name, v.reshape((1,) * pad + tuple(v.shape)) if pad else v)
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

    def rsample(self, key, sample_shape=()):
        if self.has_rsample:
            return self.sample(key, sample_shape)
        raise NotImplementedError(f"{type(self).__name__} is not fully reparametrized")

    def __call__(self, *args, **kwargs):
        """Sampler entry point used by the effect-handler stack."""
        key = kwargs.pop("rng_key")
        if not isinstance(key, torch.Generator) and not hasattr(key, "normals"):
            raise ValueError(
                f"sampling {type(self).__name__} needs a torch.Generator rng_key "
                "(use handlers.seed) or a draw source"
            )
        if kwargs.pop("sample_intermediates", False):
            return self.sample_with_intermediates(key, *args, **kwargs)
        return self.sample(key, *args, **kwargs)

    def log_prob(self, value):
        raise NotImplementedError(f"{type(self).__name__}.log_prob")

    @property
    def mean(self):
        raise NotImplementedError(f"{type(self).__name__}.mean")

    @property
    def variance(self):
        raise NotImplementedError(f"{type(self).__name__}.variance")

    def cdf(self, value):
        raise NotImplementedError(f"{type(self).__name__}.cdf")

    def icdf(self, q):
        raise NotImplementedError(f"{type(self).__name__}.icdf")

    def entropy(self):
        raise NotImplementedError(f"{type(self).__name__}.entropy")

    def enumerate_support(self, expand=True):
        raise NotImplementedError(f"{type(self).__name__}.enumerate_support")

    @classmethod
    def infer_shapes(cls, *args, **kwargs):
        raise NotImplementedError(f"{cls.__name__}.infer_shapes")

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

    @property
    def has_rsample(self):
        return self.base_dist.has_rsample

    @property
    def has_enumerate_support(self):
        return self.base_dist.has_enumerate_support

    @property
    def mean(self):
        return self.base_dist.mean

    @property
    def variance(self):
        return self.base_dist.variance

    def sample(self, key, sample_shape=()):
        return self.base_dist.sample(key, sample_shape)

    def enumerate_support(self, expand=True):
        return self.base_dist.enumerate_support(expand=expand)


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

    def cdf(self, value):
        # elementwise under broadcasting, so the base's answers
        return self.base_dist.cdf(value)

    def icdf(self, q):
        return self.base_dist.icdf(q)

    @property
    def mean(self):
        return torch.broadcast_to(self.base_dist.mean, self.shape())

    @property
    def variance(self):
        return torch.broadcast_to(self.base_dist.variance, self.shape())

    def entropy(self):
        return torch.broadcast_to(self.base_dist.entropy(), self.batch_shape)

    def enumerate_support(self, expand=True):
        samples = self.base_dist.enumerate_support(expand=False)
        enum_shape = tuple(samples.shape[:1])
        samples = samples.reshape(enum_shape + (1,) * len(self.batch_shape))
        if expand:
            samples = samples.expand(enum_shape + self.batch_shape)
        return samples


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

    def entropy(self):
        return sum_rightmost(self.base_dist.entropy(), self.reinterpreted_batch_ndims)

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


def _pushforward(base_dist, transforms):
    """The base distribution (expanded or with batch dims reinterpreted as
    needed) and the output batch/event split of ``base_dist`` pushed through
    ``transforms``."""
    chain = ComposeTransform(transforms)
    out_shape = chain.forward_shape(base_dist.shape())
    needed = chain.inverse_shape(out_shape)
    if needed != base_dist.shape():
        cut = len(needed) - base_dist.event_dim
        base_dist = base_dist.expand(needed[:cut])
    extra_event = chain.domain.event_dim - base_dist.event_dim
    if extra_event > 0:
        base_dist = base_dist.to_event(extra_event)
    split = len(out_shape) - chain.codomain.event_dim
    return base_dist, out_shape[:split], out_shape[split:]


class TransformedDistribution(Distribution):
    """Pushforward of a base distribution through bijective transforms."""

    def __init__(self, base_distribution, transforms, *, validate_args=None):
        if isinstance(transforms, Transform):
            transforms = [transforms]
        if not isinstance(transforms, list) or not all(
            isinstance(t, Transform) for t in transforms
        ):
            raise ValueError("transforms must be a Transform or list thereof")
        if isinstance(base_distribution, TransformedDistribution):
            transforms = base_distribution.transforms + transforms
            base_distribution = base_distribution.base_dist
        self.transforms = transforms
        self.base_dist, batch_shape, event_shape = _pushforward(base_distribution, transforms)
        super().__init__(batch_shape, event_shape, validate_args=validate_args)

    @property
    def has_rsample(self):
        return self.base_dist.has_rsample

    @property
    def support(self):
        last = self.transforms[-1].codomain
        extra = self.event_dim - last.event_dim
        return constraints.independent(last, extra) if extra else last

    def sample(self, key, sample_shape=()):
        x = self.base_dist.sample(key, sample_shape)
        for t in self.transforms:
            x = t(x)
        return x

    def sample_with_intermediates(self, key, sample_shape=()):
        x = self.base_dist.sample(key, sample_shape)
        intermediates = []
        for transform in self.transforms:
            x_in = x
            x, t_inter = transform.call_with_intermediates(x)
            intermediates.append([x_in, t_inter])
        return x, intermediates

    @validate_sample
    def log_prob(self, value, intermediates=None):
        """With the ``intermediates`` of :meth:`sample_with_intermediates` the
        transforms' inputs are read, not recomputed through the inverses."""
        if intermediates is not None and len(intermediates) != len(self.transforms):
            raise ValueError("intermediates length mismatch")
        # walk codomain -> domain, tracking how many of the current event
        # dims each transform is batched over
        event_dim, total, y = self.event_dim, 0.0, value
        for idx in range(len(self.transforms) - 1, -1, -1):
            t = self.transforms[idx]
            if intermediates is None:
                x, cached = t.inv(y), None
            else:
                x, cached = intermediates[idx]
            extra = event_dim - t.codomain.event_dim
            total = total - sum_rightmost(t.log_abs_det_jacobian(x, y, cached), extra)
            event_dim = t.domain.event_dim + extra
            y = x
        return total + sum_rightmost(
            self.base_dist.log_prob(y), event_dim - self.base_dist.event_dim
        )

    @property
    def mean(self):
        raise NotImplementedError(
            f"{type(self).__name__}.mean: the mean of a generic pushforward is unavailable")

    @property
    def variance(self):
        raise NotImplementedError(
            f"{type(self).__name__}.variance: the variance of a generic pushforward is "
            "unavailable")


class FoldedDistribution(TransformedDistribution):
    """``|X|`` for a univariate ``X``: ``p(v) = p_X(v) + p_X(-v)``."""

    support = constraints.positive

    def __init__(self, base_dist, *, validate_args=None):
        if base_dist.event_shape:
            raise ValueError("Only univariate distributions can be folded.")
        super().__init__(base_dist, AbsTransform(), validate_args=validate_args)

    @validate_sample
    def log_prob(self, value):
        # the two signs on a new leading axis, summed out in log space
        signs = torch.tensor([1.0, -1.0], dtype=_float_dtype(value), device=value.device)
        signs = signs.reshape((2,) + (1,) * max(len(self.batch_shape), value.dim()))
        return torch.logsumexp(self.base_dist.log_prob(signs * value), 0)


class Delta(Distribution):
    """A point mass at ``v`` (its rightmost ``event_dim`` dims make one
    value), carrying ``log_density`` as its log-probability there."""

    arg_constraints = {"v": constraints.dependent(is_discrete=False),
                       "log_density": constraints.real}
    has_rsample = True

    def __init__(self, v=0.0, log_density=0.0, event_dim=0, *, validate_args=None):
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v, dtype=torch.get_default_dtype())
        vshape = tuple(v.shape)
        if event_dim > len(vshape):
            raise ValueError(
                f"Expected event_dim <= v.dim(), actual {event_dim} vs {len(vshape)}"
            )
        split = len(vshape) - event_dim
        self.v = v
        if not isinstance(log_density, torch.Tensor):
            log_density = torch.as_tensor(log_density, dtype=v.dtype, device=v.device)
        (self.log_density,) = promote_shapes(log_density, shape=vshape[:split])
        super().__init__(vshape[:split], vshape[split:], validate_args=validate_args)

    @property
    def support(self):
        return constraints.independent(constraints.real, self.event_dim)

    def sample(self, key, sample_shape=()):
        return torch.broadcast_to(self.v, self.shape(sample_shape))

    @validate_sample
    def log_prob(self, value):
        hit = torch.where(value == self.v, 0.0, -torch.inf).to(_float_dtype(value))
        return sum_rightmost(hit, self.event_dim) + self.log_density

    @property
    def mean(self):
        return self.v

    @property
    def variance(self):
        return torch.zeros_like(self.v).expand(self.shape())


def _float_dtype(value):
    return value.dtype if value.is_floating_point() else torch.get_default_dtype()


class Unit(Distribution):
    """Trivial nonnormalized distribution over the empty event: the carrier
    of a bare ``log_factor`` (used by the ``factor`` primitive)."""

    arg_constraints = {"log_factor": constraints.real}
    support = constraints.real

    def __init__(self, log_factor, *, validate_args=None):
        self.log_factor = log_factor
        super().__init__(tuple(log_factor.shape), (0,), validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        return self.log_factor.new_empty(self.shape(sample_shape))

    def log_prob(self, value):
        out = broadcast_shape(self.batch_shape, tuple(value.shape[:-1]))
        return self.log_factor.expand(out)


class ImproperUniform(Distribution):
    """An improper flat prior over ``support``: ``log_prob`` is 0 everywhere,
    and there is no sampler (an init strategy places such a site in
    unconstrained space)."""

    has_rsample = True

    def __init__(self, support, batch_shape, event_shape, *, validate_args=None):
        self.support = constraints.independent(support, len(event_shape) - support.event_dim)
        super().__init__(batch_shape, event_shape, validate_args=validate_args)

    @validate_sample
    def log_prob(self, value):
        lead = value.dim() - self.event_dim
        dtype = _float_dtype(value)
        return torch.zeros(broadcast_shape(tuple(value.shape[:lead]), self.batch_shape),
                           dtype=dtype, device=value.device)

    def _validate_sample(self, value):
        ok = super()._validate_sample(value)
        lead = value.dim() - self.event_dim
        if lead < ok.dim():
            ok = ok.all(tuple(range(lead - ok.dim(), 0)))
        return ok

    def sample(self, key, sample_shape=()):
        raise NotImplementedError(
            "ImproperUniform has no sampler; use an init strategy or "
            ".mask(False) over a proper prior instead")
