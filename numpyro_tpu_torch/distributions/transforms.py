"""Bijective transforms and the ``biject_to`` registry (port of the parts
of ``numpyro_tpu/distributions/transforms.py`` that the ported slices need:
identity, independent, compose, affine and exp transforms; ``biject_to`` for
``real``, ``independent``, ``positive``/``nonnegative`` and
``greater_than``/``greater_than_eq``).  Other constraints raise
``NotImplementedError``; their transforms are listed in ROADMAP.md."""

from __future__ import annotations

import math

import torch

from . import constraints
from .util import broadcast_shape, sum_rightmost

__all__ = [
    "AffineTransform",
    "ComposeTransform",
    "ExpTransform",
    "IdentityTransform",
    "IndependentTransform",
    "Transform",
    "biject_to",
]


class Transform:
    domain = constraints.real
    codomain = constraints.real

    @property
    def inv(self):
        return _InverseTransform(self)

    def __call__(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        raise NotImplementedError

    def forward_shape(self, shape):
        return shape

    def inverse_shape(self, shape):
        return shape

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class _InverseTransform(Transform):
    def __init__(self, transform):
        self._transform = transform

    @property
    def domain(self):
        return self._transform.codomain

    @property
    def codomain(self):
        return self._transform.domain

    @property
    def inv(self):
        return self._transform

    def __call__(self, x):
        return self._transform._inverse(x)

    def _inverse(self, y):
        return self._transform(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return -self._transform.log_abs_det_jacobian(y, x, None)

    def forward_shape(self, shape):
        return self._transform.inverse_shape(shape)

    def inverse_shape(self, shape):
        return self._transform.forward_shape(shape)

    def __eq__(self, other):
        return type(self) is type(other) and self._transform == other._transform

    def __hash__(self):
        return hash((type(self), self._transform))


class IdentityTransform(Transform):
    def __call__(self, x):
        return x

    def _inverse(self, y):
        return y

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return torch.zeros_like(x)


class ComposeTransform(Transform):
    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def domain(self):
        needed = self.parts[-1].domain.event_dim
        for part in reversed(self.parts[:-1]):
            needed = part.domain.event_dim + max(needed - part.codomain.event_dim, 0)
        head = self.parts[0].domain
        if head.event_dim < needed:
            return constraints.independent(head, needed - head.event_dim)
        return head

    @property
    def codomain(self):
        produced = self.parts[0].codomain.event_dim
        for part in self.parts[1:]:
            produced = part.codomain.event_dim + max(produced - part.domain.event_dim, 0)
        tail = self.parts[-1].codomain
        if tail.event_dim < produced:
            return constraints.independent(tail, produced - tail.event_dim)
        return tail

    def __call__(self, x):
        for part in self.parts:
            x = part(x)
        return x

    def _inverse(self, y):
        for part in reversed(self.parts):
            y = part.inv(y)
        return y

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        if intermediates is not None:
            raise NotImplementedError("intermediates of a composed transform")
        total, event_dim = 0.0, self.domain.event_dim
        for part in self.parts:
            y_part = part(x)
            total = total + sum_rightmost(
                part.log_abs_det_jacobian(x, y_part),
                event_dim - part.domain.event_dim,
            )
            event_dim += part.codomain.event_dim - part.domain.event_dim
            x = y_part
        return total

    def forward_shape(self, shape):
        for part in self.parts:
            shape = part.forward_shape(shape)
        return shape

    def inverse_shape(self, shape):
        for part in reversed(self.parts):
            shape = part.inverse_shape(shape)
        return shape

    def __eq__(self, other):
        return type(self) is type(other) and self.parts == other.parts

    def __hash__(self):
        return hash((type(self), tuple(self.parts)))


class IndependentTransform(Transform):
    """Reinterpret rightmost batch dims of a transform as event dims."""

    def __init__(self, base_transform, reinterpreted_batch_ndims):
        self.base_transform = base_transform
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def domain(self):
        return constraints.independent(
            self.base_transform.domain, self.reinterpreted_batch_ndims
        )

    @property
    def codomain(self):
        return constraints.independent(
            self.base_transform.codomain, self.reinterpreted_batch_ndims
        )

    def __call__(self, x):
        return self.base_transform(x)

    def _inverse(self, y):
        return self.base_transform._inverse(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        per_element = self.base_transform.log_abs_det_jacobian(x, y, intermediates)
        return sum_rightmost(per_element, self.reinterpreted_batch_ndims)

    def forward_shape(self, shape):
        return self.base_transform.forward_shape(shape)

    def inverse_shape(self, shape):
        return self.base_transform.inverse_shape(shape)

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.base_transform == other.base_transform
            and self.reinterpreted_batch_ndims == other.reinterpreted_batch_ndims
        )

    def __hash__(self):
        return hash((type(self), self.base_transform, self.reinterpreted_batch_ndims))


def _same(a, b):
    return a is b or bool(torch.equal(torch.as_tensor(a), torch.as_tensor(b)))


class AffineTransform(Transform):
    """y = loc + scale * x"""

    def __init__(self, loc, scale, domain=constraints.real):
        self.loc = loc
        self.scale = scale
        self.domain = domain

    @property
    def codomain(self):
        dom = self.domain
        if dom is constraints.real:
            return constraints.real
        if isinstance(dom, constraints.independent):
            inner = AffineTransform(self.loc, self.scale, dom.base_constraint)
            return constraints.independent(inner.codomain, dom.reinterpreted_batch_ndims)
        # the bounded cases assume scale > 0, as the JAX package does
        if isinstance(dom, constraints.greater_than):
            return constraints.greater_than(self(dom.lower_bound))
        if isinstance(dom, constraints.interval):
            return constraints.interval(self(dom.lower_bound), self(dom.upper_bound))
        raise NotImplementedError

    def __call__(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        if isinstance(self.scale, torch.Tensor):
            return torch.broadcast_to(torch.log(torch.abs(self.scale)), x.shape)
        return torch.full_like(x, math.log(abs(self.scale)))

    def forward_shape(self, shape):
        return broadcast_shape(
            tuple(shape), tuple(torch.as_tensor(self.loc).shape),
            tuple(torch.as_tensor(self.scale).shape),
        )

    inverse_shape = forward_shape

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and _same(self.loc, other.loc)
            and _same(self.scale, other.scale)
        )

    def __hash__(self):
        return hash(type(self))


def _exp(v):
    return torch.exp(v) if isinstance(v, torch.Tensor) else math.exp(v)


class ExpTransform(Transform):
    def __init__(self, domain=constraints.real):
        self.domain = domain

    @property
    def codomain(self):
        dom = self.domain
        if dom is constraints.real:
            return constraints.positive
        if isinstance(dom, constraints.greater_than):
            return constraints.greater_than(_exp(dom.lower_bound))
        if isinstance(dom, constraints.interval):
            return constraints.interval(_exp(dom.lower_bound), _exp(dom.upper_bound))
        raise NotImplementedError

    def __call__(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x


class ConstraintRegistry:
    """constraint type -> factory of the transform onto that constraint."""

    def __init__(self):
        self._registry = {}

    def register(self, constraint, factory=None):
        if factory is None:
            return lambda factory: self.register(constraint, factory)
        key = type(constraint) if isinstance(constraint, constraints.Constraint) else constraint
        self._registry[key] = factory
        return factory

    def __call__(self, constraint):
        try:
            factory = self._registry[type(constraint)]
        except KeyError as e:
            raise NotImplementedError(
                f"Cannot transform {type(constraint).__name__} constraint: not "
                "ported to numpyro_tpu_torch yet (see ROADMAP.md)"
            ) from e
        return factory(constraint)


biject_to = ConstraintRegistry()


def _onto_halfline(bound, direction):
    return ComposeTransform(
        [ExpTransform(), AffineTransform(bound, direction, domain=constraints.positive)]
    )


biject_to.register(constraints.real, lambda c: IdentityTransform())
biject_to.register(
    constraints.independent,
    lambda c: IndependentTransform(
        biject_to(c.base_constraint), c.reinterpreted_batch_ndims
    ),
)
# The registry is keyed by type, and ``positive`` is a ``_GreaterThan``: in the
# JAX package's table the ``greater_than`` row comes after the
# ``positive``/``nonnegative`` row and replaces it, so ``positive`` maps to
# ``Exp`` followed by ``Affine(0, 1)`` there, and here too.
for _c in (constraints.greater_than, constraints.greater_than_eq):
    biject_to.register(_c, lambda c: _onto_halfline(c.lower_bound, 1.0))
del _c
