"""Bijective transforms and the ``biject_to`` registry (port of the parts
of ``numpyro_tpu/distributions/transforms.py`` that the ported slices need:
identity, independent, compose, affine, exp, power, abs, sigmoid, softplus
and stick-breaking transforms, the lower-Cholesky transforms,
``UnpackTransform`` and ``LowerCholeskyAffine``, ``PermuteTransform`` and
``ReshapeTransform``; ``biject_to`` for ``real``, ``independent``,
``positive``/``nonnegative``, ``greater_than``/``greater_than_eq``,
``less_than``/``less_than_eq``, ``softplus_positive``, ``lower_cholesky``,
``scaled_unit_lower_cholesky``, ``simplex``, ``unit_interval``,
``interval``/``open_interval`` and ``circular``).
Other constraints
raise ``NotImplementedError``; their transforms are listed in ROADMAP.md.

Matrices are built with out-of-place ops only (``index_copy``, not an
indexed assignment into a new tensor): under ``torch.func.grad`` an in-place
write of a tracked value into an untracked tensor is an error."""

from __future__ import annotations

import math

import numpy as np
import torch

from numpyro_tpu_torch.util import HostArray

from . import constraints
from .util import broadcast_shape, sum_rightmost

__all__ = [
    "AbsTransform",
    "AffineTransform",
    "ComposeTransform",
    "ExpTransform",
    "IdentityTransform",
    "IndependentTransform",
    "LowerCholeskyAffine",
    "LowerCholeskyTransform",
    "PermuteTransform",
    "PowerTransform",
    "ReshapeTransform",
    "ScaledUnitLowerCholeskyTransform",
    "SigmoidTransform",
    "SoftplusTransform",
    "StickBreakingTransform",
    "Transform",
    "UnpackTransform",
    "biject_to",
    "matrix_to_tril_vec",
    "vec_to_tril_matrix",
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

    def call_with_intermediates(self, x):
        return self(x), None

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

    def call_with_intermediates(self, x):
        stages = []
        for part in self.parts:
            out, inter = part.call_with_intermediates(x)
            stages.append([x, inter])
            x = out
        return x, stages

    def _stages(self, x, y, intermediates):
        """``(part, x_i, y_i, intermediates_i)`` for each link of the chain:
        recomputed forward from ``x``, or read from what
        :meth:`call_with_intermediates` recorded."""
        if intermediates is None:
            inputs, here = [], x
            for part in self.parts[:-1]:
                inputs.append((here, None))
                here = part(here)
            inputs.append((here, None))
        else:
            if len(intermediates) != len(self.parts):
                raise ValueError("intermediates length mismatch")
            inputs = [(pair[0], pair[1]) for pair in intermediates]
        outputs = [pair[0] for pair in inputs[1:]] + [y]
        for part, (x_i, inter_i), y_i in zip(self.parts, inputs, outputs):
            yield part, x_i, y_i, inter_i

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        total, event_dim = 0.0, self.domain.event_dim
        for part, x_i, y_i, inter_i in self._stages(x, y, intermediates):
            term = part.log_abs_det_jacobian(x_i, y_i, intermediates=inter_i)
            extra = event_dim - part.domain.event_dim
            total = total + sum_rightmost(term, extra)
            event_dim = part.codomain.event_dim + extra
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


class AbsTransform(Transform):
    domain = constraints.real
    codomain = constraints.positive

    def __call__(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y


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
        if isinstance(dom, constraints.less_than):
            return constraints.less_than(self(dom.upper_bound))
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


class PowerTransform(Transform):
    """y = x ** exponent on the positive half-line."""

    domain = constraints.positive
    codomain = constraints.positive

    def __init__(self, exponent):
        self.exponent = exponent

    def __call__(self, x):
        return torch.pow(x, self.exponent)

    def _inverse(self, y):
        return torch.pow(y, 1.0 / self.exponent)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return torch.log(torch.abs(self.exponent * y / x))

    def forward_shape(self, shape):
        return broadcast_shape(tuple(shape), tuple(torch.as_tensor(self.exponent).shape))

    inverse_shape = forward_shape

    def __eq__(self, other):
        return type(self) is type(other) and _same(self.exponent, other.exponent)

    __hash__ = Transform.__hash__


def _softplus(x):
    """``log(1 + exp(x))`` as the JAX package computes it (``logaddexp(x,
    0)``, written out).  ``torch.nn.functional.softplus`` turns into the
    identity above its threshold of 20, which this does not."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _clipped_expit(x):
    info = torch.finfo(x.dtype)
    return torch.sigmoid(x).clamp(min=info.tiny, max=1.0 - info.eps)


class SigmoidTransform(Transform):
    """y = 1 / (1 + exp(-x)), onto the unit interval, clipped inside it as
    the JAX package clips it (``tiny`` below, ``1 - eps`` above)."""

    codomain = constraints.unit_interval

    def __call__(self, x):
        return _clipped_expit(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return -_softplus(x) - _softplus(-x)


class SoftplusTransform(Transform):
    """y = log(1 + exp(x)), onto the positive half-line."""

    codomain = constraints.softplus_positive

    def __call__(self, x):
        return _softplus(x)

    def _inverse(self, y):
        return y + torch.log(-torch.expm1(-y))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return -_softplus(-x)


class StickBreakingTransform(Transform):
    """R^(K-1) -> the K-simplex by stick breaking with logistic sticks.  The
    k-th coordinate is shifted by ``log(K - 1 - k)`` so that zero maps to the
    uniform point, as in the JAX package, whose unconstrained coordinates
    these are."""

    domain = constraints.real_vector
    codomain = constraints.simplex

    @staticmethod
    def _stick_offset(x, k_minus_1):
        return torch.log(torch.arange(k_minus_1, 0, -1, dtype=x.dtype, device=x.device))

    def __call__(self, x):
        fracs = _clipped_expit(x - self._stick_offset(x, x.shape[-1]))
        leftover = torch.cumprod(1.0 - fracs, dim=-1)
        ones = torch.ones_like(fracs[..., :1])
        return torch.cat([fracs, ones], -1) * torch.cat([ones, leftover], -1)

    def _inverse(self, y):
        head = y[..., :-1]
        leftover = (1.0 - torch.cumsum(head, dim=-1)).clamp(min=torch.finfo(y.dtype).tiny)
        prev_leftover = torch.cat([torch.ones_like(head[..., :1]), leftover[..., :-1]], -1)
        # the logit of each stick's fraction, then the offset undone
        raw = torch.log(head) - torch.log(prev_leftover - head)
        return raw + self._stick_offset(y, y.shape[-1] - 1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        shifted = x - self._stick_offset(x, x.shape[-1])
        leftover = 1.0 - torch.cumsum(y[..., :-1], dim=-1)
        prev_leftover = torch.cat(
            [torch.ones_like(x[..., :1]),
             leftover[..., :-1].clamp(min=torch.finfo(x.dtype).tiny)], -1,
        )
        # |dy_k / dx_k| = sigmoid'(x_k) prod_{j<k} (1 - z_j)
        per_stick = -_softplus(shifted) - _softplus(-shifted) + torch.log(prev_leftover)
        return per_stick.sum(-1)

    def forward_shape(self, shape):
        if not shape:
            raise ValueError("Too few dimensions on input")
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        if not shape:
            raise ValueError("Too few dimensions on input")
        return tuple(shape[:-1]) + (shape[-1] - 1,)


def _tril_size_to_dim(n, diagonal=0):
    """Invert N = D(D+1)/2 (a diagonal offset folded in)."""
    return round(math.sqrt(0.25 + 2 * n) - 0.5) - diagonal


def _matrix_forward_shape(shape):
    if not shape:
        raise ValueError("Too few dimensions on input")
    n = shape[-1]
    d = _tril_size_to_dim(n)
    if d * (d + 1) // 2 != n:
        raise ValueError("Input is not a flattened lower-diagonal number")
    return tuple(shape[:-1]) + (d, d)


def _matrix_inverse_shape(shape):
    if len(shape) < 2:
        raise ValueError("Too few dimensions on input")
    if shape[-2] != shape[-1]:
        raise ValueError("Input is not square")
    d = shape[-1]
    return tuple(shape[:-2]) + (d * (d + 1) // 2,)


def vec_to_tril_matrix(x, diagonal=0):
    """Unpack a ``(..., N)`` vector into ``(..., D, D)`` lower-triangular
    matrices, row by row (the order of ``tril_indices``)."""
    d = _tril_size_to_dim(x.shape[-1], diagonal)
    rows, cols = torch.tril_indices(d, d, diagonal, device=x.device)
    flat = x.new_zeros(tuple(x.shape[:-1]) + (d * d,))
    return flat.index_copy(-1, rows * d + cols, x).reshape(tuple(x.shape[:-1]) + (d, d))


def matrix_to_tril_vec(x, diagonal=0):
    d = x.shape[-1]
    rows, cols = torch.tril_indices(d, d, diagonal, device=x.device)
    return x[..., rows, cols]


def _embed_diag(vals):
    """``(..., D)`` -> ``(..., D, D)`` diagonal matrices."""
    return vals[..., None] * torch.eye(vals.shape[-1], dtype=vals.dtype, device=vals.device)


class LowerCholeskyTransform(Transform):
    """R^{D(D+1)/2} -> lower-Cholesky matrices: the strictly lower part as
    it is, then the diagonal through exp."""

    domain = constraints.real_vector
    codomain = constraints.lower_cholesky

    def _split(self, x):
        d = _tril_size_to_dim(x.shape[-1])
        return x[..., :-d], x[..., -d:], d

    def __call__(self, x):
        below, raw_diag, _ = self._split(x)
        return vec_to_tril_matrix(below, diagonal=-1) + _embed_diag(torch.exp(raw_diag))

    def _inverse(self, y):
        below = matrix_to_tril_vec(y, diagonal=-1)
        raw_diag = torch.log(torch.diagonal(y, dim1=-2, dim2=-1))
        return torch.cat([below, raw_diag], dim=-1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return self._split(x)[1].sum(-1)

    def forward_shape(self, shape):
        return _matrix_forward_shape(shape)

    def inverse_shape(self, shape):
        return _matrix_inverse_shape(shape)


class ScaledUnitLowerCholeskyTransform(LowerCholeskyTransform):
    """L = diag(s) @ L_unit, where the rows of L_unit have unit norm: the
    strictly lower part of each row over a unit diagonal, normalised, then
    scaled by ``exp`` of the last D entries."""

    codomain = constraints.scaled_unit_lower_cholesky

    def _rows(self, x):
        below, log_scales, d = self._split(x)
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        return vec_to_tril_matrix(below, diagonal=-1) + eye, log_scales

    def __call__(self, x):
        rows, log_scales = self._rows(x)
        unit = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
        return unit * torch.exp(log_scales)[..., None]

    def _inverse(self, y):
        scales = torch.linalg.vector_norm(y, dim=-1)
        rows = y / scales[..., None]
        rows = rows / torch.diagonal(rows, dim1=-2, dim2=-1)[..., None]
        return torch.cat([matrix_to_tril_vec(rows, diagonal=-1), torch.log(scales)], dim=-1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # Row i maps its i free entries and its log-scale t_i onto the i + 1
        # entries e^{t_i} r_i / |r_i|, r_i = (a_i, 1): a radius e^{t_i} times
        # a central projection of the plane at distance 1 onto the unit
        # sphere of R^{i+1}, whose volume factors are e^{(i+1) t_i} and
        # |r_i|^{-(i+1)}.  The JAX package takes the same determinant
        # numerically (jacfwd and slogdet).
        rows, log_scales = self._rows(x)
        d = log_scales.shape[-1]
        weights = torch.arange(1, d + 1, dtype=x.dtype, device=x.device)
        log_norms = torch.log(torch.linalg.vector_norm(rows, dim=-1))
        return (weights * (log_scales - log_norms)).sum(-1)


class UnpackTransform(Transform):
    """Flat trailing-axis vector -> dict of site values through
    ``unpack_fn``, which maps one ``(D,)`` vector; leading batch axes are
    mapped with ``torch.func.vmap`` over a flattened batch.  ``pack_fn``
    (one unbatched dict -> ``(D,)``) gives the inverse."""

    domain = constraints.real_vector

    def __init__(self, unpack_fn, pack_fn=None):
        self.unpack_fn = unpack_fn
        self.pack_fn = pack_fn

    def __call__(self, x):
        batch_shape = tuple(x.shape[:-1])
        if not batch_shape:
            return self.unpack_fn(x)
        out = torch.func.vmap(self.unpack_fn)(x.reshape(-1, x.shape[-1]))
        return {k: v.reshape(batch_shape + tuple(v.shape[1:])) for k, v in out.items()}

    def _inverse(self, y):
        if self.pack_fn is None:
            raise NotImplementedError("UnpackTransform.inv requires a pack_fn.")
        return self.pack_fn(y)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x.new_zeros(tuple(x.shape[:-1]))

    def forward_shape(self, shape):
        raise NotImplementedError

    def inverse_shape(self, shape):
        raise NotImplementedError

    def __eq__(self, other):
        return (
            isinstance(other, UnpackTransform)
            and self.unpack_fn is other.unpack_fn
            and self.pack_fn is other.pack_fn
        )

    __hash__ = Transform.__hash__


class LowerCholeskyAffine(Transform):
    """y = loc + L @ x with L lower-triangular (the whitening map of a
    multivariate normal)."""

    domain = constraints.real_vector
    codomain = constraints.real_vector

    def __init__(self, loc, scale_tril):
        if scale_tril.dim() != 2:
            raise ValueError("scale_tril must be a 2D matrix")
        self.loc = loc
        self.scale_tril = scale_tril

    def __call__(self, x):
        return self.loc + (self.scale_tril @ x[..., None])[..., 0]

    def _inverse(self, y):
        centered = y - self.loc
        flat_t = centered.reshape(-1, y.shape[-1]).T
        solved = torch.linalg.solve_triangular(self.scale_tril, flat_t, upper=False)
        return solved.T.reshape(y.shape)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        half_logdet = torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)).sum(-1)
        return torch.broadcast_to(half_logdet, tuple(x.shape[:-1]))

    def forward_shape(self, shape):
        if not shape:
            raise ValueError("Too few dimensions on input")
        return broadcast_shape(
            tuple(shape), tuple(self.loc.shape), tuple(self.scale_tril.shape[:-1])
        )

    inverse_shape = forward_shape

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and _same(self.loc, other.loc)
            and _same(self.scale_tril, other.scale_tril)
        )

    __hash__ = Transform.__hash__


class PermuteTransform(Transform):
    """Permute the last axis: ``y = x[..., permutation]``."""

    domain = constraints.real_vector
    codomain = constraints.real_vector

    def __init__(self, permutation):
        self.permutation = np.asarray(permutation, dtype=np.int64)
        self._forward = HostArray(self.permutation)
        self._undo = HostArray(np.argsort(self.permutation))

    def __call__(self, x):
        return x[..., self._forward.on(x.device)]

    def _inverse(self, y):
        return y[..., self._undo.on(y.device)]

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x.new_zeros(tuple(x.shape[:-1]))

    def __eq__(self, other):
        return type(self) is type(other) and np.array_equal(self.permutation,
                                                            other.permutation)

    __hash__ = Transform.__hash__


class ReshapeTransform(Transform):
    """Reshape the rightmost dims from ``inverse_shape`` to
    ``forward_shape``."""

    def __init__(self, forward_shape, inverse_shape):
        if math.prod(forward_shape) != math.prod(inverse_shape):
            raise ValueError("shape sizes must match")
        self._forward_shape = tuple(forward_shape)
        self._inverse_shape = tuple(inverse_shape)

    @property
    def domain(self):
        return constraints.independent(constraints.real, len(self._inverse_shape))

    @property
    def codomain(self):
        return constraints.independent(constraints.real, len(self._forward_shape))

    @staticmethod
    def _swap_event(shape, source, target):
        shape = tuple(shape)
        keep = len(shape) - len(source)
        if keep < 0 or shape[keep:] != source:
            raise ValueError(f"cannot reshape {shape}")
        return shape[:keep] + target

    def forward_shape(self, shape):
        return self._swap_event(shape, self._inverse_shape, self._forward_shape)

    def inverse_shape(self, shape):
        return self._swap_event(shape, self._forward_shape, self._inverse_shape)

    def __call__(self, x):
        return x.reshape(self.forward_shape(x.shape))

    def _inverse(self, y):
        return y.reshape(self.inverse_shape(y.shape))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        keep = x.dim() - len(self._inverse_shape)
        return x.new_zeros(tuple(x.shape[:keep]))

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self._forward_shape == other._forward_shape
            and self._inverse_shape == other._inverse_shape
        )

    __hash__ = Transform.__hash__


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
for _c in (constraints.less_than, constraints.less_than_eq):
    biject_to.register(_c, lambda c: _onto_halfline(c.upper_bound, -1.0))
del _c
# ``softplus_positive`` subclasses ``_GreaterThan`` but is a type of its own,
# so its row stands beside the half-line rows, as in the JAX package
biject_to.register(constraints.softplus_positive, lambda c: SoftplusTransform())
biject_to.register(constraints.unit_interval, lambda c: SigmoidTransform())
for _c in (constraints.interval, constraints.open_interval):
    biject_to.register(
        _c,
        lambda c: ComposeTransform([
            SigmoidTransform(),
            AffineTransform(c.lower_bound, c.upper_bound - c.lower_bound,
                            domain=constraints.unit_interval),
        ]),
    )
del _c
# the circle, as the JAX package maps it: onto (-pi, pi) through the unit
# interval
biject_to.register(
    constraints.circular,
    lambda c: ComposeTransform([
        SigmoidTransform(),
        AffineTransform(-math.pi, 2 * math.pi, domain=constraints.unit_interval),
    ]),
)
biject_to.register(constraints.simplex, lambda c: StickBreakingTransform())
biject_to.register(constraints.lower_cholesky, lambda c: LowerCholeskyTransform())
biject_to.register(
    constraints.scaled_unit_lower_cholesky, lambda c: ScaledUnitLowerCholeskyTransform()
)
