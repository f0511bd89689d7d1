"""Bijective transforms and the ``biject_to`` registry (port of
``numpyro_tpu/distributions/transforms.py``: every transform of the JAX
package, and ``biject_to`` with the JAX package's table row for row; a
constraint without a row raises as there, ``Cannot transform <type>
constraint``).

Matrices are built with out-of-place ops only (``index_copy``, not an
indexed assignment into a new tensor): under ``torch.func.grad`` an in-place
write of a tracked value into an untracked tensor is an error.

The JAX package's ``lax.scan`` recurrences take these forms here: the
forward map of :class:`RecursiveLinearTransform` (``y_t = A y_{t-1} +
x_t``) is a log-depth doubling of the affine maps (:func:`linear_recursion`,
``ceil(log2 T)`` rounds of a shift, a product and a sum), and its inverse
needs no recursion at all.  A stick-breaking budget that the JAX package
takes with ``cumprod`` (:class:`CorrCholeskyTransform`) is a product over
the few columns of the matrix, one multiplication a column
(:func:`_exclusive_cumprod`): ``torch.cumprod``'s backward reads whether a
factor is 0 on the host, which syncs the card on every gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from numpyro_tpu_torch.util import HostArray

from . import constraints
from .util import broadcast_shape, cholesky, sum_rightmost

__all__ = [
    "AbsTransform",
    "AffineTransform",
    "CholeskyTransform",
    "ComplexTransform",
    "ComposeTransform",
    "CorrCholeskyTransform",
    "CorrMatrixCholeskyTransform",
    "ExpTransform",
    "IdentityTransform",
    "IndependentTransform",
    "L1BallTransform",
    "LowerCholeskyAffine",
    "LowerCholeskyTransform",
    "OrderedTransform",
    "PackRealFastFourierCoefficientsTransform",
    "PermuteTransform",
    "PowerTransform",
    "RealFastFourierTransform",
    "RecursiveLinearTransform",
    "ReshapeTransform",
    "ScaledUnitLowerCholeskyTransform",
    "SigmoidTransform",
    "SimplexToOrderedTransform",
    "SoftplusLowerCholeskyTransform",
    "SoftplusTransform",
    "StickBreakingTransform",
    "Transform",
    "UnpackTransform",
    "ZeroSumTransform",
    "biject_to",
    "linear_recursion",
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
            # on x's device: a 0-dim scale made from a Python number lives on
            # the CPU (an interval's bounds), and joins x's device as a scalar
            return torch.zeros_like(x) + torch.log(torch.abs(self.scale))
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


class OrderedTransform(Transform):
    """R^K -> ordered vectors: ``y_1 = x_1``, ``y_k = y_{k-1} + exp(x_k)``."""

    domain = constraints.real_vector
    codomain = constraints.ordered_vector

    def __call__(self, x):
        return torch.cumsum(torch.cat([x[..., :1], torch.exp(x[..., 1:])], -1), -1)

    def _inverse(self, y):
        return torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))], -1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x[..., 1:].sum(-1)


def _as_float(v, like):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=like.dtype,
                                                                 device=like.device)


class SimplexToOrderedTransform(Transform):
    """The K-simplex -> K - 1 ordered cutpoints: the logit of the cumulative
    sums, shifted by ``anchor_point``."""

    domain = constraints.simplex
    codomain = constraints.ordered_vector

    def __init__(self, anchor_point=0.0):
        self.anchor_point = anchor_point

    def __call__(self, x):
        cdf = torch.cumsum(x[..., :-1], -1)
        return torch.log(cdf / (1.0 - cdf)) + _as_float(self.anchor_point, x)[..., None]

    def _inverse(self, y):
        cdf = torch.sigmoid(y - _as_float(self.anchor_point, y)[..., None])
        return (torch.cat([cdf, torch.ones_like(cdf[..., :1])], -1)
                - torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # d logit(s)/ds = 1 / (s (1 - s)) at s = cumsum(x[:-1])
        cdf = torch.cumsum(x[..., :-1], -1)
        return -(torch.log(cdf) + torch.log1p(-cdf)).sum(-1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def __eq__(self, other):
        return type(self) is type(other) and _same(self.anchor_point, other.anchor_point)

    __hash__ = Transform.__hash__


def _tril_size_to_dim(n, diagonal=0):
    """Invert N = D(D+1)/2 (a diagonal offset folded in)."""
    return round(math.sqrt(0.25 + 2 * n) - 0.5) - diagonal


def _matrix_forward_shape(shape, offset=0):
    """``(..., N) -> (..., D, D)`` for ``N = D (D + 1) / 2``, then ``D``
    shifted by ``offset``."""
    if not shape:
        raise ValueError("Too few dimensions on input")
    n = shape[-1]
    d = _tril_size_to_dim(n)
    if d * (d + 1) // 2 != n:
        raise ValueError("Input is not a flattened lower-diagonal number")
    return tuple(shape[:-1]) + (d - offset, d - offset)


def _matrix_inverse_shape(shape, offset=0):
    if len(shape) < 2:
        raise ValueError("Too few dimensions on input")
    if shape[-2] != shape[-1]:
        raise ValueError("Input is not square")
    d = shape[-1] + offset
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


def _exclusive_cumprod(x):
    """``prod_{j<k} x_j`` along the last axis (1 at k = 0), one
    multiplication a column: exact where a factor is 0, and without
    ``torch.cumprod``'s host read in the backward."""
    cols = [torch.ones_like(x[..., 0])]
    for k in range(x.shape[-1] - 1):
        cols.append(cols[-1] * x[..., k])
    return torch.stack(cols, -1)


class CorrCholeskyTransform(Transform):
    """R^{D(D-1)/2} -> Cholesky factors of correlation matrices, by signed
    stick breaking: the ``tanh`` of the vector fills the strictly lower
    triangle row by row, each entry takes its share of what the row's
    earlier entries left of a unit norm, and the diagonal completes the
    row.  The clips are the JAX package's: 0 under the square roots, and
    ``tiny`` in the inverse and the log-determinant."""

    domain = constraints.real_vector
    codomain = constraints.corr_cholesky

    def __call__(self, x):
        t = vec_to_tril_matrix(torch.tanh(x), diagonal=-1)
        # r_ij = t_ij sqrt(prod_{k<j} (1 - t_ik^2))
        budget_before = _exclusive_cumprod(1.0 - t.square())
        r = t * torch.sqrt(budget_before.clamp(min=0.0))
        diag = torch.sqrt((1.0 - r.square().sum(-1)).clamp(min=0.0))
        return r + _embed_diag(diag)

    def _room(self, y):
        used = torch.cumsum(y.square(), -1) - y.square()
        return (1.0 - used).clamp(min=torch.finfo(y.dtype).tiny)

    def _inverse(self, y):
        # z_ij = y_ij / sqrt(1 - sum_{k<j} y_ik^2)
        return torch.atanh(matrix_to_tril_vec(y / torch.sqrt(self._room(y)), diagonal=-1))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # log(1 - tanh^2 x) = 2 (log 2 - x - softplus(-2x))
        tanh_part = -2.0 * (x + _softplus(-2.0 * x) - math.log(2.0)).sum(-1)
        # half the log of each strictly-lower entry's remaining budget
        d = y.shape[-1]
        below = torch.ones(d, d, dtype=torch.bool, device=y.device).tril(-1)
        log_room = torch.where(below, torch.log(self._room(y)), 0.0)
        return 0.5 * log_room.sum((-2, -1)) + tanh_part

    def forward_shape(self, shape):
        return _matrix_forward_shape(shape, offset=-1)

    def inverse_shape(self, shape):
        return _matrix_inverse_shape(shape, offset=-1)


class CholeskyTransform(Transform):
    """Positive definite matrices -> their lower Cholesky factors
    (``util.cholesky``: a NaN factor where a matrix is not positive
    definite, as JAX's, and no raise)."""

    domain = constraints.positive_definite
    codomain = constraints.lower_cholesky

    def __call__(self, x):
        return cholesky(x)

    def _inverse(self, y):
        return y @ y.transpose(-2, -1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # the log-determinant of dL/dX for X = L L^T
        d = x.shape[-1]
        diag = torch.diagonal(y, dim1=-2, dim2=-1)
        weights = -torch.arange(d, 0, -1, dtype=x.dtype, device=x.device)
        return (weights * torch.log(diag)).sum(-1) - d * math.log(2.0)


class CorrMatrixCholeskyTransform(CholeskyTransform):
    domain = constraints.corr_matrix
    codomain = constraints.corr_cholesky

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        d = x.shape[-1]
        diag = torch.diagonal(y, dim1=-2, dim2=-1)
        weights = -torch.arange(d - 1, -1, -1, dtype=x.dtype, device=x.device)
        return (weights * torch.log(diag)).sum(-1)


class LowerCholeskyTransform(Transform):
    """R^{D(D+1)/2} -> lower-Cholesky matrices: the strictly lower part as
    it is, then the diagonal through exp."""

    domain = constraints.real_vector
    codomain = constraints.lower_cholesky

    def _diag_transform(self, x):
        return torch.exp(x)

    def _diag_inverse(self, y):
        return torch.log(y)

    def _split(self, x):
        d = _tril_size_to_dim(x.shape[-1])
        return x[..., :-d], x[..., -d:], d

    def __call__(self, x):
        below, raw_diag, _ = self._split(x)
        return (vec_to_tril_matrix(below, diagonal=-1)
                + _embed_diag(self._diag_transform(raw_diag)))

    def _inverse(self, y):
        below = matrix_to_tril_vec(y, diagonal=-1)
        raw_diag = self._diag_inverse(torch.diagonal(y, dim1=-2, dim2=-1))
        return torch.cat([below, raw_diag], dim=-1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return self._split(x)[1].sum(-1)

    def forward_shape(self, shape):
        return _matrix_forward_shape(shape)

    def inverse_shape(self, shape):
        return _matrix_inverse_shape(shape)


class SoftplusLowerCholeskyTransform(LowerCholeskyTransform):
    """As :class:`LowerCholeskyTransform`, with softplus on the diagonal."""

    codomain = constraints.softplus_lower_cholesky

    def _diag_transform(self, x):
        return _softplus(x)

    def _diag_inverse(self, y):
        return y + torch.log(-torch.expm1(-y))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return -_softplus(-self._split(x)[1]).sum(-1)


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


class L1BallTransform(Transform):
    """R^K -> the open unit L1 ball, by stick breaking on the absolute
    values: stick ``s_k = 2 sigmoid(|x_k|) - 1`` of what the earlier sticks
    left, ``cumprod(1 - s) / clip(1 - s, tiny)`` as in the JAX package, the
    sign carried by ``x``."""

    domain = constraints.real_vector
    codomain = constraints.l1_ball

    def _sticks(self, x):
        sticks = 2.0 * torch.sigmoid(x.abs()) - 1.0
        left = 1.0 - sticks
        budget = torch.cumprod(left, -1) / left.clamp(min=torch.finfo(x.dtype).tiny)
        return sticks, budget

    def __call__(self, x):
        sticks, budget = self._sticks(x)
        return torch.sign(x) * sticks * budget

    def _inverse(self, y):
        info = torch.finfo(y.dtype)
        mag = y.abs()
        budget = 1.0 - torch.cumsum(mag, -1) + mag
        sticks = mag / budget.clamp(min=info.tiny)
        half = (0.5 * (sticks + 1.0)).clamp(min=info.tiny, max=1.0 - info.eps)
        return torch.sign(y) * torch.log(half / (1.0 - half))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        # y_k depends on x_j for j <= k only, so the Jacobian is triangular
        # and its log-determinant sums the log of the diagonal,
        # s'(|x_k|) budget_k with s'(u) = 2 sigmoid(u) (1 - sigmoid(u)); the
        # JAX package takes slogdet of the whole Jacobian (jacfwd)
        _, budget = self._sticks(x)
        u = x.abs()
        return (math.log(2.0) - _softplus(u) - _softplus(-u) + torch.log(budget)).sum(-1)


class ZeroSumTransform(Transform):
    """R^{n-1} along each of the ``transform_ndims`` rightmost axes -> arrays
    that sum to zero along each, by the orthonormal (Householder) map of
    ``ZeroSumNormal``; volume preserving."""

    def __init__(self, transform_ndims=1):
        self.transform_ndims = transform_ndims

    @property
    def domain(self):
        return constraints.independent(constraints.real, self.transform_ndims)

    @property
    def codomain(self):
        return constraints.zero_sum(self.transform_ndims)

    @staticmethod
    def _append_slot(x, axis):
        n = x.shape[axis] + 1
        total = x.sum(axis, keepdim=True)
        shift = total / (math.sqrt(n) + n)
        slot = shift - total / math.sqrt(n)
        return torch.cat([x, slot], axis) - shift

    @staticmethod
    def _drop_slot(y, axis):
        n = y.shape[axis]
        slot = y.narrow(axis, n - 1, 1)
        shift = -slot * math.sqrt(n) / (math.sqrt(n) + n)
        return y.narrow(axis, 0, n - 1) + shift

    def __call__(self, x):
        for axis in range(-self.transform_ndims, 0):
            x = self._append_slot(x, axis)
        return x

    def _inverse(self, y):
        for axis in range(-self.transform_ndims, 0):
            y = self._drop_slot(y, axis)
        return y

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x.new_zeros(tuple(x.shape[: x.dim() - self.transform_ndims]))

    def forward_shape(self, shape):
        k = self.transform_ndims
        return tuple(shape[:-k]) + tuple(s + 1 for s in shape[-k:])

    def inverse_shape(self, shape):
        k = self.transform_ndims
        return tuple(shape[:-k]) + tuple(s - 1 for s in shape[-k:])

    def __eq__(self, other):
        return type(self) is type(other) and self.transform_ndims == other.transform_ndims

    __hash__ = Transform.__hash__


def _real_dtype(t):
    return t.real.dtype if t.is_complex() else t.dtype


class ComplexTransform(Transform):
    """A trailing pair of reals <-> one complex number."""

    domain = constraints.real_vector
    codomain = constraints.complex

    def __call__(self, x):
        assert x.shape[-1] == 2, "Input must have a trailing dimension of size 2."
        return torch.complex(x[..., 0], x[..., 1])

    def _inverse(self, y):
        return torch.stack([y.real, y.imag], -1)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return torch.zeros(tuple(y.shape), dtype=_real_dtype(y), device=y.device)

    def forward_shape(self, shape):
        assert shape[-1] == 2, "Input must have a trailing dimension of size 2."
        return tuple(shape[:-1])

    def inverse_shape(self, shape):
        return tuple(shape) + (2,)


class RealFastFourierTransform(Transform):
    """The real FFT over the ``transform_ndims`` rightmost axes, of length
    ``transform_shape`` (by default the input's), as ``torch.fft.rfftn``
    with ``s`` passed explicitly, and ``irfftn`` back."""

    def __init__(self, transform_shape=None, transform_ndims=1):
        if isinstance(transform_shape, int):
            transform_shape = (transform_shape,)
        if transform_shape is not None and len(transform_shape) != transform_ndims:
            raise ValueError(
                f"Length of transform shape ({transform_shape}) does not match "
                f"number of dimensions to transform ({transform_ndims})."
            )
        self.transform_shape = None if transform_shape is None else tuple(transform_shape)
        self.transform_ndims = transform_ndims

    def _axes(self):
        return tuple(range(-self.transform_ndims, 0))

    def _with_event(self, shape):
        shape = tuple(shape)
        if self.transform_shape is None:
            return shape
        return shape[: len(shape) - len(self.transform_shape)] + self.transform_shape

    def __call__(self, x):
        return torch.fft.rfftn(x, s=self.transform_shape, dim=self._axes())

    def _inverse(self, y):
        return torch.fft.irfftn(y, s=self.transform_shape, dim=self._axes())

    def forward_shape(self, shape):
        shape = self._with_event(shape)
        return shape[:-1] + (shape[-1] // 2 + 1,)

    def inverse_shape(self, shape):
        if self.transform_shape:
            return self._with_event(shape)
        return tuple(shape[:-1]) + (2 * (shape[-1] - 1),)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        k = self.transform_ndims
        batch = broadcast_shape(tuple(x.shape[: x.dim() - k]), tuple(y.shape[: y.dim() - k]))
        event = tuple(x.shape[x.dim() - k:])
        size = math.prod(event)
        n_self_conjugate = math.prod(2 - s % 2 for s in event)
        const = 0.5 * (size * math.log(size) - math.log(2.0) * (size - n_self_conjugate))
        return torch.full(batch, const, dtype=_real_dtype(x), device=x.device)

    @property
    def domain(self):
        return constraints.independent(constraints.real, self.transform_ndims)

    @property
    def codomain(self):
        return constraints.independent(constraints.complex, self.transform_ndims)

    def __eq__(self, other):
        return (isinstance(other, RealFastFourierTransform)
                and self.transform_ndims == other.transform_ndims
                and self.transform_shape == other.transform_shape)

    __hash__ = Transform.__hash__


class PackRealFastFourierCoefficientsTransform(Transform):
    """A real vector of length n <-> the n // 2 + 1 complex coefficients of
    a real FFT: the first n // 2 + 1 entries are the real parts, the rest
    the imaginary parts of the coefficients after the first (the last one's
    is 0 where n is even)."""

    domain = constraints.real_vector
    codomain = constraints.independent(constraints.complex, 1)

    def __init__(self, transform_shape=None):
        if transform_shape is not None and len(transform_shape) != 1:
            raise AssertionError("Packing Fourier coefficients is only implemented for vectors.")
        self.shape = None if transform_shape is None else tuple(transform_shape)

    @staticmethod
    def _split_counts(n):
        n_real = n // 2 + 1
        return n_real, n - n_real

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] // 2 + 1,)

    def inverse_shape(self, shape):
        if self.shape is None:
            raise AssertionError("Shape must be specified in `__init__` for inverse transform.")
        (n,) = self.shape
        if shape[-1] != n // 2 + 1:
            raise AssertionError("packed length mismatch")
        return tuple(shape[:-1]) + (n,)

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        batch = broadcast_shape(tuple(x.shape[:-1]), tuple(y.shape[:-1]))
        return torch.zeros(batch, dtype=_real_dtype(x), device=x.device)

    def __call__(self, x):
        assert self.shape is None or self.shape == tuple(x.shape[-1:])
        n_real, n_imag = self._split_counts(x.shape[-1])
        head = torch.zeros_like(x[..., :1])
        tail = x.new_zeros(tuple(x.shape[:-1]) + (n_real - 1 - n_imag,))
        imag = torch.cat([head, x[..., n_real:], tail], -1)
        return torch.complex(x[..., :n_real], imag)

    def _inverse(self, y):
        (n,) = self.shape
        _, n_imag = self._split_counts(n)
        return torch.cat([y.real, y.imag[..., 1: n_imag + 1]], -1)

    def __eq__(self, other):
        return (isinstance(other, PackRealFastFourierCoefficientsTransform)
                and self.shape == other.shape)

    __hash__ = Transform.__hash__


def linear_recursion(shocks, transition):
    """``y_t = A y_{t-1} + x_t`` from ``y_{-1} = 0`` along the second-to-last
    axis of ``shocks`` ``(..., T, D)``, ``A = transition`` ``(..., D, D)``:
    a log-depth doubling of the affine maps (Hillis and Steele), ``ceil(log2
    T)`` rounds of ``y_t += A^(2^r) y_{t - 2^r}``, each a shift, a product,
    a sum and a squaring of the power; no loop over time.  Each output sums
    the same terms as the sequential recursion, in another order."""
    y, power, step, steps = shocks, transition.transpose(-2, -1), 1, shocks.shape[-2]
    while step < steps:
        lagged = torch.nn.functional.pad(y[..., :-step, :], (0, 0, step, 0))
        y = y + lagged @ power
        power = power @ power
        step *= 2
    return y


class RecursiveLinearTransform(Transform):
    """``y_t = A y_{t-1} + x_t`` over the second-to-last axis (volume
    preserving; ``A = transition_matrix``, ``(..., D, D)``).  The JAX package
    scans over time.  Here the forward map is :func:`linear_recursion`: at
    T = 100 that is 7 rounds of 5 tensor ops (a slice, a pad, a product, a
    sum and the squaring of the power) after one transpose, 36 ops an
    evaluation, against about 200 for a loop over time (a product and a sum
    a step); the inverse ``x_t = y_t - A y_{t-1}`` is 5 ops."""

    domain = constraints.real_matrix
    codomain = constraints.real_matrix

    def __init__(self, transition_matrix):
        self.transition_matrix = transition_matrix

    def __call__(self, x):
        return linear_recursion(x, self.transition_matrix)

    def _inverse(self, y):
        pushed = y[..., :-1, :] @ self.transition_matrix.transpose(-2, -1)
        return y - torch.nn.functional.pad(pushed, (0, 0, 1, 0))

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        return x.new_zeros(tuple(x.shape[:-2]))

    def __eq__(self, other):
        return isinstance(other, RecursiveLinearTransform) and _same(
            self.transition_matrix, other.transition_matrix)

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
                f"Cannot transform {type(constraint).__name__} constraint"
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
biject_to.register(constraints.ordered_vector, lambda c: OrderedTransform())
biject_to.register(constraints.positive_ordered_vector,
                   lambda c: ComposeTransform([OrderedTransform(), ExpTransform()]))
biject_to.register(constraints.corr_cholesky, lambda c: CorrCholeskyTransform())
biject_to.register(
    constraints.corr_matrix,
    lambda c: ComposeTransform([CorrCholeskyTransform(), CorrMatrixCholeskyTransform().inv]),
)
biject_to.register(constraints.lower_cholesky, lambda c: LowerCholeskyTransform())
biject_to.register(
    constraints.scaled_unit_lower_cholesky, lambda c: ScaledUnitLowerCholeskyTransform()
)
biject_to.register(constraints.softplus_lower_cholesky,
                   lambda c: SoftplusLowerCholeskyTransform())
for _c in (constraints.positive_definite, constraints.positive_semidefinite):
    biject_to.register(
        _c, lambda c: ComposeTransform([LowerCholeskyTransform(), CholeskyTransform().inv])
    )
del _c
biject_to.register(constraints.l1_ball, lambda c: L1BallTransform())
biject_to.register(constraints.zero_sum, lambda c: ZeroSumTransform(c.event_dim))
