"""Constraints (port of the parts of ``numpyro_tpu/distributions/constraints.py``
that the ported slices need: ``real``, ``real_vector``, ``boolean``,
``independent``, ``dependent``, ``interval``, ``integer_interval``,
``integer_greater_than`` and its instances ``nonnegative_integer``/
``positive_integer``, ``greater_than``/``greater_than_eq`` and their
instances ``positive``/``nonnegative``, ``less_than``/``less_than_eq``,
``open_interval``, ``softplus_positive``, ``lower_cholesky``,
``scaled_unit_lower_cholesky``, ``softplus_lower_cholesky``,
``corr_cholesky``, ``corr_matrix``, ``positive_semidefinite``,
``positive_definite``, ``simplex``, ``unit_interval``, ``multinomial``,
``ordered_vector``, ``positive_ordered_vector``, ``circular``, ``sphere``,
``l1_ball``, ``zero_sum``, ``complex``, ``positive_definite_circulant_vector``
and ``real_matrix``): all of the JAX package's constraints."""

from __future__ import annotations

import math

import torch

__all__ = [
    "Constraint", "boolean", "circular", "complex", "corr_cholesky", "corr_matrix", "dependent",
    "is_dependent",
    "greater_than", "greater_than_eq", "independent", "integer_greater_than",
    "integer_interval", "interval", "l1_ball", "less_than", "less_than_eq", "lower_cholesky",
    "multinomial", "nonnegative", "nonnegative_integer", "open_interval", "ordered_vector",
    "positive", "positive_definite", "positive_definite_circulant_vector", "positive_integer",
    "positive_ordered_vector", "positive_semidefinite", "real", "real_matrix", "real_vector",
    "scaled_unit_lower_cholesky", "simplex", "softplus_lower_cholesky", "softplus_positive",
    "sphere", "unit_interval", "zero_sum",
]


def _eye_like(prototype):
    eye = torch.eye(prototype.shape[-1], dtype=prototype.dtype, device=prototype.device)
    return torch.broadcast_to(eye, prototype.shape)


def _is_tril_with_positive_diag(x):
    tril = (torch.tril(x) == x).flatten(-2).all(-1)
    return tril & (torch.diagonal(x, dim1=-2, dim2=-1) > 0).all(-1)


def _is_symmetric(x):
    return torch.isclose(x, x.transpose(-2, -1)).flatten(-2).all(-1)


class Constraint:
    """A region of feasible values; ``event_dim`` rightmost dims make one value."""

    event_dim = 0
    is_discrete = False

    def __call__(self, x):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def feasible_like(self, prototype):
        """A value inside the region with the shape of ``prototype``."""
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__[1:].replace("Constraint", "")


class _IndependentConstraint(Constraint):
    """A base constraint aggregated over extra rightmost dims."""

    def __init__(self, base_constraint, reinterpreted_batch_ndims):
        assert isinstance(base_constraint, Constraint)
        assert reinterpreted_batch_ndims >= 0
        self.base_constraint = base_constraint
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def event_dim(self):
        return self.base_constraint.event_dim + self.reinterpreted_batch_ndims

    @property
    def is_discrete(self):
        return self.base_constraint.is_discrete

    def __call__(self, x):
        result = self.base_constraint(x)
        if self.reinterpreted_batch_ndims == 0:
            return result
        return result.flatten(-self.reinterpreted_batch_ndims).all(-1)

    def feasible_like(self, prototype):
        return self.base_constraint.feasible_like(prototype)

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.base_constraint == other.base_constraint
            and self.reinterpreted_batch_ndims == other.reinterpreted_batch_ndims
        )

    def __hash__(self):
        return hash((type(self), self.base_constraint, self.reinterpreted_batch_ndims))


class _Real(Constraint):
    def __call__(self, x):
        return torch.isfinite(x)

    def feasible_like(self, prototype):
        return torch.zeros_like(prototype)


class _Boolean(Constraint):
    is_discrete = True

    def __call__(self, x):
        return (x == 0) | (x == 1)

    def feasible_like(self, prototype):
        return torch.zeros_like(prototype)


class _Dependent(Constraint):
    """A placeholder for a constraint that depends on other parameters (a
    ``DiscreteUniform``'s bounds); it cannot be checked."""

    def __init__(self, *, is_discrete=False, event_dim=0):
        self._is_discrete = is_discrete
        self._event_dim = event_dim

    @property
    def is_discrete(self):
        return self._is_discrete

    @property
    def event_dim(self):
        return self._event_dim

    def __call__(self, x=None, *, is_discrete=None, event_dim=None):
        if x is None:
            return _Dependent(
                is_discrete=self._is_discrete if is_discrete is None else is_discrete,
                event_dim=self._event_dim if event_dim is None else event_dim,
            )
        raise ValueError("Cannot determine validity of dependent constraint")

    def feasible_like(self, prototype):
        raise ValueError("Cannot get feasible value for dependent constraint")


class _Circular(Constraint):
    """Angles in ``[-pi, pi]``."""

    def __call__(self, x):
        return (x >= -math.pi) & (x <= math.pi)

    def feasible_like(self, prototype):
        return torch.zeros_like(prototype)


class _GreaterThan(Constraint):
    def __init__(self, lower_bound):
        self.lower_bound = lower_bound

    def __call__(self, x):
        return x > self.lower_bound

    def feasible_like(self, prototype):
        value = torch.as_tensor(self.lower_bound + 1.0, dtype=prototype.dtype,
                                device=prototype.device)
        return torch.broadcast_to(value, prototype.shape)

    def __eq__(self, other):
        return type(self) is type(other) and bool(
            torch.equal(torch.as_tensor(self.lower_bound), torch.as_tensor(other.lower_bound))
        )

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return f"greater_than({self.lower_bound})"


class _GreaterThanEq(_GreaterThan):
    def __call__(self, x):
        return x >= self.lower_bound

    def __repr__(self):
        return f"greater_than_eq({self.lower_bound})"


class _LessThan(Constraint):
    def __init__(self, upper_bound):
        self.upper_bound = upper_bound

    def __call__(self, x):
        return x < self.upper_bound

    def feasible_like(self, prototype):
        value = torch.as_tensor(self.upper_bound - 1.0, dtype=prototype.dtype,
                                device=prototype.device)
        return torch.broadcast_to(value, prototype.shape)

    def __eq__(self, other):
        return type(self) is type(other) and bool(
            torch.equal(torch.as_tensor(self.upper_bound), torch.as_tensor(other.upper_bound))
        )

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return f"less_than({self.upper_bound})"


class _LessThanEq(_LessThan):
    def __call__(self, x):
        return x <= self.upper_bound

    def __repr__(self):
        return f"less_than_eq({self.upper_bound})"


class _SoftplusPositive(_GreaterThan):
    """The positive half-line, reached through softplus rather than exp."""

    def __init__(self):
        super().__init__(0.0)

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return "softplus_positive"


class _LowerCholesky(Constraint):
    """Lower-triangular square matrices with a positive diagonal."""

    event_dim = 2

    def __call__(self, x):
        return _is_tril_with_positive_diag(x)

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _ScaledUnitLowerCholesky(_LowerCholesky):
    pass


class _SoftplusLowerCholesky(_LowerCholesky):
    pass


class _CorrCholesky(Constraint):
    """Lower Cholesky factors of correlation matrices: rows of unit norm."""

    event_dim = 2

    def __call__(self, x):
        norms = torch.linalg.vector_norm(x, dim=-1)
        unit_rows = ((norms - 1.0).abs() <= 1e-6).all(-1)
        return _is_tril_with_positive_diag(x) & unit_rows

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _CorrMatrix(Constraint):
    """Symmetric positive definite matrices with a unit diagonal."""

    event_dim = 2

    def __call__(self, x):
        unit_diag = ((torch.diagonal(x, dim1=-2, dim2=-1) - 1.0).abs() < 1e-6).all(-1)
        spd = torch.linalg.eigvalsh(x)[..., 0] > 0
        return _is_symmetric(x) & spd & unit_diag

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _PositiveSemiDefinite(Constraint):
    event_dim = 2

    def __call__(self, x):
        return _is_symmetric(x) & (torch.linalg.eigvalsh(x)[..., 0] >= 0)

    def feasible_like(self, prototype):
        return _eye_like(prototype)


class _PositiveDefinite(_PositiveSemiDefinite):
    def __call__(self, x):
        return _is_symmetric(x) & (torch.linalg.eigvalsh(x)[..., 0] > 0)


class _Interval(Constraint):
    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def __call__(self, x):
        return (x >= self.lower_bound) & (x <= self.upper_bound)

    def feasible_like(self, prototype):
        return torch.broadcast_to(
            (self.lower_bound + self.upper_bound) / 2, prototype.shape
        ).to(prototype.dtype)

    def __repr__(self):
        return f"interval({self.lower_bound}, {self.upper_bound})"


class _OpenInterval(_Interval):
    def __call__(self, x):
        return (x > self.lower_bound) & (x < self.upper_bound)

    def __repr__(self):
        return f"open_interval({self.lower_bound}, {self.upper_bound})"


class _IntegerInterval(Constraint):
    is_discrete = True

    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def __call__(self, x):
        in_range = (x >= self.lower_bound) & (x <= self.upper_bound)
        return in_range & (x == torch.floor(x))

    def feasible_like(self, prototype):
        return torch.full_like(prototype, self.lower_bound)

    def __repr__(self):
        return f"integer_interval({self.lower_bound}, {self.upper_bound})"


class _IntegerGreaterThan(Constraint):
    is_discrete = True

    def __init__(self, lower_bound):
        self.lower_bound = lower_bound

    def __call__(self, x):
        return (x >= self.lower_bound) & (x == torch.floor(x))

    def feasible_like(self, prototype):
        return torch.full_like(prototype, self.lower_bound)

    def __eq__(self, other):
        return type(self) is type(other) and self.lower_bound == other.lower_bound

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return f"integer_greater_than({self.lower_bound})"


class _Multinomial(Constraint):
    """Count vectors that sum to ``upper_bound``."""

    is_discrete = True
    event_dim = 1

    def __init__(self, upper_bound):
        self.upper_bound = upper_bound

    def __call__(self, x):
        return (x >= 0).all(-1) & (x.sum(-1) == self.upper_bound)

    def feasible_like(self, prototype):
        head = torch.zeros_like(prototype[..., :-1])
        tail = torch.broadcast_to(torch.as_tensor(self.upper_bound, dtype=prototype.dtype,
                                                  device=prototype.device),
                                  prototype[..., :1].shape)
        return torch.cat([head, tail], -1)


class _OrderedVector(Constraint):
    event_dim = 1

    def __call__(self, x):
        return (x[..., 1:] > x[..., :-1]).all(-1)

    def feasible_like(self, prototype):
        steps = torch.arange(prototype.shape[-1], dtype=prototype.dtype, device=prototype.device)
        return torch.broadcast_to(steps, prototype.shape)


class _PositiveOrderedVector(Constraint):
    event_dim = 1

    def __call__(self, x):
        return _OrderedVector.__call__(self, x) & (x > 0).all(-1)

    def feasible_like(self, prototype):
        steps = torch.arange(1, prototype.shape[-1] + 1, dtype=prototype.dtype,
                             device=prototype.device)
        return torch.broadcast_to(steps, prototype.shape)


class _ZeroSum(Constraint):
    """Arrays whose sums along each of the ``event_dim`` rightmost axes
    vanish (to 1e-6)."""

    def __init__(self, event_dim=1):
        self._event_dim = event_dim

    @property
    def event_dim(self):
        return self._event_dim

    def __call__(self, x):
        ok = None
        for axis in range(-self._event_dim, 0):
            small = x.sum(axis).abs() < 1e-6
            if self._event_dim > 1:
                small = small.flatten(-(self._event_dim - 1)).all(-1)
            ok = small if ok is None else ok & small
        return ok

    def feasible_like(self, prototype):
        return torch.zeros_like(prototype)

    def __eq__(self, other):
        return type(self) is type(other) and self._event_dim == other._event_dim

    def __hash__(self):
        return hash((type(self), self._event_dim))

    def __repr__(self):
        return f"zero_sum({self._event_dim})"


class _Complex(Constraint):
    """Complex values (the codomain of the Fourier transforms): every value
    of a complex tensor, and the non-NaN values of a real one."""

    def __call__(self, x):
        return (x == x) | x.is_complex()

    def feasible_like(self, prototype):
        return torch.zeros_like(prototype)

    def __repr__(self):
        return "complex"


class _PositiveDefiniteCirculantVector(Constraint):
    """The first row of a positive definite circulant matrix: its real FFT
    (the matrix's eigenvalues) is positive."""

    event_dim = 1

    def __call__(self, x):
        return (torch.fft.rfft(x).real > 0).all(-1)

    def feasible_like(self, prototype):
        out = torch.zeros_like(prototype)
        out[..., 0] = 1.0
        return out

    def __repr__(self):
        return "positive_definite_circulant_vector"


class _L1Ball(Constraint):
    event_dim = 1

    def __call__(self, x):
        return x.abs().sum(-1) <= 1 + 1e-6

    def feasible_like(self, prototype):
        return torch.zeros_like(prototype)


class _Sphere(Constraint):
    """Unit vectors."""

    event_dim = 1

    def __call__(self, x):
        return (torch.linalg.vector_norm(x, dim=-1) - 1.0).abs() < 1e-6

    def feasible_like(self, prototype):
        out = torch.zeros_like(prototype)
        out[..., 0] = 1.0
        return out


class _Simplex(Constraint):
    """Nonnegative vectors that sum to one."""

    event_dim = 1

    def __call__(self, x):
        return (x >= 0).all(-1) & ((x.sum(-1) - 1.0).abs() < 1e-6)

    def feasible_like(self, prototype):
        return torch.full_like(prototype, 1.0 / prototype.shape[-1])


class _UnitInterval(_Interval):
    """``interval(0, 1)``, a type of its own: ``biject_to`` maps it with a
    bare sigmoid, as the JAX package's type-keyed table does."""

    def __init__(self):
        super().__init__(0.0, 1.0)


boolean = _Boolean()
circular = _Circular()
complex = _Complex()
corr_cholesky = _CorrCholesky()
corr_matrix = _CorrMatrix()
dependent = _Dependent()


def is_dependent(constraint):
    """Whether ``constraint`` is a :data:`dependent` placeholder."""
    return isinstance(constraint, _Dependent)
greater_than = _GreaterThan
greater_than_eq = _GreaterThanEq
independent = _IndependentConstraint
integer_greater_than = _IntegerGreaterThan
integer_interval = _IntegerInterval
interval = _Interval
l1_ball = _L1Ball()
less_than = _LessThan
less_than_eq = _LessThanEq
lower_cholesky = _LowerCholesky()
multinomial = _Multinomial
nonnegative = _GreaterThanEq(0.0)
nonnegative_integer = _IntegerGreaterThan(0)
open_interval = _OpenInterval
ordered_vector = _OrderedVector()
positive = _GreaterThan(0.0)
positive_definite = _PositiveDefinite()
positive_definite_circulant_vector = _PositiveDefiniteCirculantVector()
positive_integer = _IntegerGreaterThan(1)
positive_ordered_vector = _PositiveOrderedVector()
positive_semidefinite = _PositiveSemiDefinite()
real = _Real()
real_matrix = _IndependentConstraint(real, 2)
real_vector = _IndependentConstraint(real, 1)
scaled_unit_lower_cholesky = _ScaledUnitLowerCholesky()
simplex = _Simplex()
softplus_lower_cholesky = _SoftplusLowerCholesky()
softplus_positive = _SoftplusPositive()
sphere = _Sphere()
unit_interval = _UnitInterval()
zero_sum = _ZeroSum
