"""Constraints (port of the parts of ``numpyro_tpu/distributions/constraints.py``
that the covtype slice needs: ``real``, ``independent`` and ``interval``).
Others are not ported yet; see ROADMAP.md."""

from __future__ import annotations

import torch

__all__ = ["Constraint", "independent", "interval", "real"]


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


class _Interval(Constraint):
    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def __call__(self, x):
        return (x >= self.lower_bound) & (x <= self.upper_bound)

    def __repr__(self):
        return f"interval({self.lower_bound}, {self.upper_bound})"


independent = _IndependentConstraint
interval = _Interval
real = _Real()
