"""Shape helpers for the distributions layer (port of the parts of
``numpyro_tpu/distributions/util.py`` that the covtype slice needs)."""

from __future__ import annotations

import functools

import torch

__all__ = ["lazy_property", "promote_shapes", "sum_rightmost"]


def promote_shapes(*args, shape=()):
    """Left-pad arg shapes so they broadcast against each other and ``shape``."""
    if shape == () and len(args) < 2:
        return args
    arg_shapes = [tuple(a.shape) for a in args]
    rank = len(torch.broadcast_shapes(shape, *arg_shapes))
    return [
        a if rank == len(s) else a.reshape((1,) * (rank - len(s)) + s)
        for a, s in zip(args, arg_shapes)
    ]


def sum_rightmost(x, dim):
    """Sum out the ``dim`` rightmost dimensions of ``x``."""
    return x.sum(tuple(range(-dim, 0))) if dim else x


class lazy_property:
    """Cache a derived quantity on first access."""

    def __init__(self, wrapped):
        self.wrapped = wrapped
        functools.update_wrapper(self, wrapped)

    def __get__(self, instance, obj_type=None):
        if instance is None:
            return self
        computed = self.wrapped(instance)
        instance.__dict__[self.wrapped.__name__] = computed
        return computed
