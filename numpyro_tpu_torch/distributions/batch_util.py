"""The batch shape of a distribution whose tensors gained a leading dim
(port of ``promote_batch_shape`` from
``numpyro_tpu/distributions/batch_util.py``, as far as the stacked sites of
``scan`` need it).

``scan`` stacks the per-step distributions of a site along time: every
tensor the distribution holds gains one leading dim, and its recorded batch
shape must gain that dim too.  The tensors of a distribution lead with its
batch dims (``Distribution._init_broadcast`` pads them to the batch rank),
so the new dim is a new leading batch dim.
"""

from __future__ import annotations

import copy

import torch

from .distribution import (
    Distribution,
    ExpandedDistribution,
    Independent,
    MaskedDistribution,
    TransformedDistribution,
)

__all__ = ["promote_batch_shape"]


def _map_tensors(obj, fn):
    """A copy of ``obj`` (a distribution, transform, constraint or container)
    with ``fn`` applied to each tensor it holds."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        new = copy.copy(obj)
        for key, value in obj.__dict__.items():
            new.__dict__[key] = _map_tensors(value, fn)
        return new
    return obj


def promote_batch_shape(d, new_dims):
    """``d`` with the leading ``new_dims`` dims of its tensors added to the
    front of its batch shape."""
    new = copy.copy(d)
    if isinstance(d, ExpandedDistribution):
        # the dims that the expansion added sit between the new dims and the
        # base's own: the base's tensors get size-one axes there
        delta = len(d.batch_shape) - len(d.base_dist.batch_shape)
        base = promote_batch_shape(d.base_dist, new_dims)
        if delta:
            n = len(new_dims)
            base = _map_tensors(
                base, lambda t: t.reshape(tuple(t.shape[:n]) + (1,) * delta + tuple(t.shape[n:]))
            )
            base._batch_shape = tuple(new_dims) + (1,) * delta + tuple(d.base_dist.batch_shape)
        new.base_dist = base
        new._batch_shape = tuple(new_dims) + tuple(d.batch_shape)
    elif isinstance(d, Independent):
        new.base_dist = promote_batch_shape(d.base_dist, new_dims)
        cut = len(new.base_dist.batch_shape) - d.reinterpreted_batch_ndims
        new._batch_shape = new.base_dist.batch_shape[:cut]
    elif isinstance(d, (MaskedDistribution, TransformedDistribution)):
        new.base_dist = promote_batch_shape(d.base_dist, new_dims)
        new._batch_shape = tuple(new_dims) + tuple(d.batch_shape)
    elif isinstance(d, Distribution):
        new._batch_shape = tuple(new_dims) + tuple(d.batch_shape)
    else:
        raise NotImplementedError(f"cannot promote batch shape of {type(d)}")
    return new
