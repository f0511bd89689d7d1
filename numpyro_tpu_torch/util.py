"""Small shared helpers (port of the parts of ``numpyro_tpu/util.py`` that
the ported slices need: ``identity`` and ``soft_vmap``, and a tree map over
the containers that kernel states are made of, in place of
``jax.tree.map``; and ``HostArray``, a constant kept on the host and copied
to each device once)."""

import math

import numpy as np
import torch

__all__ = ["HostArray", "identity", "soft_vmap", "tree_leaves", "tree_map", "tree_unflatten"]


class HostArray:
    """A numpy constant (a network's mask, a permutation) kept on the host
    and copied to each device once: the tensor is cached per device and
    dtype, so no call rebuilds or recopies it."""

    def __init__(self, array):
        self.array = np.asarray(array)
        self._on = {}

    @property
    def shape(self):
        return self.array.shape

    def on(self, device, dtype=None):
        """The array as a tensor on ``device``, in ``dtype`` (by default its
        own)."""
        key = (torch.device(device), dtype)
        tensor = self._on.get(key)
        if tensor is None:
            tensor = torch.as_tensor(self.array, dtype=dtype, device=device)
            self._on[key] = tensor
        return tensor


def identity(x, *args, **kwargs):
    return x


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of ``tree`` (dicts, tuples, lists and
    namedtuples; ``rest`` are trees of the same structure).  Leaves that are
    not tensors (``None``, numbers, generators) are returned as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return tree


def tree_leaves(tree):
    """The tensor leaves of ``tree``, in the order :func:`tree_map` visits
    them."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(tree, leaves):
    """``tree`` with its tensor leaves replaced by ``leaves``, in the order
    of :func:`tree_leaves` (the inverse of that function for ``tree``'s
    structure; ``torch.func`` takes trees of tensors only, so a tree with
    ``None`` leaves is differentiated through its list of tensor leaves)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def soft_vmap(fn, xs, batch_ndims=1, chunk_size=None):
    """Map ``fn`` over the leading ``batch_ndims`` axes of every leaf of
    ``xs``: ``torch.func.vmap`` (``randomness="different"``, so that each
    element draws its own values from a shared generator) within a chunk of
    ``chunk_size`` elements, and a Python loop over the chunks.

    The contract is the JAX package's: the batch axes are collapsed into one,
    a batch of one element is not mapped at all, the last chunk is padded to
    full size and the padding cut from the result, and every output leaf gets
    the batch shape back.  The padding repeats the last element, where the
    JAX package pads zeros: a zero scale or covariance can raise in PyTorch
    (``torch.linalg.cholesky``), where JAX returns NaN that it then drops.
    """
    leaves = tree_leaves(xs)
    batch_shape = tuple(leaves[0].shape[:batch_ndims])
    for x in leaves[1:]:
        assert tuple(x.shape[:batch_ndims]) == batch_shape
    batch_size = math.prod(batch_shape)
    prepend = (batch_size,) if batch_size > 1 else ()
    xs = tree_map(lambda x: x.reshape(prepend + tuple(x.shape[batch_ndims:])), xs)
    if batch_size <= 1:
        return fn(xs)
    mapped = torch.func.vmap(fn, randomness="different")
    if chunk_size is not None and 1 < chunk_size < batch_size:
        pad = -batch_size % chunk_size

        def padded(x):
            if not pad:
                return x
            return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])

        xs = tree_map(padded, xs)
        chunks = [
            mapped(tree_map(lambda x, s=start: x[s:s + chunk_size], xs))
            for start in range(0, batch_size + pad, chunk_size)
        ]
        ys = tree_map(lambda *parts: torch.cat(parts)[:batch_size], chunks[0], *chunks[1:])
    else:
        ys = mapped(xs)
    return tree_map(lambda y: y.reshape(batch_shape + tuple(y.shape[1:])), ys)
