"""Utilities of the Stein ensemble (port of
``numpyro_tpu/contrib/einstein/stein_util.py``).

The flat ``(P, D)`` layout follows JAX's pytree order: a dict's entries in
the order of its *sorted* keys, a list's or a tuple's in their own order,
so a flat particle of the port holds its numbers where the JAX package's
holds them, and ``SteinVI._calc_particle_info``'s index ranges (sorted by
name too) fit both.
"""

from __future__ import annotations

import math

import torch

from numpyro_tpu_torch.distributions.transforms import IdentityTransform, biject_to

__all__ = ["batch_ravel_pytree", "get_parameter_transform"]


def _leaves(tree):
    """The tensor leaves of ``tree`` in JAX's flattening order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def _rebuild(tree, leaves):
    """``tree`` with its tensor leaves taken in turn from the iterator
    ``leaves``, in the order of :func:`_leaves`."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        rebuilt = {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
        return {key: rebuilt[key] for key in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(item, leaves) for item in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, leaves) for item in tree)
    return tree


def _unraveler(pytree, nbatch_dims):
    """The function from ``(..., D)`` flat rows to trees of ``pytree``'s
    structure whose leaves have the leading dims of the rows."""
    leaves = _leaves(pytree)
    shapes = [tuple(leaf.shape[nbatch_dims:]) for leaf in leaves]
    sizes = [math.prod(shape) for shape in shapes]

    def unravel(flat):
        lead = tuple(flat.shape[:-1])
        parts = torch.split(flat, sizes, dim=-1)
        return _rebuild(pytree, iter(
            part.reshape(lead + shape) for part, shape in zip(parts, shapes)))

    return unravel


def batch_ravel_pytree(pytree, nbatch_dims=1):
    """Flatten a pytree whose leaves share ``nbatch_dims`` leading batch dims
    into a ``(batch, flat)`` tensor (the batch dims collapsed into one);
    returns ``(flat, unravel_one, unravel_batch)``.  ``unravel_one`` maps a
    ``(D,)`` row and ``unravel_batch`` a ``(B, D)`` panel back to trees; both
    take any leading dims, and neither copies more than ``torch.split``."""
    leaves = _leaves(pytree)
    if nbatch_dims == 0:
        flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
        unravel = _unraveler(pytree, 0)
        return flat, unravel, unravel
    batch = math.prod(leaves[0].shape[:nbatch_dims])
    flat = torch.cat([leaf.reshape(batch, -1) for leaf in leaves], dim=1)
    unravel = _unraveler(pytree, nbatch_dims)
    return flat, unravel, unravel


def get_parameter_transform(site):
    """``biject_to`` of a param site's constraint (the identity where the
    site has none)."""
    constraint = site["kwargs"].get("constraint")
    if constraint is None:
        return IdentityTransform()
    return biject_to(constraint)


def _generator_of(rng_key):
    """The generator of a random state: the generator itself, or a draw
    source's ``generator``."""
    return rng_key if isinstance(rng_key, torch.Generator) else rng_key.generator


def _key_at(rng_key, index):
    """The random state of element ``index`` of a mapped axis, as the JAX
    package hands element ``i`` the ``i``-th of its split keys: a generator
    as it is (``torch.func.vmap(..., randomness="different")`` gives each
    element its own numbers), or a draw source's ``at(index)`` (``index``
    batched under ``vmap``)."""
    if isinstance(rng_key, torch.Generator):
        return rng_key
    return rng_key.at(index)
