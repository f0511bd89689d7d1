"""Small shared helpers (port of the parts of ``numpyro_tpu/util.py`` that
the ported slices need, and a tree map over the containers that kernel states
are made of, in place of ``jax.tree.map``)."""

import torch

__all__ = ["identity", "tree_map"]


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
