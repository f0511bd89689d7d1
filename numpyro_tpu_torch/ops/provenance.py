"""Provenance tracking (the counterpart of ``numpyro_tpu/ops/provenance.py``).

``eval_provenance(fn, **kwargs)`` answers "which named inputs can influence
each output?".  The JAX package reads it off the jaxpr of ``fn`` without
running it; the port runs ``fn`` once on :class:`ProvenanceTensor` inputs, a
``torch.Tensor`` subclass that carries a ``frozenset`` of names through
``__torch_function__``: the outputs of every op carry the union of the sets
of its inputs, those nested in tuples, lists and dicts and those used as
indices included (``mus[z]`` with a tagged ``z`` comes out tagged).  Used by
``TraceGraph_ELBO`` to find the costs downstream of each
non-reparameterised site.  The values are computed as well, so ``fn`` runs
at the inputs' real size; control flow that reads a value on the host takes
the path of the values given.
"""

from __future__ import annotations

import torch

__all__ = ["ProvenanceTensor", "eval_provenance", "get_provenance"]


class ProvenanceTensor(torch.Tensor):
    """A tensor with the set of names it depends on (``_provenance``)."""

    @staticmethod
    def __new__(cls, data, provenance=frozenset()):
        if isinstance(data, ProvenanceTensor):
            provenance = provenance | data._provenance
            data = data._t
        out = data.as_subclass(cls)
        out._t = data
        out._provenance = provenance
        return out

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        provenance = set()
        args = _strip(args, provenance)
        kwargs = _strip(kwargs or {}, provenance)
        return _tag(func(*args, **kwargs), frozenset(provenance))


def _strip(x, provenance):
    """``x`` with every ``ProvenanceTensor`` in it (in tuples, lists and
    dicts) replaced by its plain tensor, whose names join ``provenance``."""
    if isinstance(x, ProvenanceTensor):
        provenance.update(x._provenance)
        return x._t
    if isinstance(x, (tuple, list)):
        return type(x)(_strip(v, provenance) for v in x)
    if isinstance(x, dict):
        return {k: _strip(v, provenance) for k, v in x.items()}
    return x


def _tag(x, provenance):
    if isinstance(x, torch.Tensor):
        return ProvenanceTensor(x, provenance)
    if type(x) in (tuple, list):
        return type(x)(_tag(v, provenance) for v in x)
    if isinstance(x, tuple) and hasattr(type(x), "n_fields"):  # torch.return_types
        return type(x)([_tag(v, provenance) for v in x])
    return x


def get_provenance(x):
    """The names a value depends on: empty for anything but a
    ``ProvenanceTensor``."""
    return x._provenance if isinstance(x, ProvenanceTensor) else frozenset()


def _provenance_tree(x):
    if isinstance(x, dict):
        return {k: _provenance_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_provenance_tree(v) for v in x)
    return get_provenance(x)


def eval_provenance(fn, **kwargs):
    """A tree matching ``fn``'s output (dicts, tuples and lists) of the
    ``frozenset``s of the keyword arguments each output depends on.  Runs
    ``fn`` once, without gradients, on its inputs' values."""

    def tag(value, name):
        if isinstance(value, dict):
            return {k: tag(v, name) for k, v in value.items()}
        return ProvenanceTensor(torch.as_tensor(value).detach(), frozenset({name}))

    with torch.no_grad():
        out = fn(**{name: tag(value, name) for name, value in kwargs.items()})
    return _provenance_tree(out)
