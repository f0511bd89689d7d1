"""Broadcasting advanced indexing for enumerated models (port of
``numpyro_tpu/ops/indexing.py``).

``Vindex(x)[..., i, :, j]`` is ``x[i, :, j]`` with the index tensors
broadcast against each other, and against the batch dims of ``x`` after a
leading ``...``, while each ``:`` keeps its axis as an event dim on the
right.  Slices become ``int64`` ``arange``s (the JAX package's are
``int32``), broadcast onto fresh rightmost dims.
"""

import numpy as np
import torch

__all__ = ["Vindex", "vindex"]


def _ndim(key):
    return key.dim() if isinstance(key, torch.Tensor) else np.ndim(key)


def vindex(arr, keys):
    """``arr[keys]`` read with broadcasting; each key is ``Ellipsis``
    (leading only), ``slice(None)``, an integer or an integer tensor."""
    if not isinstance(keys, tuple):
        return arr[keys]
    if keys == ():
        return arr

    rank = arr.dim()
    assert rank > 0
    if keys[0] is Ellipsis:
        # a leading ... stands for the batch dims in front
        keys = keys[1:]
        if keys == ():
            return arr
        event_dim = len(keys)
        keys = (slice(None),) * (rank - event_dim) + keys
    else:
        keys = keys + (slice(None),) * (rank - len(keys))
        event_dim = len(keys)
    assert len(keys) == rank
    if Ellipsis in keys:
        raise NotImplementedError("only a leading Ellipsis is understood")

    batched = [not isinstance(k, slice) and _ndim(k) > 0 for k in keys]

    # plain advanced indexing already broadcasts right where the array has no
    # batch dims in front and at most the head key is batched
    head_conflict = rank > event_dim and batched[0]
    if not head_conflict and not any(batched[1:]):
        return arr[keys]

    # slices become aranges on fresh rightmost dims; a batched index tensor
    # gets those dims as trailing size-one axes
    kept_dims = sum(isinstance(k, slice) for k in keys[-event_dim:])
    rewritten, fresh = [], 0
    for pos in reversed(range(rank)):
        key = keys[pos]
        if isinstance(key, slice):
            if key != slice(None):
                raise NotImplementedError("nontrivial slices are unsupported")
            key = torch.arange(arr.shape[pos], dtype=torch.int64, device=arr.device).reshape(
                (-1,) + (1,) * fresh
            )
            fresh += 1
        elif batched[pos]:
            if not isinstance(key, torch.Tensor):
                key = torch.as_tensor(key, device=arr.device)
            key = key.reshape(tuple(key.shape) + (1,) * kept_dims)
        rewritten.append(key)
    return arr[tuple(reversed(rewritten))]


class Vindex:
    """``Vindex(x)[..., i, j, :]`` is ``vindex(x, (Ellipsis, i, j,
    slice(None)))``."""

    __slots__ = ("_arr",)

    def __init__(self, arr):
        self._arr = arr

    def __getitem__(self, keys):
        return vindex(self._arr, keys)
