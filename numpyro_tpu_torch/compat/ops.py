"""pyro-api ops namespace (port of ``numpyro_tpu/compat/ops.py``): torch's
namespace, where the JAX package puts ``jax.numpy`` in torch's place, with
``ones``, ``zeros`` and ``randn`` taking a size as varargs or as one tuple
and raising ``ValueError`` on a missing or non-integer size, as the JAX
package's shims do, and ``tensor`` making floating-point data in the default
dtype (``jnp.array`` makes float64 data float32 unless x64 is on).

``randn`` draws on the host from numpy's global generator, as the JAX
package's does, so after ``util.set_rng_seed`` both packages give the same
numbers; it is for test scaffolding, not for models (their draws come from
the ``seed`` handler's generator).
"""

import builtins as _builtins

import numpy as _np
import torch as _torch
from torch import *  # noqa: F401, F403


def tensor(data, dtype=None, device=None):
    """``data`` as a tensor (a copy), floating-point data in the default
    dtype where no ``dtype`` is given."""
    out = _torch.as_tensor(data, dtype=dtype, device=device).clone()
    if dtype is None and out.is_floating_point():
        out = out.to(_torch.get_default_dtype())
    return out


def _as_shape(sizes):
    if not sizes:
        raise ValueError("Positional `size` argument not provided.")
    if len(sizes) == 1 and isinstance(sizes[0], (tuple, list, _torch.Size)):
        sizes = tuple(sizes[0])
    # NB: the star-import shadows builtins (all, int, ...) with torch's names
    if not _builtins.all(isinstance(s, (_builtins.int, _np.integer)) for s in sizes):
        raise ValueError("Invalid data type for `size` provided.")
    return tuple(_builtins.int(s) for s in sizes)


def ones(*sizes, **kwargs):
    return _torch.ones(_as_shape(sizes), **kwargs)


def zeros(*sizes, **kwargs):
    return _torch.zeros(_as_shape(sizes), **kwargs)


def randn(*sizes, **kwargs):
    """``torch.randn`` lookalike drawn from numpy's global generator on the
    host (float64 draws in the default dtype, or ``kwargs``' ``dtype`` and
    ``device``)."""
    kwargs.setdefault("dtype", _torch.get_default_dtype())
    return _torch.as_tensor(_np.random.randn(*_as_shape(sizes)), **kwargs)
