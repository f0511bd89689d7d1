"""Shape and log-space helpers for the distributions layer (port of the
parts of ``numpyro_tpu/distributions/util.py`` that the ported slices need)."""

from __future__ import annotations

import functools

import torch

__all__ = [
    "broadcast_shape", "cholesky_update", "lazy_property", "logmatmulexp", "promote_shapes", "scale_and_mask",
    "sum_rightmost",
]


def broadcast_shape(*shapes):
    """The broadcast of shapes given as tuples, as ``torch.broadcast_shapes``
    gives it (a ``RuntimeError`` where they do not broadcast), in plain
    Python: the torch function runs a Python reference implementation of ~70
    us a call, and a potential evaluation calls this for every site."""
    rank = max((len(s) for s in shapes), default=0)
    out = [1] * rank
    for shape in shapes:
        for i, n in enumerate(shape, rank - len(shape)):
            if n != 1:
                if out[i] != 1 and out[i] != n:
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = n
    return tuple(out)


def promote_shapes(*args, shape=()):
    """Left-pad arg shapes so they broadcast against each other and ``shape``."""
    if shape == () and len(args) < 2:
        return args
    arg_shapes = [tuple(a.shape) for a in args]
    rank = len(broadcast_shape(shape, *arg_shapes))
    return [
        a if rank == len(s) else a.reshape((1,) * (rank - len(s)) + s)
        for a, s in zip(args, arg_shapes)
    ]


def sum_rightmost(x, dim):
    """Sum out the ``dim`` rightmost dimensions of ``x``."""
    return x.sum(tuple(range(-dim, 0))) if dim else x


def scale_and_mask(x, scale=None, mask=None):
    """Scale a log-prob tensor, with 0 where ``mask`` is False."""
    scaled = x if scale is None else x * scale
    return scaled if mask is None else torch.where(mask, scaled, torch.zeros_like(scaled))


def cholesky_update(L, x, coef=1):
    """Cholesky factor of ``L @ L.T + coef * outer(x, x)``, batched, by the
    rank-one LDL update of Gill, Golub, Murray and Saunders (parity:
    ``cholesky_update`` of ``numpyro_tpu/distributions/util.py``): a Python
    loop over the ``n`` columns, each step on the whole batch."""
    batch_shape = broadcast_shape(tuple(L.shape[:-2]), tuple(x.shape[:-1]))
    n = x.shape[-1]
    L = L.expand(batch_shape + (n, n))
    w = x.expand(batch_shape + (n,))
    diag = L.diagonal(dim1=-2, dim2=-1)
    Lu = L / diag[..., None, :]  # unit-diagonal lower triangular
    D = diag.square()
    rows = torch.arange(n, device=L.device)
    a = torch.full(batch_shape, float(coef), dtype=x.dtype, device=x.device)
    d_new, cols = [], []
    for j in range(n):
        d_j, col = D[..., j], Lu[..., :, j]
        p = w[..., j]
        gamma = d_j + a * p.square()
        beta = p * a / gamma
        a = a * d_j / gamma
        w = w - p[..., None] * col
        cols.append(col + beta[..., None] * w * (rows > j))
        d_new.append(gamma)
    return torch.stack(cols, -1) * torch.stack(d_new, -1).sqrt()[..., None, :]


def logmatmulexp(x, y):
    """``log(exp(x) @ exp(y))`` without overflow: each row of ``x`` and column
    of ``y`` is shifted by its max, held out of the gradient.  The product is
    ``torch.matmul``, so it runs in full f32 where the caller keeps TF32 off
    (``infer.util.pin_full_f32_matmul``)."""
    row_max = x.amax(-1, keepdim=True).detach()
    col_max = y.amax(-2, keepdim=True).detach()
    centered = torch.matmul(torch.exp(x - row_max), torch.exp(y - col_max))
    return torch.log(centered) + row_max + col_max


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
