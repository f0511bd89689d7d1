"""MADE-style autoregressive network (Germain et al., arXiv:1502.03509),
the conditioner of the IAF flow (port of ``numpyro_tpu/nn/auto_reg_nn.py``).

The network is a list of ``(W, b)`` pairs (``W`` of shape ``(in, out)``)
applied in a loop, plus a ``(W_skip, None)`` pair with skip connections, as
in the JAX package.  The masks are numpy, built once when the network is
made: the permutation is always concrete here, so the JAX package's branch
for a traced permutation has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from numpyro_tpu_torch.nn.util import glorot_normal, normal
from numpyro_tpu_torch.util import HostArray

__all__ = ["AutoregressiveNN"]


def _build_masks(input_dim, hidden_dims, permutation, out_mult):
    """Connectivity masks: hidden units pass degree >=, outputs need strict >
    (so output i never sees input i).  The degree of input position p is its
    rank (1-based) under ``permutation``; hidden degrees spread evenly over
    1..input_dim-1."""
    hidden_degs = [np.round(np.linspace(1, max(input_dim - 1, 1), h)) for h in hidden_dims]
    perm = np.asarray(permutation)
    rank = np.empty(input_dim)
    rank[perm] = np.arange(input_dim)
    in_deg = rank + 1.0
    out_deg = np.tile(in_deg, out_mult)
    chain = [in_deg] + [np.asarray(h) for h in hidden_degs]
    masks = [
        (b[None, :] >= a[:, None]).astype(np.float32) for a, b in zip(chain[:-1], chain[1:])
    ]
    masks.append((out_deg[None, :] > chain[-1][:, None]).astype(np.float32))
    skip = (out_deg[None, :] > in_deg[:, None]).astype(np.float32)
    return masks, skip


def AutoregressiveNN(input_dim, hidden_dims, param_dims=(1, 1), permutation=None,
                     skip_connections=False, nonlinearity=None):
    """Masked MLP whose k-th output block is autoregressive under
    ``permutation``; ``apply_fn`` returns one tensor per entry of
    ``param_dims`` (the leading axis of size ``dim_k`` dropped when
    ``dim_k == 1``), or the one tensor for a single entry.
    ``nonlinearity`` is a callable (``torch.relu`` by default); a stax
    ``(init, apply)`` pair has no meaning in PyTorch and raises."""
    for h in hidden_dims:
        if h < input_dim:
            raise ValueError("Hidden dimension must not be less than input dimension.")
    if permutation is None:
        permutation = np.arange(input_dim)
    if nonlinearity is None:
        activate = torch.relu
    elif isinstance(nonlinearity, tuple) or not callable(nonlinearity):
        raise TypeError(
            "nonlinearity must be a callable on tensors (torch.nn.functional.elu, ...); "
            "a stax (init_fn, apply_fn) pair has no meaning in numpyro_tpu_torch"
        )
    else:
        activate = nonlinearity

    param_dims = list(param_dims)
    out_mult = int(sum(param_dims))
    masks, skip_mask = _build_masks(input_dim, hidden_dims, permutation, out_mult)
    masks = [HostArray(m) for m in masks]
    skip_mask = HostArray(skip_mask)
    w_init, b_init = glorot_normal(), normal()

    def init_fn(generator, input_shape):
        assert input_shape[-1] == input_dim
        params = [(w_init(generator, m.shape), b_init(generator, (m.shape[1],))) for m in masks]
        if skip_connections:
            params.append((w_init(generator, skip_mask.shape), None))
        return tuple(input_shape[:-1]) + (out_mult * input_dim,), params

    def apply_fn(params, x, **kwargs):
        h = x
        for depth, ((w, b), mask) in enumerate(zip(params[: len(masks)], masks)):
            h = h @ (w * mask.on(w.device, w.dtype)) + b
            if depth < len(masks) - 1:
                h = activate(h)
        if skip_connections:
            w_skip, _ = params[len(masks)]
            h = h + x @ (w_skip * skip_mask.on(w_skip.device, w_skip.dtype))
        blocks = torch.movedim(h.reshape(tuple(x.shape[:-1]) + (out_mult, input_dim)), -2, 0)
        if len(param_dims) == 1:
            return blocks[0] if param_dims[0] == 1 else blocks
        pieces = torch.split(blocks, param_dims, dim=0)
        return tuple(p[0] if d == 1 else p for p, d in zip(pieces, param_dims))

    return init_fn, apply_fn
