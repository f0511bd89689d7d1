"""Block neural autoregressive network (De Cao, Titov & Aziz 2019), the
network of the BNAF flow (port of ``numpyro_tpu/nn/block_neural_arn.py``).

A pipeline of layers threading ``(x, block_logdet)``.  Each linear layer is
block lower-triangular with positive (exp-parameterised, weight-normalised)
diagonal blocks; the per-block log-Jacobians chain through the depth with
``logmatmulexp``.  A linear layer's params are a dict ``{"w", "log_scale",
"b"}``, a tanh layer's an empty tuple, and a gated residual adds a scalar
gate at the end, as in the JAX package.  The block masks are numpy, built
once.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn.functional import softplus

from numpyro_tpu_torch.distributions.util import logmatmulexp
from numpyro_tpu_torch.nn.util import glorot_uniform, normal, uniform
from numpyro_tpu_torch.util import HostArray

__all__ = ["BlockNeuralAutoregressiveNN", "LeakyTanh", "Tanh"]


def _block_masks(num_blocks, in_factor, out_factor):
    """(diagonal-block mask, strictly-lower-block mask) as numpy."""
    rows, cols = np.arange(num_blocks), np.arange(num_blocks)
    block_eq = rows[:, None] == cols[None, :]
    block_lt = rows[:, None] > cols[None, :]

    def expand(block):
        return np.kron(block, np.ones((in_factor, out_factor))).astype(np.float32)

    return expand(block_eq), expand(block_lt)


def _linear_layer(num_blocks, in_factor, out_factor, bias=True):
    in_dim, out_dim = num_blocks * in_factor, num_blocks * out_factor
    diag, low = _block_masks(num_blocks, in_factor, out_factor)
    mask_diag, mask_low, mask_allowed = HostArray(diag), HostArray(low), HostArray(diag + low)
    w_init, unit = glorot_uniform(), uniform(1.0)

    def init(generator):
        w = w_init(generator, (in_dim, out_dim))
        # only the allowed (lower-block-triangular) region is initialised
        w = w * mask_allowed.on(w.device, w.dtype)
        log_scale = torch.log(unit(generator, (out_dim,)))
        b = (unit(generator, (out_dim,)) - 0.5) * (2 / math.sqrt(out_dim)) if bias else None
        return {"w": w, "log_scale": log_scale, "b": b}

    def apply(p, x, logdet):
        w = p["w"]
        md, ml = mask_diag.on(w.device, w.dtype), mask_low.on(w.device, w.dtype)
        # positive diagonal blocks through exp; weight-normalised columns
        w = torch.exp(p["w"]) * md + p["w"] * ml
        col_norm = torch.linalg.vector_norm(w, dim=-2, keepdim=True)
        w = torch.exp(p["log_scale"]) * w / col_norm
        y = x @ w
        if p["b"] is not None:
            y = y + p["b"]
        # the log of the (positive) entries of the diagonal blocks,
        # (num_blocks, in_factor, out_factor): JAX's
        # layer_ld[arange(nb), :, arange(nb), :] as a diagonal
        layer_ld = p["log_scale"] + p["w"] - torch.log(col_norm)
        layer_ld = layer_ld.reshape(num_blocks, in_factor, num_blocks, out_factor)
        layer_ld = torch.diagonal(layer_ld, dim1=0, dim2=2).movedim(-1, 0)
        if logdet is None:
            logdet = torch.broadcast_to(layer_ld, tuple(x.shape[:-1]) + tuple(layer_ld.shape))
        else:
            logdet = logmatmulexp(logdet, layer_ld)
        return y, logdet

    return init, apply


def _tanh_layer(min_grad=0.0):
    """tanh (or tanh + min_grad * x) with its per-element log-Jacobian."""

    def init(generator):
        return ()

    def apply(p, x, logdet):
        base_ld = 2.0 * (math.log(2.0) - x - softplus(-2.0 * x))
        if min_grad > 0:
            y = torch.tanh(x) + min_grad * x
            ld = torch.logaddexp(base_ld, torch.full_like(base_ld, math.log(min_grad)))
        else:
            y = torch.tanh(x)
            ld = base_ld
        ld = ld.reshape(tuple(logdet.shape[:-2]) + (1, logdet.shape[-1]))
        return y, logdet + ld

    return init, apply


def Tanh():
    return _tanh_layer(0.0)


def LeakyTanh(min_grad: float = 0.01):
    return _tanh_layer(min_grad)


def BlockNeuralAutoregressiveNN(input_dim, hidden_factors=(8, 8), residual=None,
                                activation=None):
    """An ``(init_fn, apply_fn)`` pair; ``apply_fn(params, x)`` returns
    ``(y, logdet)`` with ``logdet`` of ``x``'s shape.  ``residual`` is
    ``None``, ``"normal"`` or ``"gated"``; ``activation`` a layer pair
    (``LeakyTanh()`` by default)."""
    if residual not in (None, "normal", "gated"):
        raise ValueError(f"unknown residual mode {residual!r}")
    act = LeakyTanh() if activation is None else activation
    layers = []
    widths = [1] + list(hidden_factors) + [1]
    for a, b in zip(widths[:-1], widths[1:]):
        layers.append(_linear_layer(input_dim, a, b))
        layers.append(act)
    layers = layers[:-1]  # no activation after the last block layer
    gate_init = normal(1.0)

    def init_fn(generator, input_shape):
        assert input_shape[-1] == input_dim
        params = [init(generator) for init, _ in layers]
        if residual == "gated":
            params.append(gate_init(generator, ()))
        return tuple(input_shape[:-1]) + (input_dim,), params

    def apply_fn(params, x, **kwargs):
        y, logdet = x, None
        for (_, apply), p in zip(layers, params):
            y, logdet = apply(p, y, logdet)
        if residual == "normal":
            y = y + x
            logdet = softplus(logdet)
        elif residual == "gated":
            gate_raw = params[-1]
            gate = torch.sigmoid(gate_raw)
            y = gate * y + (1 - gate) * x
            logdet = softplus(logdet + gate_raw) - softplus(gate_raw)
        return y, logdet.reshape(x.shape)

    return init_fn, apply_fn
