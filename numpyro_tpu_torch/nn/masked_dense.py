"""Masked dense layer, the building block of MADE-type autoregressive
networks (port of ``numpyro_tpu/nn/masked_dense.py``): the mask multiplies
the weight matrix, so each output sees only its permitted inputs, and the
product stays one ``torch.matmul``."""

from __future__ import annotations

from numpyro_tpu_torch.nn.util import glorot_normal, normal
from numpyro_tpu_torch.util import HostArray

__all__ = ["MaskedDense"]


def MaskedDense(mask, bias=True, W_init=None, b_init=None):
    """An ``(init_fn, apply_fn)`` pair computing ``inputs @ (W * mask) + b``;
    ``mask`` is a numpy array of shape ``(in, out)``.  The params are
    ``(W, b)`` with ``W`` of shape ``(in, out)``, or ``W`` alone without a
    bias, as in the JAX package."""
    mask = HostArray(mask)
    W_init = glorot_normal() if W_init is None else W_init
    b_init = normal() if b_init is None else b_init

    def init_fun(generator, input_shape):
        W = W_init(generator, mask.shape)
        params = (W, b_init(generator, mask.shape[-1:])) if bias else W
        return tuple(input_shape[:-1]) + mask.shape[-1:], params

    def apply_fun(params, inputs, **kwargs):
        if bias:
            W, b = params
            return inputs @ (W * mask.on(W.device, W.dtype)) + b
        return inputs @ (params * mask.on(params.device, params.dtype))

    return init_fun, apply_fun
