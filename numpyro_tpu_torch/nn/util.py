"""Initializers and the carry-across of JAX parameters.

The initializers draw from the families of ``jax.nn.initializers`` that the
blocks use (``glorot_normal``: a normal truncated to two standard
deviations, scaled to variance ``2 / (fan_in + fan_out)``; ``glorot_uniform``;
``normal`` and ``uniform``), with a ``torch.Generator``; the values cannot
match JAX's bit for bit, so parity tests carry JAX's parameters across.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "glorot_normal", "glorot_uniform", "normal", "params_from_linen", "params_from_numpy",
    "uniform",
]


def _device(generator):
    if generator is None:
        raise ValueError(
            "Cannot initialize a network's parameters without a torch.Generator: "
            "call `module` inside a `seed` handler or pass a generator to `init_fn`."
        )
    return generator.device


def _fan_avg(shape):
    fan_in, fan_out = shape[-2], shape[-1]
    receptive = math.prod(shape[:-2])
    return (fan_in + fan_out) * receptive / 2.0


def glorot_normal(dtype=None):
    """``variance_scaling(1, "fan_avg", "truncated_normal")``: the normal's
    stddev is divided by 0.8796..., the stddev of a standard normal cut at
    +-2, so that the draws have the intended variance."""

    def init(generator, shape):
        shape = tuple(shape)
        stddev = math.sqrt(1.0 / _fan_avg(shape)) / 0.87962566103423978
        out = torch.empty(shape, dtype=dtype, device=_device(generator))
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return out * stddev

    return init


def glorot_uniform(dtype=None):
    """``variance_scaling(1, "fan_avg", "uniform")``."""

    def init(generator, shape):
        shape = tuple(shape)
        limit = math.sqrt(3.0 / _fan_avg(shape))
        u = torch.rand(shape, dtype=dtype, device=_device(generator), generator=generator)
        return (2.0 * u - 1.0) * limit

    return init


def normal(stddev=1e-2, dtype=None):
    def init(generator, shape):
        return stddev * torch.randn(tuple(shape), dtype=dtype, device=_device(generator),
                                    generator=generator)

    return init


def uniform(scale=1e-2, dtype=None):
    """Uniform on ``[0, scale)``."""

    def init(generator, shape):
        return scale * torch.rand(tuple(shape), dtype=dtype, device=_device(generator),
                                  generator=generator)

    return init


def params_from_numpy(tree, device, dtype=torch.float32):
    """A JAX network's parameters in the port's layout: a nested list, tuple
    or dict of numpy arrays (``None`` where a layer has none) in, the same
    structure of tensors on ``device`` out."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return torch.as_tensor(np.array(tree), dtype=dtype, device=device)


def params_from_linen(params, module):
    """A flax linen network's parameters as ``module``'s: ``params`` is the
    linen tree of numpy arrays (``{"Dense_0": {"kernel", "bias"}, ...}``, or
    that under ``"params"``), ``module`` a ``torch.nn.Module`` whose
    ``nn.Linear`` layers (in ``named_modules()`` order) come in the order of
    the ``Dense_i``, ``i`` ascending (linen numbers a compact module's layers
    in the order it makes them, which need not be the order it applies
    them).  Returns a dict keyed by the module's
    parameter names (``"0.weight"``, ``"0.bias"``, ...), each on the device
    and in the dtype of that parameter: a ``Dense`` kernel ``(in, out)`` is
    the transpose of a ``Linear`` weight ``(out, in)``.  Load it with
    ``module.load_state_dict(..., strict=False)``, or substitute it for the
    ``name$params`` site of ``contrib.module.torch_module``."""
    if set(params) == {"params"}:
        params = params["params"]
    dense = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    if len(dense) != len(params):
        raise ValueError(f"params_from_linen carries Dense layers only; got {sorted(params)}")
    linears = [(name, m) for name, m in module.named_modules()
               if isinstance(m, torch.nn.Linear)]
    if len(linears) != len(dense):
        raise ValueError(f"the linen tree has {len(dense)} Dense layers but the module "
                         f"{len(linears)} Linear layers")
    out = {}
    for key, (name, layer) in zip(dense, linears):
        prefix = f"{name}." if name else ""
        kernel = np.asarray(params[key]["kernel"])
        if kernel.shape[::-1] != tuple(layer.weight.shape):
            raise ValueError(f"{key}'s kernel {kernel.shape} does not fit {prefix}weight "
                             f"{tuple(layer.weight.shape)} transposed")
        like = layer.weight
        out[prefix + "weight"] = torch.tensor(kernel.T, dtype=like.dtype, device=like.device)
        if layer.bias is not None:
            out[prefix + "bias"] = torch.tensor(np.asarray(params[key]["bias"]),
                                                dtype=like.dtype, device=like.device)
    return out
