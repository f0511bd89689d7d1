"""Network blocks for the flow guides (port of ``numpyro_tpu/nn``).

Each block is an ``(init_fn, apply_fn)`` pair, as in the JAX package:
``init_fn(generator, input_shape) -> (output_shape, params)`` draws the
parameters with a ``torch.Generator`` (on the generator's device), and
``apply_fn(params, x)`` runs the network.  The parameters are a tree of
tensors laid out as the JAX package lays them out, so that ``module`` keeps
them in one ``param`` site and SVI's optimizers see them as a tree;
:func:`params_from_numpy` carries a JAX network's parameters across, and
:func:`params_from_linen` a flax linen network's into a ``torch.nn.Module``
(for ``contrib.module.torch_module``).
Masks are numpy arrays built once, moved to a device once
(:class:`numpyro_tpu_torch.util.HostArray`), never rebuilt on a call.
"""

from numpyro_tpu_torch.nn.auto_reg_nn import AutoregressiveNN
from numpyro_tpu_torch.nn.block_neural_arn import BlockNeuralAutoregressiveNN
from numpyro_tpu_torch.nn.masked_dense import MaskedDense
from numpyro_tpu_torch.nn.util import params_from_linen, params_from_numpy

__all__ = [
    "AutoregressiveNN",
    "BlockNeuralAutoregressiveNN",
    "MaskedDense",
    "params_from_linen",
    "params_from_numpy",
]
