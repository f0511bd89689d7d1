"""numpyro_tpu_torch -- the PyTorch and CUDA port of numpyro_tpu.

The model DSL, distributions, NUTS engine, MCMC driver and SVI of the JAX
package, ported slice by slice for NVIDIA GPUs (see ROADMAP.md for what is
ported).  Every kernel that the JAX package wrote in Pallas for the TPU is a
CUDA kernel written by hand for Hopper (``numpyro_tpu_torch/csrc``), built
on first use.  The package imports ``torch`` and never ``jax``.
"""

from numpyro_tpu_torch import distributions, handlers
from numpyro_tpu_torch.distributions import enable_validation, validation_enabled
from numpyro_tpu_torch.primitives import (
    deterministic, factor, get_mask, module, mutable, param, plate, plate_stack, prng_key, sample,
    subsample,
)
from numpyro_tpu_torch import diagnostics, infer, nn, ops, optim
from numpyro_tpu_torch.infer.inspect import get_dependencies, render_model
from numpyro_tpu_torch.diagnostics import print_summary
from numpyro_tpu_torch.util import enable_x64
from numpyro_tpu_torch import checkpoint, compat

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "checkpoint",
    "compat",
    "deterministic",
    "diagnostics",
    "distributions",
    "enable_validation",
    "enable_x64",
    "factor",
    "get_dependencies",
    "get_mask",
    "handlers",
    "infer",
    "module",
    "mutable",
    "nn",
    "ops",
    "optim",
    "param",
    "plate",
    "plate_stack",
    "print_summary",
    "prng_key",
    "render_model",
    "sample",
    "subsample",
    "validation_enabled",
]
