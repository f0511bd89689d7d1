"""pyro-api ``pyro`` namespace (port of ``numpyro_tpu/compat/pyro.py``):
``sample``, ``plate``, ``module`` and a ``param`` backed by a limited
parameter store."""

import warnings

from numpyro_tpu_torch.compat.util import UnsupportedAPIWarning
from numpyro_tpu_torch.primitives import module, plate, sample  # noqa: F401
from numpyro_tpu_torch.primitives import param as _param

_PARAM_STORE = {}


def get_param_store():
    warnings.warn(
        "A limited parameter store is provided for compatibility with Pyro. "
        "Values of SVI parameters should be obtained via SVI.get_params().",
        category=UnsupportedAPIWarning,
        stacklevel=2,
    )
    return _PARAM_STORE


def clear_param_store():
    return _PARAM_STORE.clear()


def param(name, *args, **kwargs):
    val = _param(name, *args, **kwargs)
    if val is None:
        if args or kwargs:
            raise NotImplementedError
        param_store = get_param_store()
        if name in param_store:
            val = param_store[name]
    return val
