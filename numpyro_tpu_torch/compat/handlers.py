"""pyro-api handlers namespace (port of ``numpyro_tpu/compat/handlers.py``)."""

from numpyro_tpu_torch.handlers import *  # noqa: F401, F403
