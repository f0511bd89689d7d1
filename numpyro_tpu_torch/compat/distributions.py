"""pyro-api distributions namespace (port of
``numpyro_tpu/compat/distributions.py``)."""

from numpyro_tpu_torch.distributions import *  # noqa: F401, F403
from numpyro_tpu_torch.distributions import constraints, transforms  # noqa: F401
