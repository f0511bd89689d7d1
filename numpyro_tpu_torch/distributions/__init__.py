from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.continuous import Normal, Uniform
from numpyro_tpu_torch.distributions.distribution import (
    Distribution,
    ExpandedDistribution,
    Independent,
    Unit,
)
from numpyro_tpu_torch.distributions.transforms import biject_to

__all__ = [
    "Distribution",
    "ExpandedDistribution",
    "Independent",
    "Normal",
    "Uniform",
    "Unit",
    "biject_to",
    "constraints",
]
