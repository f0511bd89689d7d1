from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.continuous import (
    Cauchy,
    HalfCauchy,
    HalfNormal,
    Normal,
    Uniform,
)
from numpyro_tpu_torch.distributions.discrete import Bernoulli, BernoulliLogits, BernoulliProbs
from numpyro_tpu_torch.distributions.distribution import (
    Distribution,
    ExpandedDistribution,
    Independent,
    MaskedDistribution,
    Unit,
)
from numpyro_tpu_torch.distributions.transforms import biject_to

__all__ = [
    "Bernoulli",
    "BernoulliLogits",
    "BernoulliProbs",
    "Cauchy",
    "Distribution",
    "ExpandedDistribution",
    "HalfCauchy",
    "HalfNormal",
    "Independent",
    "MaskedDistribution",
    "Normal",
    "Uniform",
    "Unit",
    "biject_to",
    "constraints",
]
