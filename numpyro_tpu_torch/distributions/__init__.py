from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.continuous import (
    Cauchy,
    Dirichlet,
    Exponential,
    GaussianRandomWalk,
    HalfCauchy,
    HalfNormal,
    LowRankMultivariateNormal,
    MultivariateNormal,
    Normal,
    StudentT,
    Uniform,
)
from numpyro_tpu_torch.distributions.discrete import (
    Bernoulli,
    BernoulliLogits,
    BernoulliProbs,
    Categorical,
    CategoricalLogits,
    CategoricalProbs,
)
from numpyro_tpu_torch.distributions.distribution import (
    Delta,
    Distribution,
    ExpandedDistribution,
    Independent,
    MaskedDistribution,
    TransformedDistribution,
    Unit,
)
from numpyro_tpu_torch.distributions.kl import kl_divergence
from numpyro_tpu_torch.distributions.transforms import biject_to

__all__ = [
    "Bernoulli",
    "BernoulliLogits",
    "BernoulliProbs",
    "Categorical",
    "CategoricalLogits",
    "CategoricalProbs",
    "Cauchy",
    "Delta",
    "Dirichlet",
    "Distribution",
    "ExpandedDistribution",
    "Exponential",
    "GaussianRandomWalk",
    "HalfCauchy",
    "HalfNormal",
    "Independent",
    "LowRankMultivariateNormal",
    "MaskedDistribution",
    "MultivariateNormal",
    "Normal",
    "StudentT",
    "TransformedDistribution",
    "Uniform",
    "Unit",
    "biject_to",
    "constraints",
    "kl_divergence",
]
