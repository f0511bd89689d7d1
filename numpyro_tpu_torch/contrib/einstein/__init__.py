"""Stein variational inference in the port: SteinVI, SVGD and ASVGD with
the Stein kernels, the mixture loss and the mixture predictive (port of
``numpyro_tpu/contrib/einstein``)."""

from numpyro_tpu_torch.contrib.einstein.mixture_guide_predictive import (
    MixtureGuidePredictive,
)
from numpyro_tpu_torch.contrib.einstein.stein_kernels import (
    GraphicalKernel,
    IMQKernel,
    LinearKernel,
    MixtureKernel,
    ProbabilityProductKernel,
    RadialGaussNewtonKernel,
    RandomFeatureKernel,
    RBFKernel,
)
from numpyro_tpu_torch.contrib.einstein.stein_loss import SteinLoss
from numpyro_tpu_torch.contrib.einstein.steinvi import ASVGD, SVGD, SteinVI

__all__ = [
    "ASVGD",
    "GraphicalKernel",
    "IMQKernel",
    "LinearKernel",
    "MixtureGuidePredictive",
    "MixtureKernel",
    "ProbabilityProductKernel",
    "RadialGaussNewtonKernel",
    "RandomFeatureKernel",
    "RBFKernel",
    "SteinLoss",
    "SteinVI",
    "SVGD",
]
