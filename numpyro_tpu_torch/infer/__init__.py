from numpyro_tpu_torch.infer import autoguide, initialization, inspect, reparam
from numpyro_tpu_torch.infer.barker import BarkerMH
from numpyro_tpu_torch.infer.chees import CheesHMC
from numpyro_tpu_torch.infer.elbo import (
    ELBO,
    RenyiELBO,
    Trace_ELBO,
    TraceEnum_ELBO,
    TraceGraph_ELBO,
    TraceMeanField_ELBO,
)
from numpyro_tpu_torch.infer.ensemble import AIES, ESS, EnsembleSampler
from numpyro_tpu_torch.infer.hmc import HMC, NUTS
from numpyro_tpu_torch.infer.hmc_gibbs import HMCECS, DiscreteHMCGibbs, HMCGibbs
from numpyro_tpu_torch.infer.initialization import (
    init_to_feasible,
    init_to_mean,
    init_to_median,
    init_to_sample,
    init_to_uniform,
    init_to_value,
)
from numpyro_tpu_torch.infer.inspect import get_dependencies, get_model_relations, render_model
from numpyro_tpu_torch.infer.mcmc import MCMC, MCMCKernel
from numpyro_tpu_torch.infer.mixed_hmc import MixedHMC
from numpyro_tpu_torch.infer.sa import SA
from numpyro_tpu_torch.infer.smc import SMC, SMCResult
from numpyro_tpu_torch.infer.svi import SVI, SVIRunResult, SVIState
from numpyro_tpu_torch.infer.util import (
    Predictive,
    constrain_fn,
    find_valid_initial_params,
    get_transforms,
    initialize_model,
    log_density,
    log_likelihood,
    potential_energy,
    transform_fn,
    unconstrain_fn,
)

__all__ = [
    "AIES",
    "BarkerMH",
    "CheesHMC",
    "DiscreteHMCGibbs",
    "ESS",
    "EnsembleSampler",
    "ELBO",
    "HMC",
    "HMCECS",
    "HMCGibbs",
    "MCMC",
    "MCMCKernel",
    "MixedHMC",
    "NUTS",
    "Predictive",
    "RenyiELBO",
    "SA",
    "SMC",
    "SMCResult",
    "SVI",
    "SVIRunResult",
    "SVIState",
    "TraceEnum_ELBO",
    "TraceGraph_ELBO",
    "TraceMeanField_ELBO",
    "Trace_ELBO",
    "autoguide",
    "constrain_fn",
    "find_valid_initial_params",
    "get_dependencies",
    "get_model_relations",
    "get_transforms",
    "init_to_feasible",
    "init_to_mean",
    "init_to_median",
    "init_to_sample",
    "init_to_uniform",
    "init_to_value",
    "initialization",
    "initialize_model",
    "inspect",
    "log_density",
    "log_likelihood",
    "potential_energy",
    "render_model",
    "reparam",
    "transform_fn",
    "unconstrain_fn",
]
