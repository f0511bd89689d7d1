from numpyro_tpu_torch.infer.hmc import HMC, NUTS
from numpyro_tpu_torch.infer.hmc_gibbs import HMCECS, DiscreteHMCGibbs, HMCGibbs
from numpyro_tpu_torch.infer.initialization import init_to_sample, init_to_uniform
from numpyro_tpu_torch.infer.mcmc import MCMC, MCMCKernel
from numpyro_tpu_torch.infer.util import initialize_model, log_density, potential_energy

__all__ = [
    "DiscreteHMCGibbs",
    "HMC",
    "HMCECS",
    "HMCGibbs",
    "MCMC",
    "MCMCKernel",
    "NUTS",
    "init_to_sample",
    "init_to_uniform",
    "initialize_model",
    "log_density",
    "potential_energy",
]
