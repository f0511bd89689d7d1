from numpyro_tpu_torch.infer.hmc import HMC, NUTS
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.infer.mcmc import MCMC
from numpyro_tpu_torch.infer.util import initialize_model, log_density, potential_energy

__all__ = [
    "HMC",
    "MCMC",
    "NUTS",
    "init_to_uniform",
    "initialize_model",
    "log_density",
    "potential_energy",
]
