from numpyro_tpu_torch.contrib.hsgp.approximation import (
    hsgp_matern,
    hsgp_periodic_non_centered,
    hsgp_squared_exponential,
    linear_approximation,
)

__all__ = [
    "hsgp_matern",
    "hsgp_periodic_non_centered",
    "hsgp_squared_exponential",
    "linear_approximation",
]
