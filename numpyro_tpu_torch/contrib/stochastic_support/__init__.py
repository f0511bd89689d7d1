from numpyro_tpu_torch.contrib.stochastic_support.dcc import (
    DCC,
    DCCResult,
    SDVIResult,
    StochasticSupportInference,
)
from numpyro_tpu_torch.contrib.stochastic_support.sdvi import SDVI

__all__ = ["DCC", "DCCResult", "SDVI", "SDVIResult", "StochasticSupportInference"]
