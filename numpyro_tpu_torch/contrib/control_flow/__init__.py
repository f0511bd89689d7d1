from numpyro_tpu_torch.contrib.control_flow.cond import cond
from numpyro_tpu_torch.contrib.control_flow.scan import scan

__all__ = ["cond", "scan"]
