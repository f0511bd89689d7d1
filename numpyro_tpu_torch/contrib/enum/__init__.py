from numpyro_tpu_torch.contrib.enum.enum_messenger import config_enumerate, enum, markov
from numpyro_tpu_torch.contrib.enum.infer_util import log_density
from numpyro_tpu_torch.contrib.enum.discrete import infer_discrete

__all__ = ["config_enumerate", "enum", "infer_discrete", "log_density", "markov"]
