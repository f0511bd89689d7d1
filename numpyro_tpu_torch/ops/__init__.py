from numpyro_tpu_torch.ops import glm
from numpyro_tpu_torch.ops.indexing import Vindex, vindex

__all__ = ["Vindex", "glm", "vindex"]
