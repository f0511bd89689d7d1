from numpyro_tpu_torch.ops import glm

__all__ = ["glm"]
