"""Utilities for the ensemble kernels (port of
``numpyro_tpu/infer/ensemble_util.py``)."""

from numpyro_tpu_torch.infer.hmc_core import FlatLayout
from numpyro_tpu_torch.util import tree_map

__all__ = ["batch_ravel_pytree"]


def batch_ravel_pytree(pytree):
    """A batch-leading dict of tensors (or one tensor) -> the ``(batch,
    flat_dim)`` panel and the function that unravels such a panel."""
    layout = FlatLayout(tree_map(lambda x: x[0], pytree))
    return layout.ravel_batch(pytree), layout.unravel_batch
