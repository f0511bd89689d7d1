"""numpyro_tpu_torch.parallel: chains and data across processes, one per
device (port of ``numpyro_tpu/parallel``; see ``mesh.py``)."""

from numpyro_tpu_torch.parallel.mesh import (
    chain_data_mesh,
    chain_mesh,
    cross_chain_diagnostics,
    initialize_distributed,
    pooled_step_size,
    shard_chain_state,
    shard_data,
)

__all__ = [
    "chain_data_mesh",
    "chain_mesh",
    "cross_chain_diagnostics",
    "initialize_distributed",
    "pooled_step_size",
    "shard_chain_state",
    "shard_data",
]
