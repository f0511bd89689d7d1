"""numpyro_tpu_torch.parallel: cross-chain helpers on one device (port of the
one-device part of ``numpyro_tpu/parallel``; the mesh, sharding and
multi-host helpers are not ported, the port runs on one card)."""

from numpyro_tpu_torch.parallel.mesh import cross_chain_diagnostics, pooled_step_size

__all__ = ["cross_chain_diagnostics", "pooled_step_size"]
