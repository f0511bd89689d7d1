"""Cross-chain reductions over a ``(C, N, ...)`` panel of draws or a
``(C,)`` panel of step sizes, on the device the panel lives on (port of
``cross_chain_diagnostics`` and ``pooled_step_size`` from
``numpyro_tpu/parallel/mesh.py``).  The JAX package shards the chain axis
over a device mesh and lets XLA insert the collectives; on one card the
same reductions run on the whole panel."""

from __future__ import annotations

import torch

from numpyro_tpu_torch.diagnostics import effective_sample_size, split_gelman_rubin
from numpyro_tpu_torch.util import tree_map

__all__ = ["cross_chain_diagnostics", "pooled_step_size"]


def cross_chain_diagnostics(samples_by_chain):
    """Split R-hat and effective sample size of every ``(C, N, ...)`` leaf of
    ``samples_by_chain``, as a ``(r_hat, ess)`` pair per leaf, computed where
    the draws are."""
    return tree_map(lambda x: (split_gelman_rubin(x), effective_sample_size(x)), samples_by_chain)


def pooled_step_size(adapt_state, mesh=None):
    """The chains' step sizes pooled by their harmonic mean: ``adapt_state``
    is an adaptation state with a ``(C,)`` ``step_size`` or that tensor
    itself.  ``mesh`` is accepted for the JAX signature and not used."""
    ss = getattr(adapt_state, "step_size", adapt_state)
    return 1.0 / torch.mean(1.0 / torch.as_tensor(ss))
