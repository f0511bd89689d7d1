"""Support Decomposition Variational Inference (Reichelt et al.): one guide
per SLP, weighted by its ELBO (port of
``numpyro_tpu/contrib/stochastic_support/sdvi.py``).  Every SLP's ELBO
estimate starts from a generator in the same state, as the JAX package
hands every SLP one key.  ``SDVI(..., device=None)`` fits on the card."""

from __future__ import annotations

import torch

from numpyro_tpu_torch import handlers, infer
from numpyro_tpu_torch.contrib.stochastic_support.dcc import (
    SDVIResult,
    StochasticSupportInference,
    _common_noise,
)
from numpyro_tpu_torch.infer.autoguide import AutoNormal

__all__ = ["SDVI"]

_ELBO_WHITELIST = (
    infer.Trace_ELBO,
    infer.TraceMeanField_ELBO,
    infer.TraceEnum_ELBO,
    infer.TraceGraph_ELBO,
)


class SDVI(StochasticSupportInference):
    """Fits an independent guide to each straight-line program, then weighs
    the SLP posteriors by the softmax of their final ELBOs.  ``device`` is
    where each SLP's ``SVI`` runs (``None``: the card)."""

    def __init__(
        self,
        model,
        optimizer,
        svi_num_steps=1_000,
        combine_elbo_particles=1_000,
        guide_init=AutoNormal,
        loss=None,
        svi_progress_bar=False,
        num_slp_samples=1_000,
        max_slps=124,
        device=None,
    ):
        if loss is None:
            loss = infer.Trace_ELBO()
        elif not isinstance(loss, _ELBO_WHITELIST):
            allowed = ", ".join(cls.__name__ for cls in _ELBO_WHITELIST)
            raise ValueError(f"loss must be an instance of: ({allowed})")
        self.loss = loss
        self.optimizer = optimizer
        self.guide_init = guide_init
        self.svi_num_steps = svi_num_steps
        self.svi_progress_bar = svi_progress_bar
        self.combine_elbo_particles = combine_elbo_particles
        super().__init__(model, num_slp_samples, max_slps, device)

    def _pin_branches(self, branching_trace):
        """The SLP-restricted model: discrete branch choices pinned."""
        return handlers.condition(self.model, branching_trace)

    def _run_inference(self, rng_key, branching_trace, *args, **kwargs):
        pinned = self._pin_branches(branching_trace)
        guide = self.guide_init(pinned)
        fit = infer.SVI(pinned, guide, self.optimizer, self.loss, device=self.device).run(
            rng_key,
            self.svi_num_steps,
            *args,
            progress_bar=self.svi_progress_bar,
            **kwargs,
        )
        return guide, fit.params

    def _combine_inferences(self, rng_key, guides, branching_traces, *args, **kwargs):
        estimator = infer.Trace_ELBO(num_particles=self.combine_elbo_particles)
        names, elbo_vals = list(guides), []
        for bt in names:
            guide, param_map = guides[bt]
            neg_elbo = estimator.loss(
                _common_noise(rng_key),
                param_map,
                self._pin_branches(branching_traces[bt]),
                guide,
                *args,
                **kwargs,
            )
            elbo_vals.append(-neg_elbo)
        stacked = torch.stack(elbo_vals)
        weights = torch.exp(stacked - torch.logsumexp(stacked, 0))
        return SDVIResult(guides, dict(zip(names, weights)))
