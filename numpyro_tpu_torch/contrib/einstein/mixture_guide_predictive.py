"""Predictive draws from a Stein mixture guide (port of
``numpyro_tpu/contrib/einstein/mixture_guide_predictive.py``): each draw
takes a mixture component at random (``randint``), one guide draw with that
component's params (``torch.func.vmap`` over the draws), then the model
given the guide's draws (``infer.util._predictive``).  The samples carry
the components under ``mixture_assignment_sitename``.

Random state: an int seed (a generator on ``device``, by default
``cuda``; a call raises where that device is not there), a generator on
that device, or a draw source, whose ``randints(low, high, shape)`` gives
the assignments, ``at(s)`` the ``s``-th guide draw's source and
``generator`` the model's draws.  The assignments, the guide's draws and
the model's come from the generator in that order.
"""

from __future__ import annotations

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.einstein.stein_loss import _randint
from numpyro_tpu_torch.contrib.einstein.stein_util import _generator_of, _key_at
from numpyro_tpu_torch.infer.util import _predictive, device_generator

__all__ = ["MixtureGuidePredictive"]


class MixtureGuidePredictive:
    def __init__(self, model, guide, params, guide_sites, num_samples=None, return_sites=None,
                 mixture_assignment_sitename="mixture_assignments", *, device=None):
        self.guide_params = {k: v for k, v in params.items() if k in guide_sites}
        self.params = {k: v for k, v in params.items() if k not in guide_sites}
        self.guide = guide
        self.model = model
        self.return_sites = return_sites
        self.num_samples = num_samples
        self.guide_sites = guide_sites
        self.mixture_assignment_sitename = mixture_assignment_sitename
        self.device = torch.device("cuda" if device is None else device)
        some = next(iter(self.guide_params.values()))
        self.num_mixture_components = some.shape[0]

    def __call__(self, rng_key, *args, **kwargs):
        if not hasattr(rng_key, "normals"):
            rng_key = device_generator(rng_key, self.device, "MixtureGuidePredictive")
        num_samples = self.num_samples or 1
        assigns = _randint(rng_key, self.num_mixture_components, (num_samples,))

        def single_guide_sample(s, assign):
            params_i = {k: v[assign] for k, v in self.guide_params.items()}
            with handlers.block(), handlers.trace() as tr:
                handlers.substitute(
                    handlers.seed(self.guide, _key_at(rng_key, s)),
                    data={**self.params, **params_i},
                )(*args, **kwargs)
            return {name: site["value"] for name, site in tr.items()
                    if site["type"] == "sample" and not site["is_observed"]}

        draws = torch.arange(num_samples, device=assigns.device)
        guide_samples = torch.func.vmap(single_guide_sample, randomness="different")(
            draws, assigns)
        samples = _predictive(
            _generator_of(rng_key),
            self.model,
            guide_samples,
            (num_samples,),
            return_sites=self.return_sites,
            parallel=False,
            model_args=args,
            model_kwargs=kwargs,
        )
        samples[self.mixture_assignment_sitename] = assigns
        return samples
