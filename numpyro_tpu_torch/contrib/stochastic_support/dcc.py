"""Divide-Conquer-Combine inference for models with stochastic support
(port of ``numpyro_tpu/contrib/stochastic_support/dcc.py``; Zhou et al.
2020).

A model's control flow may branch on discrete sites marked
``infer={"branching": True}``; each realized branch combination is a
straight-line program (SLP).  The inference discovers SLPs by prior
simulation, runs per-SLP inference, and reweights the sub-posteriors by
estimated normalization constants.

- **Branch values.** Each forward simulation reads its branching values on
  the host (``int(value)``, one sync a site on the card), as the JAX
  package does.  An SLP conditions the model on Python ints, which
  ``condition`` and ``sample`` hand back as they are, so the model's ``if m
  == 0`` reads no tensor when the SLP is evaluated.
- **Common noise.** The JAX package seeds every posterior draw's proposal,
  and every SLP's estimate, with one key.  The port keeps that: each SLP's
  estimate starts from a generator in the same state, and one standard
  normal per latent site serves all draws.  The ratios are computed batched
  over the draws: the proposal of draw ``i`` is ``AutoNormal`` centred on
  the draw (``init_to_value``) with scale ``proposal_scale``, whose draw is
  ``biject_to(support)(anchor + scale * eps)`` and whose log density is the
  Normal's at ``anchor + scale * eps`` less the transform's log-Jacobian;
  the model's log joint is one ``vmap`` of ``log_density`` over the draws.
- **Draws.** Forward simulations draw from the run's generator through the
  model's sites; an estimate takes ``normals(site_shape)`` for each latent
  site in the model's order from a draw source (``infer.hmc_core``).
- **Device.** ``DCC`` runs on ``mcmc_kwargs["device"]`` (the card when it
  is absent, as ``MCMC``) and raises where there is no CUDA device.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from collections import namedtuple

import torch

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions.transforms import biject_to
from numpyro_tpu_torch.handlers import condition, seed, substitute, trace
from numpyro_tpu_torch.infer import MCMC, NUTS
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer.util import device_generator, log_density

__all__ = ["DCC", "DCCResult", "SDVIResult", "StochasticSupportInference"]

DCCResult = namedtuple("DCCResult", ["samples", "slp_weights"])
SDVIResult = namedtuple("SDVIResult", ["guides", "slp_weights"])


def _branch_signature(tr):
    """Map a trace to its branch decision record {site: int value}."""
    decisions = {}
    for site in tr.values():
        if site["type"] != "sample" or not (site.get("infer") or {}).get("branching"):
            continue
        fn = site["fn"]
        if not (
            isinstance(fn, dist.Distribution)
            and fn.support is not None
            and fn.support.is_discrete
        ):
            raise RuntimeError("Branching is only supported for discrete sampling sites.")
        decisions[site["name"]] = int(site["value"])
    return decisions


def _normalize_log_weights(log_zs):
    """{slp: log Z} -> {slp: weight}, softmax over discovered SLPs."""
    total = torch.logsumexp(torch.stack(list(log_zs.values())), 0)
    return {k: torch.exp(v - total) for k, v in log_zs.items()}


def _common_noise(rng_key):
    """A generator in ``rng_key``'s state (so every caller draws the same
    numbers), or a draw source as it is."""
    if not isinstance(rng_key, torch.Generator):
        return rng_key
    generator = torch.Generator(device=rng_key.device)
    generator.set_state(rng_key.get_state())
    return generator


class StochasticSupportInference(ABC):
    """The shared procedure: discover SLPs by forward simulation, run per-SLP
    inference, combine with normalization weights.  ``device`` is where the
    simulations and the per-SLP runs take place (``None``: the card)."""

    def __init__(self, model, num_slp_samples, max_slps, device=None):
        self.model = model
        self.num_slp_samples = num_slp_samples
        self.max_slps = max_slps
        self.device = torch.device("cuda" if device is None else device)

    def _find_slps(self, rng_key, *args, **kwargs):
        """Forward-simulate the prior on the generator ``rng_key`` until
        ``max_slps`` distinct branch signatures are seen (or the simulation
        budget runs out); the signatures in first-seen order."""
        found = {}
        for _ in range(self.num_slp_samples):
            tr = trace(seed(self.model, rng_key)).get_trace(*args, **kwargs)
            decisions = _branch_signature(tr)
            tag = ",".join(str(v) for v in decisions.values())
            found.setdefault(tag, decisions)
            if len(found) >= self.max_slps:
                break
        return found

    @abstractmethod
    def _run_inference(self, rng_key, branching_trace, *args, **kwargs):
        raise NotImplementedError

    @abstractmethod
    def _combine_inferences(self, rng_key, inferences, branching_traces, *args, **kwargs):
        raise NotImplementedError

    def run(self, rng_key, *args, **kwargs):
        """``rng_key`` is an int seed, from which the run makes a generator
        on its device, or a ``torch.Generator`` on that device: it seeds the
        simulations, the combination and each SLP's run (an int seed each)."""
        generator = device_generator(rng_key, self.device, type(self).__name__)
        seeds = torch.randint(0, 2**62, (2 + self.max_slps,), generator=generator,
                              device=self.device).tolist()
        key_find, key_combine, *keys_infer = seeds
        slps = self._find_slps(torch.Generator(device=self.device).manual_seed(key_find),
                               *args, **kwargs)
        inferences = {
            tag: self._run_inference(key, decisions, *args, **kwargs)
            for key, (tag, decisions) in zip(keys_infer, slps.items())
        }
        return self._combine_inferences(
            torch.Generator(device=self.device).manual_seed(key_combine), inferences, slps,
            *args, **kwargs)


class DCC(StochasticSupportInference):
    """MCMC within each SLP; normalization constants estimated by importance
    sampling from posterior-centred ``AutoNormal`` proposals.
    ``mcmc_kwargs`` go to the port's ``MCMC``, its ``device`` included."""

    def __init__(
        self,
        model,
        mcmc_kwargs,
        kernel_cls=NUTS,
        num_slp_samples=1_000,
        max_slps=124,
        proposal_scale=1.0,
    ):
        self.kernel_cls = kernel_cls
        self.mcmc_kwargs = mcmc_kwargs
        self.proposal_scale = proposal_scale
        super().__init__(model, num_slp_samples, max_slps, mcmc_kwargs.get("device"))

    def _run_inference(self, rng_key, branching_trace, *args, **kwargs):
        slp_model = condition(self.model, data=branching_trace)
        mcmc = MCMC(self.kernel_cls(slp_model), **self.mcmc_kwargs)
        mcmc.run(rng_key, *args, **kwargs)
        return mcmc.get_samples()

    def _estimate_log_z(self, rng_key, slp_model, slp_samples, args, kwargs):
        """Layered adaptive importance sampling: one ``AutoNormal`` proposal
        per posterior draw, log Z = logmeanexp of the importance ratios, all
        draws' proposals on the same standard normals (this module's
        docstring)."""
        draws = core.as_draws(rng_key)
        n = next(iter(slp_samples.values())).shape[0]
        first = {k: v[0] for k, v in slp_samples.items()}
        proto = trace(substitute(slp_model, data=first)).get_trace(*args, **kwargs)
        values, log_q = {}, 0.0
        for name, site in proto.items():
            if site["type"] != "sample" or site["is_observed"] or site["fn"].support.is_discrete:
                continue
            t = biject_to(site["fn"].support)
            anchor = t.inv(slp_samples[name])
            eps = draws.normals(tuple(site["value"].shape), anchor)
            z = anchor + self.proposal_scale * eps
            values[name] = t(z)
            ladj = t.log_abs_det_jacobian(z, values[name])
            log_q = (log_q + dist.Normal(anchor, self.proposal_scale).log_prob(z).reshape(n, -1)
                     .sum(-1) - (ladj.reshape(n, -1).sum(-1) if ladj.dim() else ladj))
        log_p = torch.func.vmap(lambda v: log_density(slp_model, args, kwargs, v)[0])(values)
        ratios = log_p - log_q
        return torch.logsumexp(ratios, 0) - math.log(n)

    def _combine_inferences(self, rng_key, samples, branching_traces, *args, **kwargs):
        log_zs = {
            tag: self._estimate_log_z(
                _common_noise(rng_key),
                condition(self.model, data=branching_traces[tag]),
                slp_samples,
                args,
                kwargs,
            )
            for tag, slp_samples in samples.items()
        }
        return DCCResult(samples, _normalize_log_weights(log_zs))
