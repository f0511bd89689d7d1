"""Sequential Monte Carlo with adaptive tempering and random-walk MH
rejuvenation (port of ``numpyro_tpu/infer/smc.py``; Del Moral, Doucet &
Jasra 2006, Chopin & Papaspiliopoulos 2020).

- Particles anneal from the prior to the posterior along a temperature ladder
  chosen by bisection on the effective sample size of the incremental weights
  (Jasra et al. 2011).
- Systematic resampling, by one sorted-uniform search, when the ESS falls
  below the threshold.
- Rejuvenation: a few random-walk MH steps at the current temperature, with
  the proposal scaled by the particle spread.

The particle cloud is one ``(P, D)`` panel in unconstrained space, and the
prior and likelihood of all particles are one batched evaluation
(``torch.func.vmap``).  The bisection reads each candidate's ESS on the host,
as the JAX package does: 31 syncs a stage.

A model with an unobserved discrete site raises ``NotImplementedError``: the
JAX package redraws such a site with one fixed key, the same value for every
particle, and sums nothing out, so its posterior is wrong there (ROADMAP.md,
Queue 3).  ``factor`` sites are observed sample sites and count in the
likelihood; deterministic sites are not returned.

Draws come from a draw source (``hmc_core.GeneratorDraws``) in this order:
``prior`` (the initial cloud: the model's own draws under ``vmap``), then per
stage ``uniforms(())`` (the resampling offset) and per MH step
``normals((P, D))`` and ``uniforms((P,))``.
"""

from __future__ import annotations

from collections import namedtuple

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions.transforms import biject_to
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.initialization import init_to_sample
from numpyro_tpu_torch.infer.util import _site_log_prob, log_density

__all__ = ["SMC", "SMCResult", "SMCState", "smc_state_from_numpy"]

SMCState = namedtuple("SMCState", ["particles", "log_weights", "beta", "log_evidence", "step",
                                   "rng_key"])
SMCResult = namedtuple("SMCResult", ["samples", "log_evidence", "betas", "state"])


def _systematic_resample(draws, log_weights):
    """Systematic resampling indices: one sorted-uniform search of the
    cumulative weights."""
    n = log_weights.shape[0]
    weights = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    cum = torch.cumsum(weights, 0)
    u = (draws.uniforms((), log_weights)
         + torch.arange(n, dtype=log_weights.dtype, device=log_weights.device)) / n
    return torch.searchsorted(cum, u, right=False).clamp(0, n - 1)


def _ess(log_weights):
    return torch.exp(2 * torch.logsumexp(log_weights, 0) - torch.logsumexp(2 * log_weights, 0))


class SMC:
    """Adaptive-tempering SMC sampler over a model.

    :param model: model callable with sample/plate primitives.
    :param num_particles: size of the particle cloud.
    :param ess_threshold: resample when ESS/P falls below this.
    :param target_incremental_ess: fraction of P the bisection targets when
        choosing the next temperature.
    :param num_mcmc_steps: rejuvenation (random-walk MH) steps per stage.
    :param max_stages: hard cap on tempering stages.
    :param device: where the particles live; ``None`` is
        ``torch.device("cuda")``, and :meth:`run` raises when it is not there
        (it never carries on on the CPU).
    """

    def __init__(self, model, *, num_particles=1024, ess_threshold=0.5,
                 target_incremental_ess=0.5, num_mcmc_steps=5, max_stages=100, device=None):
        self.model = model
        self.num_particles = num_particles
        self.ess_threshold = ess_threshold
        self.target_incremental_ess = target_incremental_ess
        self.num_mcmc_steps = num_mcmc_steps
        self.max_stages = max_stages
        self.device = torch.device("cuda" if device is None else device)
        self._layout = None
        self._transforms = None
        self._split_log_probs = None

    def _setup(self, generator, args, kwargs):
        """Trace the model once: its continuous latent sites, their
        transforms, and the split of the log density into prior (with the
        transforms' log-Jacobians) and likelihood."""
        seeded = handlers.seed(self.model, generator)
        trace = handlers.trace(
            handlers.substitute(seeded, substitute_fn=init_to_sample())
        ).get_trace(*args, **kwargs)
        latent = {}
        for name, site in trace.items():
            if site["type"] != "sample" or site["is_observed"]:
                continue
            if site["fn"].support.is_discrete:
                raise NotImplementedError(
                    f"SMC in numpyro_tpu_torch does not take the discrete latent site {name!r}: "
                    "the JAX package redraws it with one fixed key for every particle and sums "
                    "nothing out (see ROADMAP.md, Queue 3)"
                )
            latent[name] = site
        transforms = {name: biject_to(site["fn"].support) for name, site in latent.items()}
        self._transforms = transforms
        self._layout = layout = core.FlatLayout(
            {name: transforms[name].inv(site["value"]) for name, site in latent.items()}
        )
        model = self.model

        def split_log_probs(z_flat):
            z = layout.unravel_one(z_flat)
            z_constrained = {}
            log_det_total = z_flat.new_zeros(())
            for name, value in z.items():
                t = transforms[name]
                constrained = t(value)
                log_det_total = log_det_total + t.log_abs_det_jacobian(value, constrained).sum()
                z_constrained[name] = constrained
            _, tr = log_density(model, args, kwargs, z_constrained)
            log_prior, log_lik = log_det_total, z_flat.new_zeros(())
            for site in tr.values():
                if site["type"] != "sample":
                    continue
                lp = _site_log_prob(site).sum()
                if site["is_observed"]:
                    log_lik = log_lik + lp
                else:
                    log_prior = log_prior + lp
            return log_prior, log_lik

        self._split_log_probs = infer_util.batched_value(split_log_probs)

    def _init_particles(self, draws, args, kwargs):
        """The initial cloud: prior draws, mapped into unconstrained space."""

        def draw(generator):
            with handlers.block(), handlers.trace() as tr:
                handlers.substitute(
                    handlers.seed(self.model, generator), substitute_fn=init_to_sample()
                )(*args, **kwargs)
            return {name: tr[name]["value"] for name in self._transforms}

        values = draws.prior(draw, self.num_particles)
        return self._layout.ravel_batch(
            {name: self._transforms[name].inv(v) for name, v in values.items()}
        )

    def run(self, rng_key, *args, **kwargs):
        """The whole tempering loop; returns an :class:`SMCResult` with the
        constrained posterior samples and the log-evidence estimate.
        ``rng_key`` is an int seed, from which the run makes a generator on
        its device, or a ``torch.Generator`` on that device."""
        generator = infer_util.device_generator(rng_key, self.device, "SMC")
        draws = core.as_draws(generator)
        self._setup(generator, args, kwargs)
        particles = self._init_particles(draws, args, kwargs)
        _, log_lik = self._split_log_probs(particles)
        beta = 0.0
        log_evidence = particles.new_zeros(())
        betas = [0.0]
        log_weights = particles.new_zeros((self.num_particles,))
        for _ in range(self.max_stages):
            particles, log_weights, log_lik, log_evidence, beta = self._stage(
                draws, particles, log_weights, log_lik, beta, log_evidence
            )
            betas.append(float(beta))
            if beta >= 1.0:
                break
        samples = {
            name: self._transforms[name](value)
            for name, value in self._layout.unravel_batch(particles).items()
        }
        state = SMCState(particles, log_weights, beta, log_evidence, len(betas), generator)
        return SMCResult(samples, float(log_evidence), betas, state)

    def _stage(self, draws, particles, log_weights, log_lik, beta, log_evidence):
        """One tempering stage: the next temperature, the reweighting and the
        evidence increment, a resampling where the ESS is depleted, and the
        rejuvenation at the new temperature."""
        beta_new = self._next_beta(beta, log_lik)
        incr = (beta_new - beta) * log_lik
        log_evidence = log_evidence + (
            torch.logsumexp(log_weights + incr, 0) - torch.logsumexp(log_weights, 0)
        )
        log_weights = log_weights + incr
        do_resample = _ess(log_weights) < self.ess_threshold * self.num_particles
        idx = _systematic_resample(draws, log_weights)
        particles = torch.where(do_resample, particles[idx], particles)
        log_weights = torch.where(do_resample, torch.zeros_like(log_weights), log_weights)
        particles, log_lik = self._rejuvenate(draws, particles, beta_new)
        return particles, log_weights, log_lik, log_evidence, beta_new

    def _next_beta(self, beta, log_lik):
        """Bisection: the largest beta' <= 1 whose incremental weights keep
        the ESS at the target fraction."""
        target = self.target_incremental_ess * self.num_particles

        def ess_at(b):
            return float(_ess((b - beta) * log_lik))

        if ess_at(1.0) >= target:
            return 1.0
        lo, hi = beta, 1.0
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            if ess_at(mid) >= target:
                lo = mid
            else:
                hi = mid
        return lo if lo > beta else beta + 1e-4

    def _rejuvenate(self, draws, particles, beta):
        """Batched random-walk MH steps targeting prior(z) lik(z)^beta, the
        proposal scaled by the particle spread (std with ddof 0, as
        ``jnp.std``)."""
        log_prior, log_lik = self._split_log_probs(particles)
        log_target = log_prior + beta * log_lik
        scale = 0.5 * particles.std(0, correction=0) + 1e-6
        for _ in range(self.num_mcmc_steps):
            prop = particles + scale * draws.normals(tuple(particles.shape), particles)
            lp_prior, lp_lik = self._split_log_probs(prop)
            lp_new = lp_prior + beta * lp_lik
            u = draws.uniforms((self.num_particles,), particles)
            accept = u < torch.exp(lp_new - log_target)
            particles = torch.where(accept[:, None], prop, particles)
            log_target = torch.where(accept, lp_new, log_target)
            log_lik = torch.where(accept, lp_lik, log_lik)
        return particles, log_lik


def smc_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``SMCState`` from a JAX ``SMCState`` whose leaves are numpy
    arrays (or Python numbers); JAX's key is dropped for ``rng_key``."""

    def get(name):
        return infer_util.state_field(fields, name)

    def to(name):
        return infer_util.tree_from_numpy(get(name), device)

    return SMCState(to("particles"), to("log_weights"), float(get("beta")), to("log_evidence"),
                    int(get("step")), rng_key)
