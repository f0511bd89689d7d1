"""The Stein mixture loss (port of
``numpyro_tpu/contrib/einstein/stein_loss.py``).

The attractive force of SteinVI pulls each particle towards a high mixture
ELBO: for particle ``i``, ``ELBO_i = E_{z ~ q_i}[log p(x, z) - log (1/m
sum_j q_j(z))]``, the guide being the uniform mixture of the particles'
guides.  One draw: ``z ~ q_i`` from the seeded guide, every particle's
guide log density at ``z`` (``torch.func.vmap`` over all ``m`` particles),
``logsumexp - log m``, then the model replayed on the guide's trace.  The
ELBO draws are mapped with ``vmap(..., randomness="different")``.

Random state: a ``torch.Generator`` (each mapped draw gets its own
numbers), or a draw source, whose ``at(e)`` serves the ``e``-th ELBO draw
(the guide's reparameterised draws through ``normals``) and whose
``randints(low, high, shape)`` serves :meth:`SteinLoss.loss`'s particle
picks.  The guide and the model of one draw share its state, where the
JAX package splits the draw's key in two.
"""

from __future__ import annotations

import math

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.einstein.stein_util import _key_at, batch_ravel_pytree
from numpyro_tpu_torch.infer.util import log_density

__all__ = ["SteinLoss"]


def _joint_ld(program, seeded_args, overrides):
    """The log density of ``program`` with ``overrides`` substituted in."""
    args, kwargs, base_params = seeded_args
    return log_density(program, args, kwargs, {**base_params, **overrides})


def _randint(rng_key, high, shape):
    """Integers in ``[0, high)`` from a generator or a draw source."""
    if isinstance(rng_key, torch.Generator):
        return torch.randint(high, shape, generator=rng_key, device=rng_key.device)
    return rng_key.randints(0, high, shape)


class SteinLoss:
    """Monte Carlo mixture-ELBO estimator over the Stein particle cloud."""

    def __init__(self, elbo_num_particles=1, stein_num_particles=1):
        self.elbo_num_particles = elbo_num_particles
        self.stein_num_particles = stein_num_particles

    def particle_loss(self, rng_key, model, guide, selected_particle, unravel_pytree,
                      flat_particles, select_index, model_args, model_kwargs, param_map):
        """The mixture ELBO of one particle (``selected_particle``, its
        params), averaged over ``elbo_num_particles`` draws;
        ``unravel_pytree`` maps a row of ``flat_particles`` to params."""
        ctx = (model_args, model_kwargs, param_map)
        log_m = math.log(self.stein_num_particles)

        def one_draw(draw_key):
            # z ~ q_i, recorded in the guide's trace
            _, guide_tr = _joint_ld(handlers.seed(guide, draw_key), ctx, selected_particle)
            replayed = handlers.replay(guide, guide_tr)
            # the mixture density: every particle's q_j(z)
            comp_lds = torch.func.vmap(
                lambda flat_j: _joint_ld(replayed, ctx, unravel_pytree(flat_j))[0]
            )(flat_particles)
            mixture_ld = torch.logsumexp(comp_lds, 0) - log_m
            joint_ld, _ = _joint_ld(
                handlers.replay(handlers.seed(model, draw_key), guide_tr), ctx,
                selected_particle,
            )
            return joint_ld - mixture_ld

        draws = torch.arange(self.elbo_num_particles, device=flat_particles.device)
        elbos = torch.func.vmap(lambda e: one_draw(_key_at(rng_key, e)),
                                randomness="different")(draws)
        return elbos.mean()

    def loss(self, rng_key, param_map, model, guide, particles, *args, **kwargs):
        """Minus the mixture ELBO averaged over ``elbo_num_particles``
        particles picked at random (``randint``), each scored with
        ``elbo_num_particles`` draws."""
        if not particles:
            raise ValueError("Stein mixture needs at least one particle.")
        flat, unravel_one, _ = batch_ravel_pytree(particles, nbatch_dims=1)
        n_draws = self.elbo_num_particles
        picks = _randint(rng_key, self.stein_num_particles, (n_draws,))

        def scored(e, pick):
            return self.particle_loss(
                _key_at(rng_key, e), model, guide, unravel_one(flat[pick]), unravel_one, flat,
                pick, args, kwargs, param_map,
            )

        draws = torch.arange(n_draws, device=flat.device)
        elbos = torch.func.vmap(scored, randomness="different")(draws, picks)
        return -elbos.mean()
