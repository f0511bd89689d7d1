"""SteinVI, SVGD and ASVGD: particle variational inference (port of
``numpyro_tpu/contrib/einstein/steinvi.py``).

The ensemble of guide-parameter particles is one ``(P, D)`` tensor in the
JAX package's flat layout (``stein_util``).  A step computes every
particle's objective and its gradient in one ``torch.func.vmap`` of
``grad_and_value`` (the JAX package makes two passes, one for each), then
the Stein force of every particle at once: the kernel and its gradient in
the first argument over both particle axes, ``(P, P)`` pairs in one
``vmap`` of a ``vmap``, no Python loop over particles.

- ``SteinVI``: Stein mixture inference; the particles parameterise a
  mixture of guides and the attractive force is each particle's mixture
  ELBO (Ronning et al. 2023).
- ``SVGD``: an ``AutoDelta`` guide's particles moved by the model's log
  joint (Liu & Wang 2016).  Its objective draws nothing, so a run is
  deterministic once the initial particles are fixed.
- ``ASVGD``: SVGD with the attractive force tempered by a cyclical
  schedule (D'Angelo & Fortuin 2021), computed in float32 as the JAX
  package computes it; the temperature is an argument of the step, where
  the JAX package swaps an attribute.

``SteinVI(..., device=None)`` runs on ``cuda``: ``init`` and ``run`` raise
where that device is not there and never carry on on the CPU; tests pass
``device="cpu"``.  Random state is one ``torch.Generator`` on that device
(from an int seed, or the caller's), the ``rng_key`` of ``SteinVIState``;
it advances with every draw.  In its place a caller may give a draw
source: an object with ``generator`` (for the traces of ``init``),
``normals(shape, like)`` (the initial jitter: one ``(P,) + shape`` draw
per leaf of each param, model params first, then the guide's, in trace
order) and ``at(i)`` (the draw source of particle ``i``'s objective in a
step, ``stein_loss``), so a test can hand in the JAX package's draws.

The objective that the kernel gets (``RadialGaussNewtonKernel`` takes its
Jacobian) is particle 0's: on a draw source, on particle 0's draws, as in
the JAX package; on a generator, on draws of its own, the same for every
particle and tangent (``randomness="same"``), as the JAX package gives them
all one key.

``run`` is a Python loop over ``update`` (the JAX package's ``lax.scan``);
the losses stay on the device and are stacked once at the end.
"""

from __future__ import annotations

from collections import namedtuple
from itertools import chain

import numpy as np
import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.einstein.stein_kernels import RBFKernel
from numpyro_tpu_torch.contrib.einstein.stein_loss import SteinLoss
from numpyro_tpu_torch.contrib.einstein.stein_util import (
    _generator_of,
    _key_at,
    _leaves,
    _rebuild,
    batch_ravel_pytree,
    get_parameter_transform,
)
from numpyro_tpu_torch.distributions.util import standard_draw
from numpyro_tpu_torch.infer.autoguide import AutoDelta
from numpyro_tpu_torch.infer.util import device_generator, log_density, pin_full_f32_matmul

__all__ = ["ASVGD", "SVGD", "SteinVI", "SteinVIRunResult", "SteinVIState"]

SteinVIState = namedtuple("SteinVIState", ["optim_state", "rng_key"])
SteinVIRunResult = namedtuple("SteinRunResult", ["params", "state", "losses"])


def _stein_forces(kernel, mode, flat, grads, loss_temperature, repulsion_temperature):
    """Every particle's Stein force: ``(loss_temperature * sum_j k(x_j, x_i)
    g_j + repulsion_temperature * sum_j d/dx_j sum k(x_j, x_i)) / P``."""

    def pair(xj, xi):
        k = kernel(xj, xi)
        return k.sum(), k

    # (P_i, P_j, D) gradients in x_j and (P_i, P_j, ...) kernel values
    over_j = torch.func.vmap(torch.func.grad(pair, has_aux=True), in_dims=(0, None))
    repulse, kvals = torch.func.vmap(over_j, in_dims=(None, 0))(flat, flat)
    if mode == "matrix":
        attract = torch.einsum("ijab,jb->ia", kvals, grads)
    elif mode == "norm":
        attract = kvals @ grads
    else:
        attract = (kvals * grads).sum(1)
    return (loss_temperature * attract
            + repulsion_temperature * repulse.sum(1)) / flat.shape[0]


class SteinVI:
    """Stein mixture inference.

    :param model: the model.
    :param guide: an autoguide whose params become the transported particles.
    :param optim: an optimizer of :mod:`numpyro_tpu_torch.optim`.
    :param kernel_fn: a Stein kernel (by default ``RBFKernel()``).
    :param num_stein_particles: the size of the ensemble.
    :param num_elbo_particles: Monte Carlo draws of each particle's ELBO.
    :param loss_temperature: the scale of the attractive force.
    :param repulsion_temperature: the scale of the repulsive force.
    :param device: where the run's generator lives, and so the particles and
        every draw.  ``None`` is ``torch.device("cuda")``.
    :param static_kwargs: keyword arguments that every call of the model and
        the guide gets.
    """

    def __init__(self, model, guide, optim, kernel_fn=None, num_stein_particles=10,
                 num_elbo_particles=10, loss_temperature=1.0, repulsion_temperature=1.0, *,
                 device=None, **static_kwargs):
        self.model = model
        self.guide = guide
        self.optim = optim
        self.kernel_fn = kernel_fn if kernel_fn is not None else RBFKernel()
        self.num_stein_particles = num_stein_particles
        self.num_elbo_particles = num_elbo_particles
        self.loss_temperature = loss_temperature
        self.repulsion_temperature = repulsion_temperature
        self.device = torch.device("cuda" if device is None else device)
        self.static_kwargs = static_kwargs
        self.stein_loss = SteinLoss(elbo_num_particles=num_elbo_particles,
                                    stein_num_particles=num_stein_particles)
        self.particle_transforms = {}
        self._particle_param_names = set()

    # -- setup ---------------------------------------------------------

    def _random_state(self, rng_key):
        """The run's generator (from an int seed or the caller's, on the
        run's device), or the caller's draw source as it is."""
        if hasattr(rng_key, "normals"):
            return rng_key
        return device_generator(rng_key, self.device, type(self).__name__)

    def _init_params(self, rng_key, *args, **kwargs):
        """Every param site of the guide and the model, in unconstrained
        space, replicated onto the particle axis and jittered by 0.1 times
        a standard normal draw per particle and element."""
        generator = _generator_of(rng_key)
        call_kwargs = {**kwargs, **self.static_kwargs}
        guide_trace = handlers.trace(handlers.seed(self.guide, generator)).get_trace(
            *args, **call_kwargs)
        model_trace = handlers.trace(handlers.substitute(
            handlers.seed(self.model, generator),
            data={k: site["value"] for k, site in guide_trace.items() if site["type"] == "sample"},
        )).get_trace(*args, **call_kwargs)

        params, transforms = {}, {}
        sites = [s for s in chain(model_trace.values(), guide_trace.values())
                 if s["type"] == "param"]
        num = self.num_stein_particles
        for site in sites:
            name = site["name"]
            if name in params:
                continue
            transform = get_parameter_transform(site)
            transforms[name] = transform
            unconstrained = transform.inv(site["value"])
            # params may be trees (a network's layers): jitter leaf-wise
            jittered = [
                (leaf[None] + 0.1 * standard_draw(rng_key, "normal", (num,) + tuple(leaf.shape),
                                                  leaf)).detach()
                for leaf in _leaves(unconstrained)
            ]
            params[name] = _rebuild(unconstrained, iter(jittered))
            self._particle_param_names.add(name)
        self.particle_transforms = transforms
        return params

    @staticmethod
    def _calc_particle_info(particle_params):
        info, start = {}, 0
        for name in sorted(particle_params):
            size = sum(leaf.numel() // leaf.shape[0] for leaf in _leaves(particle_params[name]))
            info[name] = (start, start + size)
            start += size
        return info

    def _particles(self, unconstr_params):
        particles = {k: v for k, v in unconstr_params.items()
                     if k in self._particle_param_names}
        flat, unravel_one, unravel_batch = batch_ravel_pytree(particles, nbatch_dims=1)
        return flat, unravel_one, unravel_batch, self._calc_particle_info(particles)

    def _constrain(self, params):
        return {k: self.particle_transforms[k](v) for k, v in params.items()}

    # -- the Stein update ------------------------------------------------

    def _loss_and_grads(self, rng_key, unconstr_params, *args, **kwargs):
        flat, unravel_one, unravel_batch, particle_info = self._particles(unconstr_params)
        model_kwargs = {**kwargs, **self.static_kwargs}

        def particle_ld(p_flat, idx, key):
            # the attractive objective of one particle: its mixture ELBO
            return self.stein_loss.particle_loss(
                key, self.model, self.guide, self._constrain(unravel_one(p_flat)),
                lambda pj: self._constrain(unravel_one(pj)), flat, idx, args, model_kwargs, {},
            )

        idxs = torch.arange(self.num_stein_particles, device=flat.device)
        grads, lds = torch.func.vmap(
            torch.func.grad_and_value(lambda p, i: particle_ld(p, i, _key_at(rng_key, i))),
            randomness="different",
        )(flat, idxs)
        loss = -lds.mean()
        kernel = self.kernel_fn.compute(
            rng_key, flat, particle_info, lambda p: particle_ld(p, 0, _key_at(rng_key, 0)))
        forces = _stein_forces(kernel, self.kernel_fn.mode, flat, grads, self.loss_temperature,
                               self.repulsion_temperature)
        # optimizers minimize
        return loss, unravel_batch(-forces)

    # -- public API ----------------------------------------------------

    def init(self, rng_key, *args, **kwargs):
        """The initial state: jittered particles of every param, the
        optimizer's state over them and the run's random state
        (``rng_key``: an int seed, a generator on the run's device or a
        draw source)."""
        rng_key = self._random_state(rng_key)
        pin_full_f32_matmul()
        params = self._init_params(rng_key, *args, **kwargs)
        return SteinVIState(self.optim.init(params), rng_key)

    def get_params(self, state):
        """The particles in constrained space."""
        unconstr = self.optim.get_params(state.optim_state)
        return {k: self.particle_transforms[k](v) if k in self.particle_transforms else v
                for k, v in unconstr.items()}

    def update(self, state, *args, **kwargs):
        """One step; returns ``(new_state, loss)``, the loss on the device."""
        pin_full_f32_matmul()
        params = self.optim.get_params(state.optim_state)
        loss, grads = self._loss_and_grads(state.rng_key, params, *args, **kwargs)
        return SteinVIState(self.optim.update(grads, state.optim_state), state.rng_key), loss

    def run(self, rng_key, num_steps, *args, progress_bar=False, **kwargs):
        """``init`` and ``num_steps`` updates; returns ``SteinRunResult(params,
        state, losses)`` with the ``(num_steps,)`` losses on the device.
        ``progress_bar`` is accepted and not used, as in the JAX package."""
        state = self.init(rng_key, *args, **kwargs)
        losses = []
        for _ in range(num_steps):
            state, loss = self.update(state, *args, **kwargs)
            losses.append(loss)
        return SteinVIRunResult(self.get_params(state), state, self._stack(losses))

    def _stack(self, losses):
        return torch.stack(losses) if losses else torch.zeros(0, device=self.device)


class SVGD(SteinVI):
    """Stein variational gradient descent: ``AutoDelta`` particles moved by
    the Stein force of the model's log joint (Liu & Wang 2016)."""

    def __init__(self, model, optim, kernel_fn=None, num_stein_particles=10, guide_kwargs={},
                 *, device=None, **static_kwargs):
        super().__init__(
            model, AutoDelta(model, **guide_kwargs), optim, kernel_fn=kernel_fn,
            num_stein_particles=num_stein_particles, num_elbo_particles=1, device=device,
            **static_kwargs,
        )

    def _loss_and_grads(self, rng_key, unconstr_params, *args, **kwargs):
        return self._svgd_loss_and_grads(rng_key, unconstr_params, self.loss_temperature, args,
                                         kwargs)

    def _svgd_loss_and_grads(self, rng_key, unconstr_params, loss_temperature, args, kwargs):
        flat, unravel_one, unravel_batch, particle_info = self._particles(unconstr_params)
        model_kwargs = {**kwargs, **self.static_kwargs}

        def log_joint(p_flat, key):
            constrained = self._constrain(unravel_one(p_flat))
            guided = handlers.substitute(handlers.seed(self.guide, key), data=constrained)
            # the guide maps the particle's locations onto the latent values
            with handlers.block(), handlers.trace() as gtr:
                guided(*args, **model_kwargs)
            latents = {k: site["value"] for k, site in gtr.items() if site["type"] == "sample"}
            ld, _ = log_density(handlers.seed(self.model, key), args, model_kwargs, latents)
            return ld

        idxs = torch.arange(self.num_stein_particles, device=flat.device)
        grads, lds = torch.func.vmap(
            torch.func.grad_and_value(lambda p, i: log_joint(p, _key_at(rng_key, i))),
            randomness="different",
        )(flat, idxs)
        loss = -lds.mean()
        kernel = self.kernel_fn.compute(
            rng_key, flat, particle_info, lambda p: log_joint(p, _key_at(rng_key, 0)))
        forces = _stein_forces(kernel, self.kernel_fn.mode, flat, grads, loss_temperature,
                               self.repulsion_temperature)
        return loss, unravel_batch(-forces)


def _integer_power(x, n):
    """``x ** n`` for an int ``n >= 0`` by the square-and-multiply of
    ``lax.integer_pow``, so its float32 rounding is the JAX package's."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return np.ones_like(x) if acc is None else acc


class ASVGD(SVGD):
    """Annealed SVGD: the attractive force is tempered by a cyclical schedule,
    so the particles explore before they exploit."""

    def __init__(self, model, optim, kernel_fn=None, num_stein_particles=10, num_cycles=10,
                 transition_speed=10, guide_kwargs={}, *, device=None, **static_kwargs):
        if not (num_cycles > 0 and transition_speed > 0):
            raise ValueError("num_cycles and transition_speed must be positive")
        self.num_cycles = num_cycles
        self.transition_speed = transition_speed
        self._num_steps = 100
        super().__init__(model, optim, kernel_fn, num_stein_particles, guide_kwargs,
                         device=device, **static_kwargs)

    @staticmethod
    def _cyclical_annealing(num_steps, num_cycles, trans_speed, t):
        """The temperature at step ``t`` (a number or an array of them), in
        float32 on the host with the JAX package's operations and order
        (``fmod``, a power by square-and-multiply for an int exponent, a
        float32 floor division); returns a float32 tensor."""
        f32 = np.float32
        t = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, dtype=f32)
        norm = f32(float(num_steps + 1) / float(num_cycles))
        base = np.fmod(t, norm) * f32(num_cycles) / f32(num_steps)
        if isinstance(trans_speed, (int, np.integer)):
            cs_t = _integer_power(base, int(trans_speed))
        else:
            cs_t = np.power(base, f32(trans_speed))
        last_cycle = np.floor_divide(t, norm) >= num_cycles - 1
        out = np.where(last_cycle, f32(1.0), np.clip(cs_t, f32(0.0), f32(1.0))).astype(f32)
        return torch.from_numpy(np.array(out))

    def run(self, rng_key, num_steps, *args, progress_bar=False, **kwargs):
        self._num_steps = num_steps
        state = self.init(rng_key, *args, **kwargs)
        schedule = self._cyclical_annealing(
            num_steps, self.num_cycles, self.transition_speed,
            np.arange(num_steps, dtype=np.float32),
        ).to(_generator_of(state.rng_key).device)
        losses = []
        for t in range(num_steps):
            params = self.optim.get_params(state.optim_state)
            loss, grads = self._annealed_loss_and_grads(schedule[t], state.rng_key, params, *args,
                                                        **kwargs)
            state = SteinVIState(self.optim.update(grads, state.optim_state), state.rng_key)
            losses.append(loss)
        return SteinVIRunResult(self.get_params(state), state, self._stack(losses))

    def _annealed_loss_and_grads(self, anneal, rng_key, params, *args, **kwargs):
        """The SVGD step's loss and gradients with the attractive force
        scaled by ``anneal``."""
        pin_full_f32_matmul()
        return self._svgd_loss_and_grads(rng_key, params, anneal, args, kwargs)
