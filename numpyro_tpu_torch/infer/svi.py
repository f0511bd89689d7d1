"""Stochastic variational inference driver (port of
``numpyro_tpu/infer/svi.py``).

``SVI(..., device=None)`` runs on ``cuda``: ``init`` and ``run`` raise when
that device is not there and never carry on on the CPU; tests pass
``device="cpu"``.  Random state is one ``torch.Generator`` on that device,
made from an int seed or given by the caller; it is the ``rng_key`` of
``SVIState`` and advances with every draw.

``run`` is a Python loop over ``update`` (the JAX package compiles the loop
into one ``lax.scan``).  The losses stay on the device and are stacked once
at the end: no step waits for the host.  ``init``, ``update`` and ``run``
keep float32 matrix products out of TF32 (the counterpart of the JAX loop's
``default_matmul_precision("highest")``).
"""

from __future__ import annotations

import warnings
from collections import namedtuple
from functools import partial

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.transforms import biject_to
from numpyro_tpu_torch.infer.util import (
    device_generator, pin_full_f32_matmul, tqdm_bar, transform_fn,
)
from numpyro_tpu_torch.util import tree_map

__all__ = ["SVI", "SVIRunResult", "SVIState"]

SVIState = namedtuple("SVIState", ["optim_state", "mutable_state", "rng_key"])
"""The optimizer state, the values of the mutable sites and the generator."""

SVIRunResult = namedtuple("SVIRunResult", ["params", "state", "losses"])


def _classify_site(site, loss, params, inv_transforms, mutable, overrides):
    """Record one traced site into the parameter and mutable registries."""
    if site["type"] == "param":
        constraint = site["kwargs"].pop("constraint", constraints.real)
        with handlers.block():
            transform = biject_to(constraint)
        name = site["name"]
        inv_transforms[name] = transform
        value = overrides.get(name, site["value"])
        params[name] = transform.inv(value)
    elif site["type"] == "mutable":
        mutable[site["name"]] = site["value"]
    elif (
        site["type"] == "sample"
        and not site["is_observed"]
        and site["fn"].support.is_discrete
        and not loss.can_infer_discrete
    ):
        warnings.warn(
            f"Currently, SVI with {type(loss).__name__} loss does not support models with "
            f"discrete latent variables ({site['name']})",
            stacklevel=2,
        )


def _fresh(mutable_state):
    """The mutable sites' values with each dict copied: a model that updates
    its state in place (``contrib.module.torch_module``'s buffers) updates
    the copy, which the step returns as the new state, and leaves the held
    state as it was (inside ``torch.func.grad`` it would hold tensors of the
    transform)."""
    return {k: dict(v) if isinstance(v, dict) else v for k, v in mutable_state.items()}


class SVI:
    """Stochastic variational inference.

    :param model: the model.
    :param guide: the guide, a callable with the model's arguments.
    :param optim: an optimizer of :mod:`numpyro_tpu_torch.optim`.
    :param loss: an ELBO of :mod:`numpyro_tpu_torch.infer.elbo`.
    :param device: where the run's generator lives, and so where the guide's
        parameters and draws land.  ``None`` is ``torch.device("cuda")``.
    :param static_kwargs: keyword arguments of the model and guide that every
        call gets.
    """

    def __init__(self, model, guide, optim, loss, *, device=None, **static_kwargs):
        self.model = model
        self.guide = guide
        self.loss = loss
        self.optim = optim
        self.device = torch.device("cuda" if device is None else device)
        self.static_kwargs = static_kwargs
        self.constrain_fn = None

    def init(self, rng_key, *args, init_params=None, **kwargs):
        """Trace the guide and the model, register the params with their
        constraints and initialise the optimizer in unconstrained space.
        ``init_params`` gives constrained values of the guide's params."""
        rng_key = device_generator(rng_key, self.device, "SVI")
        pin_full_f32_matmul()
        # the init traces draw from a generator of their own, seeded by one
        # draw of the run's: how much a guide draws while it traces its model
        # (only on its first call) then leaves the steps' draws as they are
        seed = int(torch.randint(2**62, (), generator=rng_key, device=rng_key.device))
        init_key = torch.Generator(device=rng_key.device).manual_seed(seed)
        guide_init = handlers.seed(self.guide, init_key)
        model_init = handlers.seed(self.model, init_key)
        guide_trace = handlers.trace(guide_init).get_trace(*args, **kwargs, **self.static_kwargs)
        init_guide_params = {
            name: site["value"] for name, site in guide_trace.items() if site["type"] == "param"
        }
        if init_params is not None:
            init_guide_params.update(init_params)
        model_trace = handlers.trace(
            handlers.substitute(handlers.replay(model_init, guide_trace), data=init_guide_params)
        ).get_trace(*args, **kwargs, **self.static_kwargs)

        params, inv_transforms, mutable_state = {}, {}, {}
        for site in list(model_trace.values()) + list(guide_trace.values()):
            _classify_site(site, self.loss, params, inv_transforms, mutable_state,
                           init_guide_params)

        self.constrain_fn = partial(transform_fn, inv_transforms)
        params = {k: tree_map(torch.Tensor.detach, v) if isinstance(v, (list, tuple, dict))
                  else torch.as_tensor(v).detach() for k, v in params.items()}
        return SVIState(self.optim.init(params), mutable_state or None, rng_key)

    def get_params(self, svi_state):
        """Constrained-space params of an ``SVIState``."""
        return self.constrain_fn(self.optim.get_params(svi_state.optim_state))

    def _advance(self, svi_state, args, kwargs, fwd_mode, stable):
        pin_full_f32_matmul()
        held_mutable = svi_state.mutable_state
        # an optimizer that evaluates the loss many times in a step
        # (Minimize) sees the same draws at every evaluation
        replay = getattr(self.optim, "replays_draws", False)
        start = svi_state.rng_key.get_state() if replay else None

        def loss_fn(unconstrained):
            if replay:
                svi_state.rng_key.set_state(start)
            site_values = self.constrain_fn(unconstrained)
            if held_mutable is not None:
                site_values.update(_fresh(held_mutable))
            out = self.loss.loss_with_mutable_state(
                svi_state.rng_key, site_values, self.model, self.guide,
                *args, **kwargs, **self.static_kwargs,
            )
            return out["loss"], out["mutable_state"]

        step = self.optim.eval_and_stable_update if stable else self.optim.eval_and_update
        (loss_val, mutable_state), optim_state = step(
            loss_fn, svi_state.optim_state, forward_mode_differentiation=fwd_mode
        )
        return SVIState(optim_state, mutable_state, svi_state.rng_key), loss_val

    def update(self, svi_state, *args, forward_mode_differentiation=False, **kwargs):
        """One optimization step; returns ``(new_state, loss)``."""
        return self._advance(svi_state, args, kwargs, forward_mode_differentiation,
                             stable=False)

    def stable_update(self, svi_state, *args, forward_mode_differentiation=False, **kwargs):
        """Like :meth:`update`, but keeps the previous state where the loss
        or an updated param is not finite."""
        return self._advance(svi_state, args, kwargs, forward_mode_differentiation,
                             stable=True)

    def run(self, rng_key, num_steps, *args, progress_bar=False, stable_update=False,
            init_state=None, init_params=None, forward_mode_differentiation=False, **kwargs):
        """Optimize for ``num_steps``; returns ``SVIRunResult(params, state,
        losses)`` with the losses, ``(num_steps,)``, on the device.  With
        ``progress_bar`` a ``tqdm`` bar follows the steps and shows the loss
        every 20 steps (a host read); without ``tqdm`` the run goes on
        without a bar, as in the JAX package.  The steps are the same."""
        if init_state is None:
            svi_state = self.init(rng_key, *args, init_params=init_params, **kwargs)
        else:
            svi_state = init_state
        update_fn = self.stable_update if stable_update else self.update
        pin_full_f32_matmul()
        bar = tqdm_bar(num_steps) if progress_bar else None
        losses = []
        for i in range(num_steps):
            svi_state, loss = update_fn(
                svi_state, *args, forward_mode_differentiation=forward_mode_differentiation,
                **kwargs,
            )
            losses.append(loss)
            if bar is not None:
                if i % 20 == 0:
                    bar.set_description(f"loss: {float(loss):.4f}", refresh=False)
                bar.update()
        if bar is not None:
            bar.close()
        losses = torch.stack(losses) if losses else torch.zeros(0, device=self.device)
        return SVIRunResult(self.get_params(svi_state), svi_state, losses)

    def evaluate(self, svi_state, *args, **kwargs):
        """The loss at the current state, with the draws that the next
        :meth:`update` will make (a copy of the generator takes them)."""
        rng_key = svi_state.rng_key
        fork = torch.Generator(device=rng_key.device)
        fork.set_state(rng_key.get_state())
        params = self.get_params(svi_state)
        if svi_state.mutable_state is not None:
            params.update(_fresh(svi_state.mutable_state))
        return self.loss.loss(fork, params, self.model, self.guide, *args, **kwargs,
                              **self.static_kwargs)
