"""Reparameterizers, applied through the ``handlers.reparam`` handler (port
of ``Reparam``, ``LocScaleReparam``, ``TransformReparam``,
``ExplicitReparam``, ``ProjectedNormalReparam``, ``CircularReparam`` and
``NeuTraReparam`` from ``numpyro_tpu/infer/reparam.py``).

Each reparameterizer is called as ``reparam(name, fn, obs) -> (new_fn,
value)``: ``(None, value)`` replaces the site with a deterministic value
computed from the auxiliary sample sites it introduced.  A site with an
observation raises ``NotImplementedError``, where the JAX package fails an
assertion (ROADMAP.md, Queue 3); ``CircularReparam`` takes one, as the JAX
package's does.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import torch

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions import biject_to, constraints
from numpyro_tpu_torch.distributions.util import safe_normalize, sum_rightmost
from numpyro_tpu_torch.primitives import factor, param, sample

__all__ = [
    "CircularReparam",
    "ExplicitReparam",
    "LocScaleReparam",
    "NeuTraReparam",
    "ProjectedNormalReparam",
    "Reparam",
    "TransformReparam",
]


def _base_support(fn):
    s = fn.support
    return s.base_constraint if isinstance(s, constraints.independent) else s


def _reject_obs(reparam, obs):
    if obs is not None:
        raise NotImplementedError(
            f"{type(reparam).__name__} of an observed site is not ported to "
            "numpyro_tpu_torch (see ROADMAP.md)"
        )


class Reparam(ABC):
    """Base: called as ``reparam(name, fn, obs) -> (new_fn, value)``."""

    @abstractmethod
    def __call__(self, name, fn, obs):
        return fn, obs

    @staticmethod
    def _peel(fn):
        """Strip ``Independent``/``ExpandedDistribution`` wrappers; returns
        ``(base, rewrap)``, where ``rewrap`` restores the original batch and
        event structure on a distribution made from the base's parameters."""
        full_shape, event_dim = fn.shape(), fn.event_dim

        def rewrap(new_fn):
            if new_fn.shape() != full_shape:
                new_fn = new_fn.expand(full_shape[: len(full_shape) - new_fn.event_dim])
            if new_fn.event_dim < event_dim:
                new_fn = new_fn.to_event(event_dim - new_fn.event_dim)
            assert new_fn.event_dim == event_dim
            return new_fn

        base = fn
        while isinstance(base, (dist.Independent, dist.ExpandedDistribution)):
            base = base.base_dist
        return base, rewrap


class LocScaleReparam(Reparam):
    """Decenter a location-scale family: ``centered`` in [0, 1] interpolates
    from the fully non-centred form (0) to the original one (1); ``None``
    learns a value per coordinate as a ``param`` site ``{name}_centered`` in
    the unit interval (for SVI).  ``shape_params`` names further parameters
    of the family that the auxiliary site keeps (``df`` of a ``StudentT``)."""

    def __init__(self, centered=None, shape_params=()):
        if isinstance(centered, (int, float)):
            assert 0 <= centered <= 1
        self.centered = centered
        self.shape_params = shape_params

    def __call__(self, name, fn, obs):
        _reject_obs(self, obs)
        if _base_support(fn) is not constraints.real:
            raise ValueError(
                f"LocScaleReparam only supports real-valued distributions, "
                f"but got site {name} with support {fn.support}."
            )
        base, rewrap = self._peel(fn)
        centered = self.centered
        if centered is None:
            centered = param(
                f"{name}_centered",
                lambda key: base.loc.new_full(fn.shape(), 0.5),
                constraint=constraints.unit_interval,
            )
        if isinstance(centered, (int, float)) and centered == 1.0:
            return fn, obs

        aux_params = {k: getattr(base, k) for k in self.shape_params}
        fully = isinstance(centered, (int, float)) and centered == 0.0
        aux_params["loc"] = torch.zeros_like(base.loc) if fully else base.loc * centered
        aux_params["scale"] = torch.ones_like(base.scale) if fully else base.scale**centered
        noise = sample(f"{name}_decentered", rewrap(type(base)(**aux_params)))
        # undo the partial standardization
        residual = noise - centered * base.loc
        return None, base.loc + base.scale ** (1 - centered) * residual


class TransformReparam(Reparam):
    """Split a ``TransformedDistribution`` into a draw of its base,
    ``{name}_base``, pushed through its transforms."""

    def __call__(self, name, fn, obs):
        _reject_obs(self, obs)
        base, _ = self._peel(fn)
        assert isinstance(base, dist.TransformedDistribution)
        x = sample(f"{name}_base", base.base_dist)
        for t in base.transforms:
            x = t(x)
        return None, x


class ExplicitReparam(Reparam):
    """Reparameterize through a given bijection: ``{name}_base`` is drawn
    from the site's distribution pulled back through ``transform``."""

    def __init__(self, transform):
        self.transform = transform

    def __call__(self, name, fn, obs):
        _reject_obs(self, obs)
        pulled_back = dist.TransformedDistribution(fn, self.transform.inv)
        x = sample(f"{name}_base", pulled_back)
        return None, self.transform(x)


class ProjectedNormalReparam(Reparam):
    """A ``ProjectedNormal`` site as the direction of an auxiliary normal
    draw."""

    def __call__(self, name, fn, obs):
        _reject_obs(self, obs)
        base, rewrap = self._peel(fn)
        assert isinstance(base, dist.ProjectedNormal)
        gauss = dist.Normal(base.concentration, 1.0).to_event(1)
        x = sample(f"{name}_normal", rewrap(gauss), infer={"is_auxiliary": True})
        return None, safe_normalize(x)


class CircularReparam(Reparam):
    """A site on the circle (a ``VonMises``) as a flat site on the real line,
    wrapped onto ``[-pi, pi)``, with the density entering as a factor at the
    wrapped value."""

    def __call__(self, name, fn, obs):
        assert _base_support(fn) is constraints.circular
        line_value = sample(
            f"{name}_unwrapped",
            dist.ImproperUniform(constraints.real, fn.batch_shape, fn.event_shape),
            obs=obs,
        )
        wrapped = torch.remainder(line_value + math.pi, 2 * math.pi) - math.pi
        factor(f"{name}_factor", fn.log_prob(wrapped))
        return None, wrapped


class NeuTraReparam(Reparam):
    """Neural transport through a fitted ``AutoContinuous`` guide: one
    shared latent, drawn in the guide's base space at the first
    reparameterized site of a run, is pushed through the guide's transform
    (once, with its log-Jacobian from the same pass), and every site of the
    guide reads its slice, constrained onto its support.  A site that is
    not among the pending slices starts a run and draws afresh, so a run cut
    short (by an exception) leaves nothing stale behind for the next one."""

    def __init__(self, guide, params):
        self.guide = guide
        self.params = params
        try:
            self.transform = self.guide.get_transform(params)
        except (NotImplementedError, TypeError) as e:
            raise ValueError("NeuTraReparam only supports AutoContinuous guides") from e
        self._pending_sites = {}

    def _reparam_config(self, site):
        if (site["name"] in self.guide.prototype_trace and site["type"] == "sample"
                and not site["is_observed"]):
            return self

    def reparam(self, fn=None):
        """``fn`` under ``handlers.reparam`` with this reparameterizer at
        each of the guide's latent sites."""
        return handlers.reparam(fn, config=self._reparam_config)

    def __call__(self, name, fn, obs):
        if name not in self.guide.prototype_trace:
            return fn, obs
        _reject_obs(self, obs)
        flow_logdet = 0.0
        if name not in self._pending_sites:
            # the first reparameterized site of a run: draw the shared latent
            # and run the transport once; later sites take their slices
            z = sample(f"{name}_shared_latent", self.guide.get_base_dist().mask(False),
                       infer={"is_auxiliary": True})
            x, intermediates = self.transform.call_with_intermediates(z)
            flow_logdet = self.transform.log_abs_det_jacobian(z, x, intermediates)
            self._pending_sites = self.guide._unpack_latent(x)
        unconstrained = self._pending_sites.pop(name)
        to_support = biject_to(fn.support)
        value = to_support(unconstrained)
        logdet = to_support.log_abs_det_jacobian(unconstrained, value)
        logdet = sum_rightmost(logdet, logdet.dim() - value.dim() + len(fn.event_shape))
        factor(f"{name}_log_prob", flow_logdet + fn.log_prob(value) + logdet)
        return None, value

    def transform_sample(self, latent):
        """Push base-space draws (the ``*_shared_latent`` draws of MCMC)
        through the learned transport; returns the constrained site
        values."""
        unpacked = self.guide._unpack_latent(self.transform(latent))
        return {
            name: biject_to(self.guide.prototype_trace[name]["fn"].support)(value)
            for name, value in unpacked.items()
        }
