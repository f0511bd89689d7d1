"""Automatic guides for SVI (port of ``AutoGuide``, ``AutoGuideList``,
``AutoNormal``, ``AutoDelta``, ``AutoContinuous``, ``AutoDiagonalNormal``,
``AutoMultivariateNormal``, ``AutoLowRankMultivariateNormal``,
``AutoLaplaceApproximation``, the flow guides ``AutoIAFNormal`` and
``AutoBNAFNormal``, the DAIS guides ``AutoDAIS``,
``AutoSurrogateLikelihoodDAIS`` and ``AutoSemiDAIS``, and the batched guides
``AutoBatchedMultivariateNormal`` and ``AutoBatchedLowRankMultivariateNormal``
from ``numpyro_tpu/infer/autoguide.py``).

A guide traces its model once (the prototype), recreates the model's plates
with their subsample sizes, and declares its parameters with ``param``.  The
packed guides flatten the unconstrained latent sites into one ``(D,)``
vector in sorted-name order, as ``jax.flatten_util.ravel_pytree`` orders a
dict, so the packed parameters of both packages line up element for element.

One departure from the JAX package: there ``AutoContinuous`` samples its
packed latent from ``posterior.mask(False)``, which drops ``log q`` from the
guide's density (the ELBO then has no entropy term and the scales collapse
towards zero).  Here the packed latent is an auxiliary site with its full log
density, as in NumPyro (ROADMAP.md, Queue 3).  The flow guides take it from
the intermediates of ``TransformedDistribution.sample_with_intermediates``,
so the network runs once per draw.

The DAIS guides anneal with a Python loop over ``K`` steps (the JAX package's
``lax.scan``); each step takes ``torch.func.grad`` of the base density and
of the model's log density, which SVI differentiates again (reverse over
reverse).  The GLM op has no second derivative and raises there.
"""

from __future__ import annotations

import functools
import math
import warnings
from abc import ABC, abstractmethod
from contextlib import ExitStack

import numpy as np
import torch
from torch.nn.functional import elu

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.flows import (
    BlockNeuralAutoregressiveTransform,
    InverseAutoregressiveTransform,
)
from numpyro_tpu_torch.distributions.transforms import (
    AffineTransform,
    ComposeTransform,
    IndependentTransform,
    LowerCholeskyAffine,
    PermuteTransform,
    ReshapeTransform,
    UnpackTransform,
    biject_to,
)
from numpyro_tpu_torch.distributions.util import sum_rightmost
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import FlatLayout
from numpyro_tpu_torch.infer.initialization import init_to_median, init_to_uniform
from numpyro_tpu_torch.nn import AutoregressiveNN, BlockNeuralAutoregressiveNN
from numpyro_tpu_torch.primitives import factor, get_mask, module, param, plate, prng_key, sample

__all__ = [
    "AutoBNAFNormal",
    "AutoBatchedLowRankMultivariateNormal",
    "AutoBatchedMultivariateNormal",
    "AutoContinuous",
    "AutoDAIS",
    "AutoDelta",
    "AutoDiagonalNormal",
    "AutoGuide",
    "AutoGuideList",
    "AutoIAFNormal",
    "AutoLaplaceApproximation",
    "AutoLowRankMultivariateNormal",
    "AutoMultivariateNormal",
    "AutoNormal",
    "AutoSemiDAIS",
    "AutoSurrogateLikelihoodDAIS",
]


def _is_latent(site):
    """A continuous, unobserved sample site."""
    return (
        site["type"] == "sample"
        and not site["is_observed"]
        and not site["fn"].support.is_discrete
    )


def _support_bijector(site):
    """``biject_to(site's support)``, made outside the handler stack."""
    with handlers.block():
        return biject_to(site["fn"].support)


def _map_leading_axes(fn, tree, n_leading):
    """Apply ``fn`` (written for unbatched inputs) under ``n_leading`` extra
    leading axes, collapsed into one ``vmap``-ed axis."""
    if n_leading == 0:
        return fn(tree)
    leaves = list(tree.values()) if isinstance(tree, dict) else [tree]
    lead = tuple(leaves[0].shape[:n_leading])
    if isinstance(tree, dict):
        flat = {k: v.reshape((-1,) + tuple(v.shape[n_leading:])) for k, v in tree.items()}
    else:
        flat = tree.reshape((-1,) + tuple(tree.shape[n_leading:]))
    out = torch.func.vmap(fn)(flat)
    return {k: v.reshape(lead + tuple(v.shape[1:])) for k, v in out.items()}


class AutoGuide(ABC):
    """Base: traces the model once (prototype), recreates its plates, and
    generates the guide's sample statements."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_uniform, create_plates=None):
        self.model = model
        self.prefix = prefix
        self.create_plates = create_plates
        self.init_loc_fn = init_loc_fn
        self.prototype_trace = None
        self._plate_frames = {}
        self._plate_full_sizes = {}

    def _pname(self, *suffix):
        return "_".join((self.prefix,) + suffix)

    def _latent_sites(self):
        for name, site in self.prototype_trace.items():
            if _is_latent(site):
                yield name, site

    def _constrain_dict(self, latent):
        """Map unconstrained site values onto their supports."""
        return {
            name: _support_bijector(self.prototype_trace[name])(value)
            for name, value in latent.items()
        }

    def _create_plates(self, *args, **kwargs):
        # made afresh on every call: a plate holds its subsample indices
        if self.create_plates is None:
            plates = {}
        else:
            created = self.create_plates(*args, **kwargs)
            if isinstance(created, plate):
                created = [created]
            if not all(isinstance(p, plate) for p in created):
                raise ValueError("create_plates() returned a non-plate")
            plates = {p.name: p for p in created}
        for name, frame in sorted(self._plate_frames.items()):
            if name not in plates:
                full_size = self._plate_full_sizes[name]
                sub = frame.subsample_size
                plates[name] = plate(
                    name, full_size, dim=frame.dim,
                    subsample_size=None if sub == full_size else sub,
                )
        return plates

    @abstractmethod
    def __call__(self, *args, **kwargs):
        raise NotImplementedError

    @abstractmethod
    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        raise NotImplementedError

    def _setup_prototype(self, *args, **kwargs):
        rng_key = prng_key()
        if rng_key is None:
            raise ValueError(
                f"the first call of {type(self).__name__} traces the model and needs a "
                "generator: call it under handlers.seed (SVI.init does)"
            )
        with handlers.block():
            init_params, self._potential_fn, _, self.prototype_trace = (
                infer_util.initialize_model(
                    rng_key, self.model, init_strategy=self.init_loc_fn,
                    model_args=args, model_kwargs=kwargs, validate_grad=False,
                )
            )
        self._init_locs = init_params[0]

        self._plate_frames = {}
        self._plate_full_sizes = {}
        for name, site in self.prototype_trace.items():
            if site["type"] == "sample":
                if not site["is_observed"] and site["fn"].support.is_discrete:
                    warnings.warn(
                        f"Model has discrete latent site {name}; autoguides marginalize "
                        "nothing.",
                        stacklevel=2,
                    )
                for frame in site["cond_indep_stack"]:
                    self._plate_frames[frame.name] = frame
                    self._plate_full_sizes[frame.name] = frame.size
            elif site["type"] == "plate":
                self._plate_full_sizes[name] = site["args"][0]

    def median(self, params):
        raise NotImplementedError

    def quantiles(self, params, quantiles):
        raise NotImplementedError


class AutoGuideList(AutoGuide):
    """Part guides over disjoint sets of sites, appended in order; each part
    sees its sites of the model through ``handlers.block``.
    ``sample_posterior`` draws from the one generator, part by part, in the
    order of the parts."""

    def __init__(self, model, *, prefix="auto", create_plates=None):
        self._guides = []
        super().__init__(model, prefix=prefix, create_plates=create_plates)

    def append(self, part):
        self._guides.append(part)

    def _merged(self, method, *args, **kwargs):
        merged = {}
        for part in self._guides:
            merged.update(getattr(part, method)(*args, **kwargs))
        return merged

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)
        return self._merged("__call__", *args, **kwargs)

    def __getitem__(self, key):
        return self._guides[key]

    def __len__(self):
        return len(self._guides)

    def __iter__(self):
        yield from self._guides

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        return self._merged("sample_posterior", rng_key, params, *args,
                            sample_shape=sample_shape, **kwargs)

    def median(self, params):
        return self._merged("median", params)

    def quantiles(self, params, quantiles):
        return self._merged("quantiles", params, quantiles)


class AutoNormal(AutoGuide):
    """A mean-field Normal per latent site in unconstrained space, pushed
    through the site's support bijection."""

    scale_constraint = constraints.softplus_positive

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_uniform, init_scale=0.1,
                 create_plates=None):
        self._init_scale = init_scale
        self._event_dims = {}
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn,
                         create_plates=create_plates)

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        for name, site in self._latent_sites():
            # a site seen through a subsample plate has fewer dims in the
            # trace than in the full-size init location
            self._event_dims[name] = (
                site["fn"].event_dim + self._init_locs[name].dim() - site["value"].dim()
            )

    def _site_family(self, name, init_loc, event_dim):
        """The site's factor: ``Normal(loc, scale)`` over its event dims."""
        loc = param(self._pname(name, "loc"), init_loc, event_dim=event_dim)
        scale = param(
            self._pname(name, "scale"),
            torch.full_like(init_loc, self._init_scale),
            constraint=self.scale_constraint,
            event_dim=event_dim,
        )
        return dist.Normal(loc, scale).to_event(event_dim)

    @staticmethod
    def _is_real_support(support):
        if support is constraints.real:
            return True
        return isinstance(support, constraints.independent) and isinstance(
            support.base_constraint, type(constraints.real)
        )

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)

        plates = self._create_plates(*args, **kwargs)
        out = {}
        for name, site in self._latent_sites():
            with ExitStack() as stack:
                for frame in site["cond_indep_stack"]:
                    stack.enter_context(plates[frame.name])
                factor = self._site_family(name, self._init_locs[name], self._event_dims[name])
                if self._is_real_support(site["fn"].support):
                    out[name] = sample(name, factor)
                else:
                    pushed = dist.TransformedDistribution(factor, _support_bijector(site))
                    out[name] = sample(name, pushed)
        return out

    def _constrain(self, latent_samples):
        probe = next(iter(latent_samples))
        n_sample_dims = latent_samples[probe].dim() - self._init_locs[probe].dim()
        return _map_leading_axes(self._constrain_dict, latent_samples, n_sample_dims)

    def _site_params(self, params, suffix):
        return {name: params[self._pname(name, suffix)] for name in self._init_locs}

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        locs = self._site_params(params, "loc")
        scales = self._site_params(params, "scale")
        with handlers.seed(rng_seed=rng_key):
            latent = {
                name: sample(
                    name + "_latent",
                    dist.Normal(locs[name], scales[name]).to_event(self._event_dims[name]),
                    sample_shape=sample_shape,
                )
                for name in locs
            }
        return self._constrain(latent)

    def median(self, params):
        return self._constrain_dict(self._site_params(params, "loc"))

    def quantiles(self, params, quantiles):
        out = {}
        for name in self._init_locs:
            loc = params[self._pname(name, "loc")]
            scale = params[self._pname(name, "scale")]
            q = torch.as_tensor(quantiles, dtype=loc.dtype, device=loc.device)
            latent = dist.Normal(loc, scale).icdf(q.reshape((-1,) + (1,) * loc.dim()))
            out[name] = _support_bijector(self.prototype_trace[name])(latent)
        return out


class AutoDelta(AutoGuide):
    """MAP guide: a point mass at a learned location per latent site,
    parameterised in constrained space."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_median, create_plates=None):
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn,
                         create_plates=create_plates)

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        with handlers.block():
            constrained = self._constrain_dict(self._init_locs)
        self._init_locs = {k: constrained[k] for k in self._init_locs}
        self._event_dims = {name: site["fn"].event_dim for name, site in self._latent_sites()}

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)

        plates = self._create_plates(*args, **kwargs)
        out = {}
        for name, site in self._latent_sites():
            event_dim = self._event_dims[name]
            with ExitStack() as stack:
                for frame in site["cond_indep_stack"]:
                    stack.enter_context(plates[frame.name])
                point = param(
                    self._pname(name, "loc"), self._init_locs[name],
                    constraint=site["fn"].support, event_dim=event_dim,
                )
                out[name] = sample(name, dist.Delta(point, event_dim=event_dim))
        return out

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        return {
            name: torch.broadcast_to(
                params[self._pname(name, "loc")],
                tuple(sample_shape) + tuple(params[self._pname(name, "loc")].shape),
            )
            for name in self._init_locs
        }

    def median(self, params):
        return {name: params[self._pname(name, "loc")] for name in self._init_locs}


class AutoContinuous(AutoGuide):
    """Base of the guides over one packed unconstrained latent vector."""

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        layout = FlatLayout(self._init_locs)
        self.latent_dim = layout.dim
        if self.latent_dim == 0:
            raise RuntimeError(
                f"{type(self).__name__} found no latent variables; Use an empty guide instead."
            )
        self._init_latent = torch.cat([self._init_locs[k].reshape(-1) for k in layout.names])
        self._unpack_latent = UnpackTransform(layout.unravel_one)

    @abstractmethod
    def _get_posterior(self):
        raise NotImplementedError

    def _sample_latent(self, *args, **kwargs):
        sample_shape = kwargs.pop("sample_shape", ())
        return sample(
            "_auto_latent", self._get_posterior(), sample_shape=sample_shape,
            infer={"is_auxiliary": True},
        )

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)

        packed = self._sample_latent(*args, **kwargs)
        out = {}
        for name, unconstrained in self._unpack_latent(packed).items():
            site = self.prototype_trace[name]
            push = _support_bijector(site)
            value = push(unconstrained)
            event_ndim = site["fn"].event_dim
            if get_mask() is False:
                correction = 0.0
            else:
                correction = -push.log_abs_det_jacobian(unconstrained, value)
                correction = sum_rightmost(
                    correction, correction.dim() - value.dim() + event_ndim
                )
            out[name] = sample(
                name, dist.Delta(value, log_density=correction, event_dim=event_ndim)
            )
        return out

    def _unpack_and_constrain(self, latent_sample, params):
        def one(flat):
            return self._constrain_dict(self._unpack_latent(flat))

        return _map_leading_axes(one, latent_sample, latent_sample.dim() - 1)

    def get_base_dist(self):
        """The fixed base distribution of the learned transport."""
        raise NotImplementedError

    def get_transform(self, params):
        """The bijection from the base distribution to the posterior over
        the packed latent (what ``NeuTraReparam`` pushes through): the
        posterior rebuilt under ``params``, its transforms composed."""
        posterior = handlers.substitute(self._get_posterior, data=params)()
        if not isinstance(posterior, dist.TransformedDistribution):
            raise NotImplementedError("posterior is not a transformed distribution")
        chain = posterior.transforms
        return ComposeTransform(chain) if len(chain) > 1 else chain[0]

    def get_posterior(self, params):
        """The posterior over the packed unconstrained latent."""
        return dist.TransformedDistribution(self.get_base_dist(), self.get_transform(params))

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        packed = handlers.substitute(
            handlers.seed(self._sample_latent, rng_key), data=params
        )(sample_shape=sample_shape)
        return self._unpack_and_constrain(packed, params)

    def median(self, params):
        raise NotImplementedError

    def quantiles(self, params, quantiles):
        raise NotImplementedError


class _PackedNormalGuide(AutoContinuous):
    """The ``init_scale`` plumbing of the packed Gaussian guides."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_uniform, init_scale=0.1,
                 create_plates=None):
        if init_scale <= 0:
            raise ValueError("Expected init_scale > 0.")
        self._init_scale = init_scale
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn,
                         create_plates=create_plates)

    def get_base_dist(self):
        zeros = self._init_latent.new_zeros(self.latent_dim)
        return dist.Normal(zeros, 1.0).to_event(1)

    def median(self, params):
        return self._unpack_and_constrain(params[self._pname("loc")], params)

    def _marginal_normal(self, params):
        """The Normal of each coordinate of the posterior."""
        raise NotImplementedError

    def quantiles(self, params, quantiles):
        loc = params[self._pname("loc")]
        q = torch.as_tensor(quantiles, dtype=loc.dtype, device=loc.device)[..., None]
        latent = self._marginal_normal(params).icdf(q)
        return self._unpack_and_constrain(latent, params)


class AutoDiagonalNormal(_PackedNormalGuide):
    """A diagonal Normal over the packed latent (ADVI)."""

    scale_constraint = constraints.softplus_positive

    def _get_posterior(self):
        loc = param(self._pname("loc"), self._init_latent)
        scale = param(
            self._pname("scale"),
            torch.full_like(self._init_latent, self._init_scale),
            constraint=self.scale_constraint,
        )
        return dist.Normal(loc, scale).to_event(1)

    def get_transform(self, params):
        return IndependentTransform(
            AffineTransform(params[self._pname("loc")], params[self._pname("scale")]), 1
        )

    def get_posterior(self, params):
        return dist.Normal(params[self._pname("loc")], params[self._pname("scale")]).to_event(1)

    def _marginal_normal(self, params):
        return dist.Normal(params[self._pname("loc")], params[self._pname("scale")])


class AutoMultivariateNormal(_PackedNormalGuide):
    """A full-covariance Normal over the packed latent."""

    scale_tril_constraint = constraints.scaled_unit_lower_cholesky

    def _get_posterior(self):
        loc = param(self._pname("loc"), self._init_latent)
        eye = torch.eye(self.latent_dim, dtype=loc.dtype, device=loc.device)
        scale_tril = param(
            self._pname("scale_tril"), eye * self._init_scale,
            constraint=self.scale_tril_constraint,
        )
        return dist.MultivariateNormal(loc, scale_tril=scale_tril)

    def get_transform(self, params):
        return LowerCholeskyAffine(params[self._pname("loc")], params[self._pname("scale_tril")])

    def get_posterior(self, params):
        return dist.MultivariateNormal(
            params[self._pname("loc")], scale_tril=params[self._pname("scale_tril")]
        )

    def _marginal_normal(self, params):
        root = params[self._pname("scale_tril")]
        return dist.Normal(params[self._pname("loc")], torch.linalg.vector_norm(root, dim=-1))


class AutoLowRankMultivariateNormal(_PackedNormalGuide):
    """A Normal over the packed latent whose covariance is a rank-``rank``
    factor plus a diagonal (``round(sqrt(D))`` by default): ``cov_factor``
    and ``scale`` are learned, the factor of the covariance is
    ``cov_factor * scale[:, None]`` and its diagonal ``scale ** 2``."""

    scale_constraint = constraints.softplus_positive

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_uniform, init_scale=0.1,
                 rank=None, create_plates=None):
        self.rank = rank
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn, init_scale=init_scale,
                         create_plates=create_plates)

    def _get_posterior(self):
        rank = int(round(self.latent_dim**0.5)) if self.rank is None else self.rank
        loc = param(self._pname("loc"), self._init_latent)
        raw_factor = param(self._pname("cov_factor"),
                           self._init_latent.new_zeros((self.latent_dim, rank)))
        scale = param(
            self._pname("scale"), torch.full_like(self._init_latent, self._init_scale),
            constraint=self.scale_constraint,
        )
        return dist.LowRankMultivariateNormal(loc, raw_factor * scale[..., None], scale.square())

    def get_posterior(self, params):
        scale = params[self._pname("scale")]
        return dist.LowRankMultivariateNormal(
            params[self._pname("loc")], params[self._pname("cov_factor")] * scale[..., None],
            scale.square(),
        )

    def _marginal_normal(self, params):
        posterior = self.get_posterior(params)
        return dist.Normal(posterior.loc, torch.sqrt(posterior.variance))


class AutoLaplaceApproximation(AutoContinuous):
    """A point mass fitted at the MAP (``Delta``), then a Normal there whose
    covariance is the inverse of the Hessian of the potential
    (``torch.func.hessian``, forward over reverse mode, by default).  The
    Hessian cannot pass through ``ops.glm.bernoulli_logits_loglik``, which
    has no forward mode (nor has the JAX package's op): it raises there."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_uniform, create_plates=None,
                 hessian_fn=None):
        self._hessian_fn = (
            hessian_fn if hessian_fn is not None else (lambda f, x: torch.func.hessian(f)(x))
        )
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn,
                         create_plates=create_plates)

    def _get_posterior(self):
        return dist.Delta(param(self._pname("loc"), self._init_latent), event_dim=1)

    def get_base_dist(self):
        return dist.Normal(self._init_latent.new_zeros(self.latent_dim), 1.0).to_event(1)

    def _neg_log_joint(self, packed):
        return self._potential_fn(self._unpack_latent(packed))

    def get_posterior(self, params):
        """The Normal at the fitted ``loc`` with the inverse Hessian as its
        covariance; where that is not positive definite, a warning and a
        zero ``scale_tril`` (the draws are the MAP point)."""
        point = params[self._pname("loc")]
        curvature = self._hessian_fn(self._neg_log_joint, point)
        cov, inv_info = torch.linalg.inv_ex(curvature)
        scale_tril, chol_info = torch.linalg.cholesky_ex(cov)
        if bool((inv_info != 0) | (chol_info != 0) | torch.isnan(scale_tril).any()):
            warnings.warn(
                "Hessian of log posterior at the MAP point is singular. Posterior samples "
                "from AutoLaplaceApproximation will be constant (equal to the MAP point).",
                stacklevel=2,
            )
            scale_tril = torch.zeros_like(scale_tril)
        return dist.MultivariateNormal(point, scale_tril=scale_tril)

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        packed = self.get_posterior(params).sample(rng_key, tuple(sample_shape))
        return self._unpack_and_constrain(packed, params)

    def median(self, params):
        return self._unpack_and_constrain(params[self._pname("loc")], params)

    def quantiles(self, params, quantiles):
        posterior = self.get_posterior(params)
        q = torch.as_tensor(quantiles, dtype=posterior.loc.dtype, device=posterior.loc.device)
        latent = dist.Normal(posterior.loc, torch.sqrt(posterior.variance)).icdf(q[..., None])
        return self._unpack_and_constrain(latent, params)


class _FlowGuide(AutoContinuous):
    """A stack of learned flow layers over a standard Normal, with a
    reversing permutation between two layers; each layer's network is a
    ``module`` whose params are one ``param`` site."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=None, num_flows=1):
        self.num_flows = num_flows
        # the networks, made once (their masks with them) and bound to the
        # params of each call
        self._networks = {}
        super().__init__(model, prefix=prefix,
                         init_loc_fn=init_to_uniform if init_loc_fn is None else init_loc_fn)

    def _network(self, i):
        raise NotImplementedError

    def _flow_layer(self, i):
        raise NotImplementedError

    def _bound_network(self, i):
        if i not in self._networks:
            self._networks[i] = self._network(i)
        return module(self._pname(f"arn__{i}"), self._networks[i], (self.latent_dim,))

    def _get_posterior(self):
        if self.latent_dim == 1:
            raise ValueError("latent dim = 1. Consider using AutoDiagonalNormal instead")
        reverse = np.arange(self.latent_dim)[::-1].copy()
        layers = []
        for i in range(self.num_flows):
            if i:
                layers.append(PermuteTransform(reverse))
            layers.append(self._flow_layer(i))
        return dist.TransformedDistribution(self.get_base_dist(), layers)

    def get_base_dist(self):
        return dist.Normal(self._init_latent.new_zeros(self.latent_dim), 1.0).to_event(1)


class AutoIAFNormal(_FlowGuide):
    """A standard Normal pushed through ``num_flows`` inverse autoregressive
    flows over the packed latent (Kingma et al. 2016).  ``hidden_dims`` are
    the conditioner's widths (``[D, D]`` by default) and ``nonlinearity`` a
    callable on tensors (ELU by default, the JAX package's ``stax.Elu``)."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=None, num_flows=3,
                 hidden_dims=None, skip_connections=False, nonlinearity=None):
        self._hidden_dims = hidden_dims
        self._skip_connections = skip_connections
        self._nonlinearity = elu if nonlinearity is None else nonlinearity
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn, num_flows=num_flows)

    def _network(self, i):
        widths = (
            [self.latent_dim, self.latent_dim] if self._hidden_dims is None
            else self._hidden_dims
        )
        return AutoregressiveNN(
            self.latent_dim, widths, permutation=np.arange(self.latent_dim),
            skip_connections=self._skip_connections, nonlinearity=self._nonlinearity,
        )

    def _flow_layer(self, i):
        return InverseAutoregressiveTransform(self._bound_network(i))


class AutoBNAFNormal(_FlowGuide):
    """A standard Normal pushed through block neural autoregressive flows
    (De Cao et al.); every layer but the last has a gated residual."""

    def __init__(self, model, *, prefix="auto", init_loc_fn=None, num_flows=1,
                 hidden_factors=(8, 8)):
        self._hidden_factors = list(hidden_factors)
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn, num_flows=num_flows)

    def _network(self, i):
        residual = "gated" if i < (self.num_flows - 1) else None
        return BlockNeuralAutoregressiveNN(self.latent_dim, self._hidden_factors, residual)

    def _flow_layer(self, i):
        return BlockNeuralAutoregressiveTransform(self._bound_network(i))


def _check_dais_hyperparams(K, eta_init, eta_max, gamma_init, init_scale):
    if K < 1:
        raise ValueError(f"K must satisfy K >= 1 (got K = {K})")
    if eta_init <= 0.0 or eta_init >= eta_max:
        raise ValueError("eta_init must be positive with eta_init < eta_max.")
    if eta_max <= 0.0:
        raise ValueError("eta_max must be positive.")
    if gamma_init <= 0.0 or gamma_init >= 1.0:
        raise ValueError("gamma_init must be in the open interval (0, 1).")
    if init_scale <= 0.0:
        raise ValueError("init_scale must be positive.")


def _dais_anneal(z_0, eps_seq, beta_seq, *, eta0, eta_coeff, eta_max, gamma, inv_mass,
                 momentum_lp, base_grad, target_grad, widen, log_factor_0):
    """The K uncorrected-leapfrog annealing steps of the DAIS guides: a
    Python loop over the leading axis of ``eps_seq`` and ``beta_seq`` whose
    carry is (position, velocity, accumulated log-weight correction).
    ``widen`` right-expands per-instance scalars (eta, beta, gamma) onto the
    latent axis (the identity for ``AutoDAIS``)."""
    # the last refresh draw is never consumed; it is the initial velocity
    z, v, log_factor = z_0, eps_seq[-1], log_factor_0
    for k in range(eps_seq.shape[0]):
        eps_k, beta = eps_seq[k], beta_seq[k]
        eta = torch.clamp(eta0 + eta_coeff * beta, 0.0, eta_max)
        eta_w, beta_w = widen(eta), widen(beta)
        # leapfrog under the annealed density (1 - beta) base + beta target
        z_half = z + v * eta_w * inv_mass
        pull = (1.0 - beta_w) * base_grad(z_half) + beta_w * target_grad(z_half)
        v_hat = v + eta_w * pull
        z_next = z_half + v_hat * eta_w * inv_mass
        # partial momentum refresh, with the kinetic-energy correction
        g = widen(gamma)
        v_next = g * v_hat + torch.sqrt(1.0 - g**2) * eps_k
        log_factor = log_factor + momentum_lp(v) - momentum_lp(v_hat)
        z, v = z_next, v_next
    return z, log_factor


def _normalized_schedule(raw_increments):
    steps = torch.cumsum(raw_increments, dim=-1)
    return steps / steps[..., -1:]


class AutoDAIS(AutoContinuous):
    """Differentiable annealed importance sampling (Geffner & Domke; Zhang
    et al.): ``K`` uncorrected HMC steps from a learned Normal base
    (``base_dist`` ``"diagonal"`` or ``"cholesky"``) towards the posterior.
    ``z_0`` keeps its full density, the momentum draws are masked out of it,
    and the steps' log-weight enters through ``factor``, as in the JAX
    package."""

    def __init__(self, model, *, K=4, base_dist="diagonal", eta_init=0.01, eta_max=0.1,
                 gamma_init=0.9, prefix="auto", init_loc_fn=init_to_uniform, init_scale=0.1):
        _check_dais_hyperparams(K, eta_init, eta_max, gamma_init, init_scale)
        if base_dist not in ["diagonal", "cholesky"]:
            raise ValueError('base_dist must be one of "diagonal" or "cholesky".')
        self.eta_init = eta_init
        self.eta_max = eta_max
        self.gamma_init = gamma_init
        self.K = K
        self.base_dist = base_dist
        self._init_scale = init_scale
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn)

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        for site in self.prototype_trace.values():
            if (site["type"] == "plate" and isinstance(site["args"][1], int)
                    and site["args"][0] > site["args"][1]):
                raise NotImplementedError("AutoDAIS cannot be used with data subsampling.")

    def _get_posterior(self):
        raise NotImplementedError

    def _dais_log_density(self, x):
        with handlers.block():
            return -self._potential_fn(self._unpack_latent(x))

    def _scalar(self, value):
        return self._init_latent.new_tensor(value)

    def _dais_schedule_params(self):
        eta0 = param(self._pname("eta0"), self._scalar(self.eta_init),
                     constraint=constraints.interval(0, self.eta_max))
        eta_coeff = param(self._pname("eta_coeff"), self._scalar(0.0))
        gamma = param(self._pname("gamma"), self._scalar(self.gamma_init),
                      constraint=constraints.interval(0, 1))
        betas = _normalized_schedule(
            param(self._pname("beta_increments"), self._init_latent.new_ones(self.K),
                  constraint=constraints.positive)
        )
        return eta0, eta_coeff, gamma, betas

    def _base_family(self):
        anchor = param(self._pname("z_0_loc"), self._init_latent)
        if self.base_dist == "diagonal":
            spread = param(self._pname("z_0_scale"),
                           torch.full_like(self._init_latent, self._init_scale),
                           constraint=constraints.positive)
            return dist.Normal(anchor, spread).to_event()
        eye = torch.eye(self.latent_dim, dtype=anchor.dtype, device=anchor.device)
        root = param(self._pname("z_0_scale_tril"), eye * self._init_scale,
                     constraint=constraints.scaled_unit_lower_cholesky)
        return dist.MultivariateNormal(anchor, scale_tril=root)

    def _sample_latent(self, *args, **kwargs):
        # one latent per call: sample_posterior maps this over its draws
        eta0, eta_coeff, gamma, betas = self._dais_schedule_params()
        mass = param(self._pname("mass_matrix"), self._init_latent.new_ones(self.latent_dim),
                     constraint=constraints.positive)
        base = self._base_family()
        z_0 = sample(self._pname("z_0"), base, infer={"is_auxiliary": True})
        momentum = dist.Normal(0.0, mass).to_event()
        eps = sample(
            self._pname("momentum"), momentum.expand((self.K,)).to_event().mask(False),
            infer={"is_auxiliary": True},
        )
        z, log_factor = _dais_anneal(
            z_0, eps, betas, eta0=eta0, eta_coeff=eta_coeff, eta_max=self.eta_max,
            gamma=gamma, inv_mass=0.5 / mass, momentum_lp=momentum.log_prob,
            base_grad=torch.func.grad(base.log_prob),
            target_grad=torch.func.grad(self._dais_log_density),
            widen=lambda s: s, log_factor_0=0.0,
        )
        factor(self._pname("factor"), log_factor)
        return z

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        """One annealed draw per element of ``sample_shape``, mapped with
        ``torch.func.vmap`` (``randomness="different"``) over the draws."""

        def one_draw(_):
            return handlers.substitute(handlers.seed(self._sample_latent, rng_key),
                                       data=params)()

        sample_shape = tuple(sample_shape)
        if not sample_shape:
            packed = one_draw(None)
        else:
            n = math.prod(sample_shape)
            index = torch.arange(n, device=self._init_latent.device)
            packed = torch.func.vmap(one_draw, randomness="different")(index)
            packed = packed.reshape(sample_shape + (self.latent_dim,))
        return self._unpack_and_constrain(packed, params)


class AutoSurrogateLikelihoodDAIS(AutoDAIS):
    """DAIS guided by the potential of a cheap ``surrogate_model`` (Jankowiak
    & Phan); unlike ``AutoDAIS`` it composes with data subsampling.  The
    surrogate's ``param`` sites are registered with the guide's, but its
    potential runs under ``block()``, which hides them from SVI's
    substitution: they keep their initial values and get a zero gradient, as
    in the JAX package (ROADMAP.md, Queue 3)."""

    def __init__(self, model, surrogate_model, *, K=4, eta_init=0.01, eta_max=0.1,
                 gamma_init=0.9, prefix="auto", base_dist="diagonal",
                 init_loc_fn=init_to_uniform, init_scale=0.1):
        super().__init__(model, K=K, eta_init=eta_init, eta_max=eta_max,
                         gamma_init=gamma_init, prefix=prefix, init_loc_fn=init_loc_fn,
                         init_scale=init_scale, base_dist=base_dist)
        self.surrogate_model = surrogate_model

    def _setup_prototype(self, *args, **kwargs):
        AutoContinuous._setup_prototype(self, *args, **kwargs)
        rng_key = prng_key()
        if rng_key is None:
            rng_key = torch.Generator(device=self._init_latent.device).manual_seed(0)
        with handlers.block():
            _, self._surrogate_potential_fn, _, self._surrogate_prototype_trace = (
                infer_util.initialize_model(
                    rng_key, self.surrogate_model, init_strategy=self.init_loc_fn,
                    dynamic_args=False, model_args=(), model_kwargs={}, validate_grad=False,
                )
            )

    def _dais_log_density(self, x):
        with handlers.block():
            return -self._surrogate_potential_fn(self._unpack_latent(x))

    def _sample_latent(self, *args, **kwargs):
        # the surrogate's params, registered with the guide's
        for name, site in self._surrogate_prototype_trace.items():
            if site["type"] == "param":
                param(name, site["value"], **site["kwargs"])
        return super()._sample_latent(*args, **kwargs)


def _flatten_local_dict(values):
    """The arrays of a dict, in sorted-name order, flattened into one vector,
    and their shapes."""
    names = sorted(values)
    flat = torch.cat([values[n].reshape(-1) for n in names])
    return flat, {n: tuple(values[n].shape) for n in names}


def _unflatten_local_dict(flat, shapes):
    out, pos = {}, 0
    for n in sorted(shapes):
        size = math.prod(shapes[n])
        out[n] = flat[..., pos:pos + size].reshape(tuple(flat.shape[:-1]) + shapes[n])
        pos += size
    return out


def _subsample_model(model, *args, **kwargs):
    """Run ``model`` with the subsample indices of its plates pinned by the
    ``_subsample_idx`` keyword (a dict plate name -> indices)."""
    data = kwargs.pop("_subsample_idx", {})
    with handlers.substitute(data=data):
        return model(*args, **kwargs)


class AutoSemiDAIS(AutoGuide):
    """Semi-parametric DAIS (Jankowiak and Phan): a parametric guide over the
    global latents and differentiable annealed importance sampling over the
    local latents of one subsample plate, the subsampling sibling of
    :class:`AutoDAIS`.

    The local latents of the drawn rows are packed into one ``(S, D)``
    matrix: each site's plate axis moved to the front and its per-datum
    values flattened in sorted-name order (the JAX package's ``vmap`` over a
    dict of axes).  The ``K`` annealing steps take ``torch.func.grad`` of the
    local model's log density inside SVI's gradient, as ``AutoDAIS`` does.
    Without ``use_global_dais_params`` the schedule parameters are ``param``
    sites of length N declared in the plate, which reads the drawn rows, so
    their gradient lands in those rows and is 0 in the others.

    :param callable model: the whole model (globals and locals).
    :param callable local_model: its local part, called with what
        ``global_guide.model`` returns (or with the model's arguments when
        there is no ``global_guide``).
    :param global_guide: the guide of the global latents, or None.
    :param local_guide: an optional guide whose draws of the locals are the
        annealing's start.
    """

    def __init__(self, model, local_model, global_guide=None, local_guide=None, *,
                 prefix="auto", K=4, eta_init=0.01, eta_max=0.1, gamma_init=0.9,
                 init_scale=0.1, subsample_plate=None, use_global_dais_params=False):
        super().__init__(model, prefix=prefix, init_loc_fn=init_to_uniform)
        _check_dais_hyperparams(K, eta_init, eta_max, gamma_init, init_scale)
        self.local_model = local_model
        self.global_guide = global_guide
        self.local_guide = local_guide
        self.K = K
        self.eta_init = eta_init
        self.eta_max = eta_max
        self.gamma_init = gamma_init
        self._init_scale = init_scale
        self.subsample_plate = subsample_plate
        self.use_global_dais_params = use_global_dais_params

    def _find_subsample_plate(self):
        def is_subsampled(site):
            return (site["type"] == "plate" and isinstance(site["args"][1], int)
                    and site["args"][0] > site["args"][1])

        candidates = {n: s for n, s in self.prototype_trace.items() if is_subsampled(s)}
        if self.subsample_plate is not None:
            candidates[self.subsample_plate] = self.prototype_trace[self.subsample_plate]
        elif not candidates:
            candidates = {n: s for n, s in self.prototype_trace.items() if s["type"] == "plate"}
        if len(candidates) != 1:
            raise ValueError(
                "AutoSemiDAIS expects exactly one data (subsample) plate, "
                f"found {len(candidates)}"
            )
        name = next(iter(candidates))
        full, sub = candidates[name]["args"]
        return name, full, full if sub is None else sub

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        plate_name, N, subsample_size = self._find_subsample_plate()

        # the local latents (inside the plate), and the axis of each that the
        # plate occupies
        self._local_axes = {}
        plate_dim = None
        for name, site in self.prototype_trace.items():
            if site["type"] != "sample" or site["is_observed"]:
                continue
            for frame in site["cond_indep_stack"]:
                if frame.name == plate_name:
                    if plate_dim is None:
                        plate_dim = frame.dim
                    self._local_axes[name] = plate_dim - site["fn"].event_dim
                    break
        if not self._local_axes:
            raise RuntimeError(
                f"No local latent variables found in plate `{plate_name}`; "
                "AutoSemiDAIS requires local variables."
            )
        local_init = {n: v for n, v in self._init_locs.items() if n in self._local_axes}
        per_datum = {n: v.movedim(self._local_axes[n], 0)[0] for n, v in local_init.items()}
        _, self._local_shapes = _flatten_local_dict(per_datum)
        self._like = next(iter(local_init.values()))
        self._local_latent_dim = sum(math.prod(s) for s in self._local_shapes.values())
        self._local_plate = (plate_name, N, subsample_size)

        # prototype traces of the local model (and guide), for their params
        if self.global_guide is not None:
            with handlers.block():
                local_args = (self.global_guide.model(*args, **kwargs),)
                local_kwargs = {}
        else:
            local_args = args
            local_kwargs = kwargs.copy()
        if self.local_guide is not None:
            with handlers.block(), handlers.trace() as tr:
                self.local_guide(*local_args, **local_kwargs)
            self._proto_local_guide_trace = tr
        with handlers.block(), handlers.trace() as tr:
            self.local_model(*local_args, **local_kwargs)
        self._proto_local_model_trace = tr

    def _pack_local(self, values):
        """``{site: value}`` -> ``(S, D)``: each site's plate axis first."""
        rows = [values[n].movedim(self._local_axes[n], 0) for n in sorted(values)]
        return torch.cat([r.reshape(r.shape[0], -1) for r in rows], -1)

    def _unpack_local(self, flat):
        """``(S, D)`` -> ``{site: value}`` with each plate axis in place."""
        rows = _unflatten_local_dict(flat, self._local_shapes)
        return {n: v.movedim(0, self._local_axes[n]) for n, v in rows.items()}

    def _get_posterior(self):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        if self.prototype_trace is None:
            self._setup_prototype(*args, **kwargs)
        global_latents, local_flat = self._sample_latent(*args, **kwargs)

        out = dict(global_latents)
        _, N, subsample_size = self._local_plate
        for name, unconstrained in self._unpack_local(local_flat).items():
            site = self.prototype_trace[name]
            push = _support_bijector(site)
            value = push(unconstrained)
            event_ndim = site["fn"].event_dim
            if get_mask() is False:
                correction = 0.0
            else:
                correction = -push.log_abs_det_jacobian(unconstrained, value)
                correction = (N / subsample_size) * sum_rightmost(
                    correction, correction.dim() - value.dim() + event_ndim)
            out[name] = sample(name, dist.Delta(value, log_density=correction,
                                                event_dim=event_ndim))
        return out

    @staticmethod
    def _register_trace_params(proto_trace):
        return {name: param(name, site["value"], **site["kwargs"])
                for name, site in proto_trace.items() if site["type"] == "param"}

    def _dais_fleet_params(self, idx, N, D, K):
        """The schedule parameters of the drawn rows: per datum (length-N
        ``param`` sites read at the rows), or shared and broadcast."""
        like = self._like
        if self.use_global_dais_params:
            rows = tuple(idx.shape)
            eta0 = param(self._pname("eta0"), like.new_tensor(self.eta_init),
                         constraint=constraints.interval(0, self.eta_max))
            eta_coeff = param(self._pname("eta_coeff"), like.new_tensor(0.0))
            gamma = param(self._pname("gamma"), like.new_tensor(self.gamma_init),
                          constraint=constraints.interval(0, 1))
            betas = param(self._pname("beta_increments"), like.new_ones(K),
                          constraint=constraints.positive)
            mass = param(self._pname("mass_matrix"), like.new_ones(D),
                         constraint=constraints.positive)
            eta0, eta_coeff, gamma = (torch.broadcast_to(v, rows) for v in (eta0, eta_coeff,
                                                                            gamma))
            betas = torch.broadcast_to(betas, rows + (K,))
            mass = torch.broadcast_to(mass, rows + (D,))
        else:
            eta0 = param(self._pname("eta0"), like.new_full((N,), self.eta_init),
                         constraint=constraints.interval(0, self.eta_max), event_dim=0)
            eta_coeff = param(self._pname("eta_coeff"), like.new_zeros(N), event_dim=0)
            gamma = param(self._pname("gamma"), like.new_full((N,), self.gamma_init),
                          constraint=constraints.interval(0, 1), event_dim=0)
            betas = param(self._pname("beta_increments"), like.new_ones((N, K)),
                          constraint=constraints.positive, event_dim=1)
            mass = param(self._pname("mass_matrix"), like.new_ones((N, D)),
                         constraint=constraints.positive, event_dim=1)
        return eta0, eta_coeff, gamma, _normalized_schedule(betas), mass

    def _sample_latent(self, *args, **kwargs):
        kwargs.pop("sample_shape", ())
        if self.global_guide is not None:
            global_latents = self.global_guide(*args, **kwargs)
            with handlers.block(), handlers.substitute(data=global_latents):
                global_outputs = self.global_guide.model(*args, **kwargs)
            local_args = (global_outputs,)
            local_kwargs = {}
        else:
            global_latents = {}
            local_args = args
            local_kwargs = kwargs.copy()

        local_guide_params = (self._register_trace_params(self._proto_local_guide_trace)
                              if self.local_guide is not None else {})
        local_model_params = self._register_trace_params(self._proto_local_model_trace)

        def local_log_density(x):
            latent = self._unpack_local(x)
            with handlers.block():
                return -infer_util.potential_energy(
                    functools.partial(_subsample_model, self.local_model), local_args,
                    local_kwargs, {**latent, **local_model_params})

        plate_name, N, subsample_size = self._local_plate
        D, K = self._local_latent_dim, self.K

        with plate(plate_name, N, subsample_size=subsample_size) as idx:
            eta0, eta_coeff, gamma, betas, mass = self._dais_fleet_params(idx, N, D, K)
            local_kwargs["_subsample_idx"] = {plate_name: idx}

            if self.local_guide is not None:
                subsample_guide = functools.partial(_subsample_model, self.local_guide)
                with handlers.block(), handlers.trace() as tr, handlers.substitute(
                        data=local_guide_params):
                    subsample_guide(*local_args, **local_kwargs)
                drawn = {name: _support_bijector(site).inv(site["value"])
                         for name, site in tr.items()
                         if site["type"] == "sample" and not site.get("is_observed", False)}
                z_0 = self._pack_local(drawn)

                def base_log_prob(z):
                    latent = self._unpack_local(z)
                    with handlers.block():
                        return -infer_util.potential_energy(
                            subsample_guide, local_args, local_kwargs,
                            {**local_guide_params, **latent}) / (N / subsample_size)

                # emitted under the plate, which broadcasts it over the rows:
                # divided by their count, so that the total is exact
                factor(self._pname("z_0_factor"), base_log_prob(z_0) / subsample_size)
            else:
                z_0_loc = param(self._pname("z_0_loc"), self._like.new_zeros((N, D)),
                                event_dim=1)
                z_0_scale = param(self._pname("z_0_scale"),
                                  self._like.new_full((N, D), self._init_scale),
                                  constraint=constraints.positive, event_dim=1)
                base_z_dist = dist.Normal(z_0_loc, z_0_scale).to_event(1)
                z_0 = sample(self._pname("z_0"), base_z_dist, infer={"is_auxiliary": True})

                def base_log_prob(x):
                    return base_z_dist.log_prob(x).sum()

            momentum = dist.Normal(0.0, mass).to_event(1)
            eps = sample(
                self._pname("momentum"),
                dist.Normal(0.0, mass[..., None]).expand((subsample_size, D, K))
                .to_event(2).mask(False),
                infer={"is_auxiliary": True},
            )
            z, log_factor = _dais_anneal(
                z_0, eps.movedim(-1, 0), betas.movedim(-1, 0), eta0=eta0, eta_coeff=eta_coeff,
                eta_max=self.eta_max, gamma=gamma, inv_mass=0.5 / mass,
                momentum_lp=momentum.log_prob, base_grad=torch.func.grad(base_log_prob),
                target_grad=lambda zh: (subsample_size / N)
                * torch.func.grad(local_log_density)(zh),
                widen=lambda v: v[:, None], log_factor_0=z_0.new_zeros(subsample_size),
            )
            factor(self._pname("local_dais_factor"), log_factor)
            return global_latents, z

    def sample_posterior(self, rng_key, params, *args, sample_shape=(), **kwargs):
        """Draws of the global latents and the annealed locals, one annealing
        run each, mapped with ``torch.func.vmap`` (``randomness="different"``)
        over the elements of ``sample_shape``."""

        def one_draw(_):
            global_latents, local_flat = handlers.substitute(
                handlers.seed(self._sample_latent, rng_key), data=params)(*args, **kwargs)
            out = dict(global_latents)
            for name, unconstrained in self._unpack_local(local_flat).items():
                out[name] = _support_bijector(self.prototype_trace[name])(unconstrained)
            return out

        sample_shape = tuple(sample_shape)
        if not sample_shape:
            return one_draw(None)
        n = math.prod(sample_shape)
        index = torch.arange(n, device=self._like.device)
        draws = torch.func.vmap(one_draw, randomness="different")(index)
        return {k: v.reshape(sample_shape + tuple(v.shape[1:])) for k, v in draws.items()}


class AutoBatchedMixin:
    """The batch and event split of guides batched over the leading
    ``batch_ndim`` dims of every latent site."""

    def __init__(self, *args, **kwargs):
        self._batch_shape = None
        self._event_shape = None
        self.batch_ndim = kwargs.pop("batch_ndim")
        super().__init__(*args, **kwargs)

    def _setup_prototype(self, *args, **kwargs):
        super()._setup_prototype(*args, **kwargs)
        batch_shape = None
        for site in self.prototype_trace.values():
            if site["type"] == "sample" and not site["is_observed"]:
                shape = tuple(site["value"].shape)
                if site["value"].dim() < self.batch_ndim + site["fn"].event_dim:
                    raise ValueError(
                        f"Expected {self.batch_ndim} batch dimensions, but site "
                        f"`{site['name']}` only has shape {shape}."
                    )
                shape = shape[: self.batch_ndim]
                if batch_shape is None:
                    batch_shape = shape
                elif shape != batch_shape:
                    raise ValueError("Encountered inconsistent batch shapes.")
        self._batch_shape = batch_shape
        batch_size = math.prod(self._batch_shape)
        if self.latent_dim % batch_size:
            raise RuntimeError(
                f"Incompatible batch shape {batch_shape} (size {batch_size}) and latent "
                f"dims {self.latent_dim}."
            )
        self._event_shape = (self.latent_dim // batch_size,)

    def _get_batched_posterior(self):
        raise NotImplementedError

    def _get_posterior(self):
        return dist.TransformedDistribution(
            self._get_batched_posterior(),
            ReshapeTransform((self.latent_dim,), self._batch_shape + self._event_shape),
        )

    def median(self, params):
        flat = params[self._pname("loc")].reshape((self.latent_dim,))
        return self._unpack_and_constrain(flat, params)


class AutoBatchedMultivariateNormal(AutoBatchedMixin, AutoContinuous):
    """One full-covariance Normal per element of the leading batch dims."""

    scale_tril_constraint = constraints.scaled_unit_lower_cholesky

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_uniform, init_scale=0.1,
                 batch_ndim=1):
        if init_scale <= 0:
            raise ValueError(f"Expected init_scale > 0. but got {init_scale}")
        self._init_scale = init_scale
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn, batch_ndim=batch_ndim)

    def _get_batched_posterior(self):
        grouped = self._init_latent.reshape(self._batch_shape + self._event_shape)
        loc = param(self._pname("loc"), grouped)
        eye = torch.eye(grouped.shape[-1], dtype=grouped.dtype, device=grouped.device)
        scale_tril = param(
            self._pname("scale_tril"),
            torch.broadcast_to(eye * self._init_scale, self._batch_shape + eye.shape).clone(),
            constraint=self.scale_tril_constraint,
        )
        return dist.MultivariateNormal(loc, scale_tril=scale_tril)


class AutoBatchedLowRankMultivariateNormal(AutoBatchedMixin, AutoContinuous):
    """One low-rank plus diagonal Normal per element of the leading batch
    dims (rank ``round(sqrt(event size))`` by default)."""

    scale_constraint = constraints.softplus_positive

    def __init__(self, model, *, prefix="auto", init_loc_fn=init_to_uniform, init_scale=0.1,
                 rank=None, batch_ndim=1):
        if init_scale <= 0:
            raise ValueError(f"Expected init_scale > 0. but got {init_scale}")
        self._init_scale = init_scale
        self.rank = rank
        super().__init__(model, prefix=prefix, init_loc_fn=init_loc_fn, batch_ndim=batch_ndim)

    def _get_batched_posterior(self):
        rank = int(round(self._event_shape[0] ** 0.5)) if self.rank is None else self.rank
        grouped = self._init_latent.reshape(self._batch_shape + self._event_shape)
        loc = param(self._pname("loc"), grouped)
        raw_factor = param(self._pname("cov_factor"),
                           grouped.new_zeros(self._batch_shape + self._event_shape + (rank,)))
        scale = param(self._pname("scale"), torch.full_like(grouped, self._init_scale),
                      constraint=self.scale_constraint)
        return dist.LowRankMultivariateNormal(loc, raw_factor * scale[..., None], scale.square())
