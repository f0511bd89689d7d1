"""Automatic guides for SVI (port of ``AutoGuide``, ``AutoGuideList``,
``AutoNormal``, ``AutoDelta``, ``AutoContinuous``, ``AutoDiagonalNormal``,
``AutoMultivariateNormal``, ``AutoLowRankMultivariateNormal`` and
``AutoLaplaceApproximation`` from ``numpyro_tpu/infer/autoguide.py``; the
other guides are listed in ROADMAP.md).

A guide traces its model once (the prototype), recreates the model's plates
with their subsample sizes, and declares its parameters with ``param``.  The
packed guides flatten the unconstrained latent sites into one ``(D,)``
vector in sorted-name order, as ``jax.flatten_util.ravel_pytree`` orders a
dict, so the packed parameters of both packages line up element for element.

One departure from the JAX package: there ``AutoContinuous`` samples its
packed latent from ``posterior.mask(False)``, which drops ``log q`` from the
guide's density (the ELBO then has no entropy term and the scales collapse
towards zero).  Here the packed latent is an auxiliary site with its full log
density, as in NumPyro (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from contextlib import ExitStack

import torch

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.transforms import (
    AffineTransform,
    IndependentTransform,
    LowerCholeskyAffine,
    UnpackTransform,
    biject_to,
)
from numpyro_tpu_torch.distributions.util import sum_rightmost
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import FlatLayout
from numpyro_tpu_torch.infer.initialization import init_to_median, init_to_uniform
from numpyro_tpu_torch.primitives import get_mask, param, plate, prng_key, sample

__all__ = [
    "AutoContinuous",
    "AutoDelta",
    "AutoDiagonalNormal",
    "AutoGuide",
    "AutoGuideList",
    "AutoLaplaceApproximation",
    "AutoLowRankMultivariateNormal",
    "AutoMultivariateNormal",
    "AutoNormal",
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
