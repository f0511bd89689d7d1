"""ELBO objectives for SVI (port of ``Trace_ELBO``, ``TraceMeanField_ELBO``,
``RenyiELBO`` and ``TraceEnum_ELBO`` from ``numpyro_tpu/infer/elbo.py``).

The particle dispatch and the mutable-state bookkeeping live once on the
base class; each objective implements ``_particle_elbo``.  Random state is
the SVI step's ``torch.Generator``: guide and model draw from it in turn.

Particles: ``vectorize_particles=True`` maps one particle's ELBO over the
particle axis with ``torch.func.vmap(..., randomness="different")``, so
every draw inside gives a different row per particle and every batched op,
the GLM kernel's ``vmap`` rule included, sees all particles at once (one
launch per ELBO evaluation).  ``False`` is a Python loop over particles; a
callable is applied as given, to the one-particle function and then to the
particle indices ``torch.arange(num_particles)``.

``TraceEnum_ELBO`` sums the model's enumerable discrete sites out of its
log density (``contrib.enum``); a guide with an enumerated site raises.
``TraceGraph_ELBO`` finds the costs downstream of each non-reparameterised
guide site with ``ops.provenance``, once per loss call.
"""

from __future__ import annotations

import math
from collections import defaultdict
from functools import partial

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib import enum as contrib_enum
from numpyro_tpu_torch.distributions.kl import kl_divergence
from numpyro_tpu_torch.infer.util import (
    _without_rsample_stop_gradient,
    get_importance_trace,
    log_density,
)
from numpyro_tpu_torch.ops.provenance import eval_provenance

__all__ = [
    "ELBO",
    "MultiFrameTensor",
    "RenyiELBO",
    "TraceEnum_ELBO",
    "TraceGraph_ELBO",
    "TraceMeanField_ELBO",
    "Trace_ELBO",
    "get_importance_log_probs",
    "get_nonreparam_deps",
]


def _sites_of_type(trace, site_type):
    return {name: site["value"] for name, site in trace.items() if site["type"] == site_type}


def check_model_guide_match(model_trace, guide_trace):
    """Each latent site of the guide must have the model's shape."""
    for name, site in guide_trace.items():
        if site["type"] == "sample" and not site.get("is_observed", False):
            if name in model_trace and model_trace[name]["type"] == "sample":
                guide_shape = tuple(site["value"].shape)
                model_shape = tuple(model_trace[name]["value"].shape)
                if guide_shape != model_shape:
                    raise ValueError(
                        f"Model and guide shapes disagree at site: '{name}': "
                        f"{model_shape} vs {guide_shape}"
                    )


def _loop(fn):
    return lambda particles: torch.stack([fn(i) for i in particles])


def _vmap(fn):
    return torch.func.vmap(fn, randomness="different")


def _scaled_sum(lp, scale):
    return (lp if scale is None else scale * lp).sum()


class ELBO:
    """Base class: one particle's ELBO, averaged over ``num_particles``."""

    can_infer_discrete = False

    def __init__(self, num_particles=1, vectorize_particles=True):
        self.num_particles = num_particles
        self.vectorize_particles = vectorize_particles

    def _assign_particle_fn(self):
        if callable(self.vectorize_particles):
            return self.vectorize_particles
        if self.vectorize_particles is True:
            return _vmap
        if self.vectorize_particles is False:
            return _loop
        raise ValueError("vectorize_particles must be True, False, or a callable")

    def loss(self, rng_key, param_map, model, guide, *args, **kwargs):
        return self.loss_with_mutable_state(rng_key, param_map, model, guide, *args, **kwargs)[
            "loss"
        ]

    def _particle_elbo(self, rng_key, param_map, model, guide, args, kwargs):
        """One Monte Carlo particle: ``(elbo, mutable_state or None)``."""
        raise NotImplementedError

    def loss_with_mutable_state(self, rng_key, param_map, model, guide, *args, **kwargs):
        return self._particle_mean(self._particle_elbo, rng_key, param_map, model, guide, args,
                                   kwargs)

    def _particle_mean(self, particle_elbo, rng_key, param_map, model, guide, args, kwargs):
        """The loss (minus the ELBO averaged over ``num_particles``) and the
        mutable state of ``particle_elbo`` (one particle's ELBO)."""
        one = partial(
            particle_elbo, rng_key, param_map=param_map, model=model, guide=guide,
            args=args, kwargs=kwargs,
        )
        if self.num_particles == 1:
            elbo, mutable_state = one()
            return {"loss": -elbo, "mutable_state": mutable_state}
        particles = torch.arange(self.num_particles, device=rng_key.device)
        elbos = self._assign_particle_fn()(lambda i: one()[0])(particles)
        return {"loss": -elbos.mean(), "mutable_state": None}

    def _wrap_mutable(self, elbo, mutable_params):
        """Mutable state is defined for one particle only."""
        if not mutable_params:
            return elbo, None
        if self.num_particles != 1:
            raise ValueError("mutable state is currently not supported for multi-particle ELBO")
        return elbo, mutable_params


class Trace_ELBO(ELBO):
    """Monte Carlo ELBO from the joint guide and model traces; fully
    differentiable where every guide site is reparameterised."""

    def _particle_elbo(self, rng_key, param_map, model, guide, args, kwargs):
        guide_ld, guide_trace = log_density(
            handlers.seed(guide, rng_key), args, kwargs, param_map
        )
        mutable_params = _sites_of_type(guide_trace, "mutable")
        replayed = handlers.replay(handlers.seed(model, rng_key), guide_trace)
        model_ld, model_trace = log_density(
            replayed, args, kwargs, {**param_map, **mutable_params}
        )
        check_model_guide_match(model_trace, guide_trace)
        mutable_params.update(_sites_of_type(model_trace, "mutable"))
        return self._wrap_mutable(model_ld - guide_ld, mutable_params)


class TraceMeanField_ELBO(ELBO):
    """The analytic KL term where a pair is registered, a Monte Carlo term
    elsewhere; assumes a mean-field dependency structure.  A guide sample
    site that the model does not have (an auxiliary site, such as the packed
    latent of ``AutoContinuous``) contributes ``-log q``."""

    @staticmethod
    def _site_term(model_site, guide_site):
        """Contribution of one latent site: -KL(q || p), analytic when known."""
        try:
            kl_qp = kl_divergence(guide_site["fn"], model_site["fn"])
        except NotImplementedError:
            p_lp = model_site["fn"].log_prob(model_site["value"])
            q_lp = guide_site["fn"].log_prob(guide_site["value"])
            return _scaled_sum(p_lp, model_site["scale"]) - _scaled_sum(q_lp, guide_site["scale"])
        return -_scaled_sum(kl_qp, guide_site["scale"])

    def _particle_elbo(self, rng_key, param_map, model, guide, args, kwargs):
        seeded_guide = handlers.substitute(handlers.seed(guide, rng_key), data=param_map)
        with _without_rsample_stop_gradient():
            guide_trace = handlers.trace(seeded_guide).get_trace(*args, **kwargs)
        mutable_params = _sites_of_type(guide_trace, "mutable")
        seeded_model = handlers.substitute(
            handlers.replay(handlers.seed(model, rng_key), guide_trace),
            data={**param_map, **mutable_params},
        )
        model_trace = handlers.trace(seeded_model).get_trace(*args, **kwargs)
        mutable_params.update(_sites_of_type(model_trace, "mutable"))
        check_model_guide_match(model_trace, guide_trace)

        elbo = 0.0
        for name, model_site in model_trace.items():
            if model_site["type"] != "sample":
                continue
            if model_site["is_observed"]:
                obs_lp = model_site["fn"].log_prob(model_site["value"])
                elbo = elbo + _scaled_sum(obs_lp, model_site["scale"])
            else:
                elbo = elbo + self._site_term(model_site, guide_trace[name])
        for name, guide_site in guide_trace.items():
            if guide_site["type"] == "sample" and name not in model_trace:
                q_lp = guide_site["fn"].log_prob(guide_site["value"])
                elbo = elbo - _scaled_sum(q_lp, guide_site["scale"])
        return self._wrap_mutable(elbo, mutable_params)


class RenyiELBO(ELBO):
    """Renyi alpha-divergence bound; its particles are vectorized (the
    ``vectorize_particles`` attribute, ``True`` here, decides as for the
    other objectives)."""

    def __init__(self, alpha=0.0, num_particles=2):
        if alpha == 1:
            raise ValueError("The order alpha should not be equal to 1. Please use Trace_ELBO.")
        self.alpha = alpha
        super().__init__(num_particles=num_particles)

    def _log_weight(self, rng_key, param_map, model, guide, args, kwargs):
        guide_ld, guide_trace = log_density(
            handlers.seed(guide, rng_key), args, kwargs, param_map
        )
        replayed = handlers.replay(handlers.seed(model, rng_key), guide_trace)
        model_ld, _ = log_density(replayed, args, kwargs, param_map)
        return model_ld - guide_ld

    def loss_with_mutable_state(self, rng_key, param_map, model, guide, *args, **kwargs):
        particles = torch.arange(self.num_particles, device=rng_key.device)
        log_w = self._assign_particle_fn()(
            lambda i: self._log_weight(rng_key, param_map, model, guide, args, kwargs)
        )(particles)
        tempered = (1.0 - self.alpha) * log_w
        log_mean = torch.logsumexp(tempered, 0) - math.log(self.num_particles)
        weights = torch.exp(tempered - log_mean)
        renyi_bound = log_mean / (1.0 - self.alpha)
        inner = torch.dot(weights.detach(), log_w) / self.num_particles
        loss = -((renyi_bound - inner).detach() + inner)
        return {"loss": loss, "mutable_state": None}


class TraceEnum_ELBO(ELBO):
    """The ELBO with the model's discrete latent sites of finite support that
    the guide does not sample summed out exactly (``contrib.enum``); the
    continuous latents come from the guide as usual.  ``max_plate_nesting``
    defaults to the deepest plate of the guide and of a probe run of the
    model; the probe runs once for each model and guide, where the JAX
    package runs it in every traced step (give ``max_plate_nesting`` where
    the plates change with the arguments).

    A guide with a site marked ``infer={"enumerate": "parallel"}`` raises:
    the JAX package's guide-side enumeration sums the model's enumerated
    dims at the end, not in site order, so under ``markov`` it returns a
    wrong ELBO without a warning (ROADMAP.md, Queue 3)."""

    can_infer_discrete = True

    def __init__(self, num_particles=1, vectorize_particles=True, max_plate_nesting=None):
        self.max_plate_nesting = max_plate_nesting
        self._probed = {}  # (model, guide) -> the plate depth a probe found
        super().__init__(num_particles, vectorize_particles)

    @staticmethod
    def _plate_depth(*traces):
        dims = [
            frame.dim
            for trace in traces
            for site in trace.values()
            if site["type"] == "sample"
            for frame in site["cond_indep_stack"]
            if frame.dim is not None
        ]
        return -min(dims) if dims else 0

    @staticmethod
    def _guide_enum_sites(guide_trace):
        return [
            name
            for name, site in guide_trace.items()
            if site["type"] == "sample"
            and not site.get("is_observed", False)
            and site.get("infer", {}).get("enumerate") == "parallel"
            and site["fn"].has_enumerate_support
        ]

    def _particle_elbo(self, rng_key, param_map, model, guide, args, kwargs):
        guide_ld, guide_trace = log_density(
            handlers.seed(guide, rng_key), args, kwargs, param_map
        )
        enumerated = self._guide_enum_sites(guide_trace)
        if enumerated:
            raise NotImplementedError(
                f"TraceEnum_ELBO with a guide that enumerates {enumerated} is not ported to "
                "numpyro_tpu_torch: the JAX package's guide-side enumeration ignores markov "
                "dim recycling and returns a wrong ELBO (see ROADMAP.md)"
            )
        mutable_params = _sites_of_type(guide_trace, "mutable")
        params = {**param_map, **mutable_params}
        max_plate_nesting = self.max_plate_nesting
        if max_plate_nesting is None:
            key = (model, guide)
            if key not in self._probed:
                # a probe run of the model finds its plates too
                probe = handlers.trace(
                    handlers.substitute(handlers.seed(model, rng_key), data=params)
                ).get_trace(*args, **kwargs)
                self._probed[key] = self._plate_depth(guide_trace, probe)
            max_plate_nesting = self._probed[key]
        enum_model = contrib_enum.enum(
            contrib_enum.config_enumerate(handlers.seed(model, rng_key)),
            first_available_dim=-1 - max_plate_nesting,
        )
        model_ld, model_trace = contrib_enum.log_density(
            handlers.replay(enum_model, guide_trace), args, kwargs, params
        )
        mutable_params.update(_sites_of_type(model_trace, "mutable"))
        return self._wrap_mutable(model_ld - guide_ld, mutable_params)


class MultiFrameTensor(dict):
    """Sums of tensors that live in different plate contexts, keyed by their
    frames; ``sum_to`` reduces every entry onto a target
    ``cond_indep_stack``."""

    def __init__(self, *items):
        super().__init__()
        self.add(*items)

    def add(self, *items):
        for cond_indep_stack, value in items:
            frames = frozenset(cond_indep_stack)
            assert all(f.dim < 0 and -value.dim() <= f.dim for f in frames)
            self[frames] = self[frames] + value if frames in self else value

    def sum_to(self, target_frames):
        total = None
        for frames, value in self.items():
            for f in frames:
                if f not in target_frames and value.shape[f.dim] != 1:
                    value = value.sum(f.dim, keepdim=True)
            while value.dim() and value.shape[0] == 1:
                value = value.squeeze(0)
            total = value if total is None else total + value
        return 0.0 if total is None else total


def get_importance_log_probs(model, guide, args, kwargs, params):
    """The log-probs of the guide's sample sites and of the model's,
    replayed against the guide, by site name."""
    model_tr, guide_tr = get_importance_trace(model, guide, args, kwargs, params)

    def log_probs(trace):
        return {n: s["log_prob"] for n, s in trace.items() if s["type"] == "sample"}

    return log_probs(model_tr), log_probs(guide_tr)


def _substitute_nonreparam(data, msg):
    """The given value of a site that has no reparameterised sampler, made
    to depend on the site's parameters as a draw of it does."""
    if msg["name"] in data and not msg["fn"].has_rsample:
        drawn = msg["fn"](*msg["args"], **msg["kwargs"])
        return 0 * drawn + data[msg["name"]]


def _seed0(fn, device):
    return handlers.seed(fn, torch.Generator(device=device).manual_seed(0))


def _get_latents(model, guide, args, kwargs, params, device):
    """One particle's latent values (of the guide and the model), drawn from
    a generator of seed 0 on ``device``."""
    guide_tr = handlers.trace(
        handlers.substitute(_seed0(guide, device), data=params)
    ).get_trace(*args, **kwargs)
    model_tr = handlers.trace(
        handlers.replay(handlers.substitute(_seed0(model, device), data=params), guide_tr)
    ).get_trace(*args, **kwargs)
    model_tr.update(guide_tr)
    return {
        name: site["value"]
        for name, site in model_tr.items()
        if site["type"] == "sample" and not site.get("is_observed", False)
    }


def get_nonreparam_deps(model, guide, args, kwargs, param_map, latents=None, device=None):
    """Which latent sites without a reparameterised sampler each log-prob
    of the model and of the guide depends on: ``(model_deps, guide_deps)``,
    dicts of ``frozenset``s by site name (``ops.provenance``).  ``latents``
    (one particle's values, by default drawn from seed 0 on ``device``) only
    give the pass its shapes: the dependencies are the same for every
    particle."""
    param_map = {k: v.detach() for k, v in param_map.items()}
    if latents is None:
        latents = _get_latents(model, guide, args, kwargs, param_map, device)
    latents = {k: v.detach() for k, v in latents.items()}
    if latents:
        device = next(iter(latents.values())).device

    def fn(**latents):
        subs_fn = partial(_substitute_nonreparam, latents)
        subs_model = handlers.substitute(_seed0(model, device), substitute_fn=subs_fn)
        subs_guide = handlers.substitute(_seed0(guide, device), substitute_fn=subs_fn)
        return get_importance_log_probs(subs_model, subs_guide, args, kwargs, param_map)

    return eval_provenance(fn, **latents)


class TraceGraph_ELBO(ELBO):
    """The ELBO with score-function terms for guide sites without a
    reparameterised sampler (Schulman et al., "Gradient Estimation Using
    Stochastic Computation Graphs"): each such site's score is weighted by
    the costs downstream of it only, found by provenance tracking and summed
    onto the site's plates (Rao-Blackwellization).

    The provenance pass runs once per loss call, on one particle's latents
    and outside the particle map (a tensor subclass inside ``vmap`` is
    fragile): the dependencies are structural and the same for every
    particle, where the JAX package finds them inside each particle
    (ROADMAP.md, Queue 3)."""

    can_infer_discrete = True

    def loss_with_mutable_state(self, rng_key, param_map, model, guide, *args, **kwargs):
        deps = get_nonreparam_deps(model, guide, args, kwargs, param_map,
                                   device=rng_key.device)
        return self._particle_mean(partial(self._particle_elbo, deps=deps), rng_key, param_map,
                                   model, guide, args, kwargs)

    def _particle_elbo(self, rng_key, param_map, model, guide, args, kwargs, deps):
        model_deps, guide_deps = deps
        model_trace, guide_trace = get_importance_trace(
            handlers.seed(model, rng_key), handlers.seed(guide, rng_key), args, kwargs, param_map
        )
        elbo = 0.0
        # the costs downstream of each non-reparameterised site
        downstream_costs = defaultdict(MultiFrameTensor)
        for name, site in model_trace.items():
            if site["type"] != "sample":
                continue
            elbo = elbo + site["log_prob"].sum()
            for key in model_deps[name]:
                downstream_costs[key].add((site["cond_indep_stack"], site["log_prob"]))
        for name, site in guide_trace.items():
            if site["type"] != "sample":
                continue
            q_lp_sum = site["log_prob"].sum()
            if not site["fn"].has_rsample:
                q_lp_sum = q_lp_sum.detach()
            elbo = elbo - q_lp_sum
            for key in guide_deps[name]:
                downstream_costs[key].add((site["cond_indep_stack"], -site["log_prob"]))
        for node, cost in downstream_costs.items():
            guide_site = guide_trace[node]
            reduced = cost.sum_to(guide_site["cond_indep_stack"])
            surrogate = (guide_site["log_prob"] * torch.as_tensor(reduced).detach()).sum()
            elbo = elbo + surrogate - surrogate.detach()
        return elbo, None
