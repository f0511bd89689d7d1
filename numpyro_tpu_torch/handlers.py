"""Effect handlers (port of ``numpyro_tpu/handlers.py``: ``block``,
``collapse``, ``condition``, ``do``, ``infer_config``, ``lift``, ``mask``,
``replay``, ``reparam``, ``scale``, ``scope``, ``seed``, ``substitute`` and
``trace``).  A handler leaves every message type it does not know
(``plate``, ``subsample``, ``inspect``, ``_gibbs_state``,
``_subsample_panels``) as it found it.

A ``control_flow`` message (the effectful ``scan`` and ``cond``) carries a
``substitute_stack``: ``substitute``, ``condition`` and ``replay`` push their
data onto it, so that ``scan`` and ``cond`` apply them to their sites; ``seed``
and ``block`` hand it a generator.

Random state is an explicit ``torch.Generator``: ``seed`` hands its generator
to every stochastic site below it, and each draw advances it.  JAX's split
keys have no counterpart; the generator's device decides where draws land.

``scale`` rejects a nonpositive scale where the JAX package can read it: a
Python number, a numpy array or a CPU tensor that is not batched under
``vmap``.  A tensor on the card is not read (that would be a host sync each
time the model runs), so a nonpositive one there is not caught: a departure
listed in ROADMAP.md.

``collapse`` finds its placeholder by identity, as the JAX package does: a
distribution keeps a tensor parameter as the object it was given wherever
its batch shape needs no padding (``Distribution._init_broadcast``), also
under ``vmap`` beside batched parameters, which is where one prior meets
one draw.  Where it pads (a scalar prior broadcast over a batch of draws,
which would need the joint compound), neither package finds it, and both
raise that the prior was never consumed.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict

import numpy as np
import torch

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions.util import is_batched
from numpyro_tpu_torch.primitives import Messenger, apply_stack, prng_key

__all__ = [
    "block", "collapse", "condition", "do", "infer_config", "lift", "mask", "replay", "reparam",
    "scale", "scope", "seed", "substitute", "trace",
]


class trace(Messenger):
    """Record every site into an OrderedDict keyed by name."""

    def __enter__(self):
        super().__enter__()
        self.trace = OrderedDict()
        return self.trace

    def postprocess_message(self, msg):
        if msg.get("name") is None:
            return
        name = msg["name"]
        if msg["type"] in ("sample", "deterministic") and name in self.trace:
            raise AssertionError(
                f"all sites must have unique names but got `{name}` duplicated"
            )
        self.trace[name] = msg.copy()

    def get_trace(self, *args, **kwargs):
        self(*args, **kwargs)
        return self.trace


def _site_selector(hide_fn, hide, expose_types, expose):
    if hide_fn is not None:
        return hide_fn
    if hide is not None:
        return lambda msg: msg.get("name") in hide
    if expose_types is not None:
        return lambda msg: msg.get("type") not in expose_types
    if expose is not None:
        return lambda msg: msg.get("name") not in expose
    return lambda msg: True


class block(Messenger):
    """Hide selected sites from handlers above this one."""

    def __init__(self, fn=None, hide_fn=None, hide=None, expose_types=None, expose=None):
        self.hide_fn = _site_selector(hide_fn, hide, expose_types, expose)
        super().__init__(fn)

    def process_message(self, msg):
        # prng_key messages always propagate, so that a hidden site can still
        # draw from an outer seed
        if msg["type"] == "prng_key" or not self.hide_fn(msg):
            return
        msg["stop"] = True
        needs_key = (
            msg["type"] in ("sample", "plate", "control_flow")
            and msg.get("value") is None
            and msg.get("kwargs", {}).get("rng_key") is None
        )
        if needs_key:
            msg["kwargs"]["rng_key"] = prng_key()


class _ValueBinder(Messenger):
    """Shared machinery of ``condition`` and ``substitute``."""

    _tag = None  # the name it goes by on a control_flow substitute stack
    _site_types = ()

    def __init__(self, fn=None, data=None, lookup_fn=None):
        if (data is None) == (lookup_fn is None):
            raise ValueError(self._both_error)
        self.data = data
        self._lookup_fn = lookup_fn
        super().__init__(fn)

    def process_message(self, msg):
        if msg["type"] == "control_flow":
            source = self.data if self.data is not None else self._lookup_fn
            msg["kwargs"]["substitute_stack"].append((self._tag, source))
            return
        if msg["type"] not in self._site_types or msg.get("_control_flow_done", False):
            return
        bound = self.data.get(msg["name"]) if self.data is not None else self._lookup_fn(msg)
        if bound is not None:
            self._bind(msg, bound)

    def _bind(self, msg, value):
        raise NotImplementedError


class condition(_ValueBinder):
    """Fix the value of sample sites (they become observed)."""

    _tag = "condition"
    _site_types = ("sample",)
    _both_error = "Only one of `data` or `condition_fn` should be provided."

    def __init__(self, fn=None, data=None, condition_fn=None):
        super().__init__(fn, data=data, lookup_fn=condition_fn)

    def _bind(self, msg, value):
        msg["value"] = value
        msg["is_observed"] = True


class substitute(_ValueBinder):
    """Fix latent values (sites stay latent, unlike ``condition``)."""

    _tag = "substitute"
    _site_types = ("sample", "param", "mutable", "plate")
    _both_error = "Only one of `data` or `substitute_fn` should be provided."

    def __init__(self, fn=None, data=None, substitute_fn=None):
        super().__init__(fn, data=data, lookup_fn=substitute_fn)
        self.substitute_fn = substitute_fn

    def _bind(self, msg, value):
        msg["value"] = value
        if msg["type"] == "plate":
            # subsample indices given from outside
            msg["args"] = (msg["args"][0], value.shape[0])


class replay(Messenger):
    """Replay the values of a recorded trace at matching sample and param
    sites."""

    def __init__(self, fn=None, trace=None):
        if trace is None:
            raise ValueError("replay needs a trace")
        self.trace = trace
        super().__init__(fn)

    def process_message(self, msg):
        kind = msg["type"]
        if kind == "control_flow":
            msg["kwargs"]["substitute_stack"].append(("replay", self.trace))
            return
        if kind not in ("sample", "param"):
            return
        recorded = self.trace.get(msg["name"])
        if recorded is None:
            return
        if recorded["type"] != kind:
            raise RuntimeError(f"site {msg['name']} must be {kind} in trace")
        # the intermediates belong to the recorded fn, not to the replayed one
        msg["value"] = recorded["value"]


class mask(Messenger):
    """Multiply the masks of the sample sites below with ``mask``."""

    def __init__(self, fn=None, mask=True):
        if not isinstance(mask, bool) and mask.dtype != torch.bool:
            raise ValueError("`mask` should be a bool array.")
        self.mask = mask
        super().__init__(fn)

    def process_message(self, msg):
        if msg["type"] == "inspect":
            prior_mask = msg["mask"]
            msg["mask"] = self.mask if prior_mask is None else self.mask & prior_mask
        elif msg["type"] == "sample":
            msg["fn"] = msg["fn"].mask(self.mask)


class reparam(Messenger):
    """Apply the reparameterizers of ``config`` (a dict keyed by site name,
    or a callable from a site's message to a reparameterizer or ``None``) to
    sample sites; see ``infer/reparam.py``."""

    def __init__(self, fn=None, config=None):
        assert isinstance(config, dict) or callable(config)
        self.config = config
        super().__init__(fn)

    def process_message(self, msg):
        if msg["type"] != "sample":
            return
        if isinstance(self.config, dict):
            chosen = self.config.get(msg["name"])
        else:
            chosen = self.config(msg)
        if chosen is None:
            return
        new_fn, value = chosen(msg["name"], msg["fn"], msg["value"])
        if value is not None:
            if msg["value"] is None:
                msg["is_observed"] = True
            msg["value"] = value
        if new_fn is None:
            # the reparameterizer consumed the site: it becomes a
            # deterministic record of the recomposed value
            msg["type"] = "deterministic"
            keep = ("type", "name", "value", "cond_indep_stack")
            for key in [k for k in msg if k not in keep]:
                del msg[key]
        else:
            msg["fn"] = new_fn


class infer_config(Messenger):
    """Update the ``infer`` dict of sample and param sites with what
    ``config_fn(msg)`` returns."""

    def __init__(self, fn=None, config_fn=None):
        super().__init__(fn)
        self.config_fn = config_fn

    def process_message(self, msg):
        if msg["type"] in ("sample", "param"):
            msg["infer"] = {**msg.get("infer", {}), **self.config_fn(msg)}


class seed(Messenger):
    """Give every unobserved sample site and every plate that draws its
    subsample below this handler the generator ``rng_seed`` (a
    ``torch.Generator``, or an int seeding a CPU one).  A draw source (an
    object with ``normals``, ``distributions.util.standard_draw``) is
    handed on as it is, for samplers that draw through it."""

    def __init__(self, fn=None, rng_seed=None, hide_types=None):
        if isinstance(rng_seed, int):
            rng_seed = torch.Generator().manual_seed(rng_seed)
        if not isinstance(rng_seed, torch.Generator) and not hasattr(rng_seed, "normals"):
            raise TypeError(
                "Incorrect type for rng_seed: expected int or torch.Generator, "
                f"got {type(rng_seed)}"
            )
        self.rng_key = rng_seed
        self.hide_types = [] if hide_types is None else hide_types
        super().__init__(fn)

    def process_message(self, msg):
        if msg["type"] in self.hide_types or msg["type"] not in (
            "sample", "prng_key", "plate", "control_flow"
        ):
            return
        if msg["type"] == "sample" and msg["is_observed"]:
            return
        if msg["value"] is not None:
            return
        if msg["kwargs"]["rng_key"] is None:
            msg["kwargs"]["rng_key"] = self.rng_key


class collapse(Messenger):
    """Collapse a conjugate prior into the one likelihood draw that takes it:
    the prior site inside the block is not recorded and yields a NaN
    placeholder, which must be given unchanged as the parameter of exactly
    one later sample site; that site is scored under the compound marginal:

    - ``Beta`` with ``Bernoulli`` or ``Binomial`` (``probs``): ``BetaBinomial``
    - ``Gamma`` with ``Poisson`` (``rate``): ``GammaPoisson``
    - ``Dirichlet`` with ``Multinomial`` (``DirichletMultinomial``) or
      ``Categorical`` (the prior's mean)
    - ``Normal`` with ``Normal`` (``loc``): ``Normal`` with the scales pooled

    A prior left unused, or taken by a second draw, raises."""

    _COLLAPSIBLE_PRIORS = ("Beta", "Gamma", "Dirichlet", "Normal")

    def __enter__(self):
        # id(placeholder) -> its record, which holds the placeholder itself so
        # that its id cannot pass to another tensor; a lookup checks identity
        self._lazy = {}
        return super().__enter__()

    def __exit__(self, exc_type, exc_value, tb):
        if exc_type is None:
            unused = [rec["name"] for rec in self._lazy.values() if not rec["used"]]
            if unused:
                raise RuntimeError(
                    f"collapse: sites {unused} were collapsed but never consumed by a "
                    "downstream conjugate likelihood"
                )
        return super().__exit__(exc_type, exc_value, tb)

    def _find_placeholder(self, value):
        rec = self._lazy.get(id(value))
        return rec if rec is not None and rec["placeholder"] is value else None

    def process_message(self, msg):
        if msg["type"] != "sample":
            return
        fn = msg["fn"]
        base = fn
        while isinstance(base, (dist.ExpandedDistribution, dist.Independent)):
            base = base.base_dist
        if not msg["is_observed"] and msg["value"] is None:
            if type(base).__name__ in self._COLLAPSIBLE_PRIORS:
                like = next(v for v in vars(base).values()
                            if isinstance(v, torch.Tensor) and v.is_floating_point())
                placeholder = torch.full(fn.shape(), torch.nan, dtype=like.dtype,
                                         device=like.device)
                self._lazy[id(placeholder)] = {
                    "placeholder": placeholder, "name": msg["name"], "fn": base,
                    "used": False,
                }
                msg["value"] = placeholder
                msg["stop"] = True
                msg["type"] = "collapsed"
            return
        rewritten = self._rewrite(base)
        if rewritten is not None:
            msg["fn"] = rewritten

    def _claim(self, rec, expected_prior):
        if type(rec["fn"]).__name__ != expected_prior:
            raise NotImplementedError(
                f"collapse: no conjugacy rule for prior {type(rec['fn']).__name__} at site "
                f"{rec['name']}"
            )
        if rec["used"]:
            raise NotImplementedError(
                f"collapse: site {rec['name']} consumed by more than one likelihood draw; a "
                "shared collapsed prior needs the joint compound: use BetaBinomial, "
                "GammaPoisson or DirichletMultinomial explicitly"
            )
        rec["used"] = True
        return rec["fn"]

    def _rewrite(self, base):
        kind = type(base).__name__
        if kind in ("Bernoulli", "BernoulliProbs", "Binomial", "BinomialProbs"):
            rec = self._find_placeholder(getattr(base, "probs", None))
            if rec is None:
                return None
            prior = self._claim(rec, "Beta")
            return dist.BetaBinomial(prior.concentration1, prior.concentration0,
                                     getattr(base, "total_count", 1))
        if kind == "Poisson":
            rec = self._find_placeholder(base.rate)
            if rec is None:
                return None
            prior = self._claim(rec, "Gamma")
            return dist.GammaPoisson(prior.concentration, prior.rate)
        if kind in ("Multinomial", "MultinomialProbs", "Categorical", "CategoricalProbs"):
            rec = self._find_placeholder(getattr(base, "probs", None))
            if rec is None:
                return None
            conc = self._claim(rec, "Dirichlet").concentration
            if kind in ("Categorical", "CategoricalProbs"):
                return dist.Categorical(probs=conc / conc.sum(-1, keepdim=True))
            return dist.DirichletMultinomial(conc, base.total_count)
        if kind == "Normal":
            rec = self._find_placeholder(base.loc)
            if rec is None:
                return None
            prior = self._claim(rec, "Normal")
            pooled_sd = torch.sqrt(prior.scale.square() + base.scale.square())
            return dist.Normal(prior.loc, pooled_sd)
        return None


class lift(Messenger):
    """Turn ``param`` sites into sample sites under ``prior``: a dict from
    site name to distribution, one distribution for every site, or a
    callable from the name to a distribution (or ``None``).  A param named
    twice in one run takes one draw."""

    def __init__(self, fn=None, prior=None):
        assert prior is not None
        self.prior = prior
        self._samples_cache = {}
        super().__init__(fn)

    def __enter__(self):
        self._samples_cache = {}
        return super().__enter__()

    def __exit__(self, *args, **kwargs):
        self._samples_cache = {}
        return super().__exit__(*args, **kwargs)

    def _prior_for(self, name):
        if isinstance(self.prior, dict):
            return self.prior.get(name)
        if isinstance(self.prior, dist.Distribution):
            return self.prior
        return self.prior(name) if callable(self.prior) else None

    def process_message(self, msg):
        if msg["type"] != "param":
            return
        name = msg["name"]
        prior = self._prior_for(name)
        if prior is None:
            return
        cached = self._samples_cache.get(name)
        msg.update(
            type="sample",
            fn=prior,
            intermediates=[],
            is_observed=False,
            infer=msg.get("infer", {}),
            kwargs={"rng_key": None, "sample_shape": ()},
            args=(),
            # the cached message is the first one, whose value apply_stack has
            # filled in by the time a second param of the name comes
            value=cached["value"] if cached is not None else None,
        )
        if cached is None:
            self._samples_cache[name] = msg


class scale(Messenger):
    """Multiply the log densities of the sites below by ``scale`` (a positive
    number or tensor), on top of any earlier scale."""

    def __init__(self, fn=None, scale=1.0):
        if isinstance(scale, torch.Tensor):
            readable = scale.device.type == "cpu" and not is_batched(scale)
            if readable and bool((scale <= 0).any()):
                raise ValueError("'scale' argument should be positive.")
        elif np.any(np.less_equal(scale, 0)):
            raise ValueError("'scale' argument should be positive.")
        self.scale = scale
        super().__init__(fn)

    def process_message(self, msg):
        if msg["type"] not in ("param", "sample", "plate"):
            return
        existing = msg.get("scale")
        msg["scale"] = self.scale if existing is None else self.scale * existing


class scope(Messenger):
    """Prefix the names of the sites below, and of their plates, with
    ``prefix + divider``; a site of a type in ``hide_types`` keeps its
    name."""

    def __init__(self, fn=None, prefix="", divider="/", *, hide_types=None):
        self.prefix = prefix
        self.divider = divider
        self.hide_types = [] if hide_types is None else hide_types
        super().__init__(fn)

    def _rename(self, name):
        return f"{self.prefix}{self.divider}{name}"

    def process_message(self, msg):
        if not msg.get("name") or msg["type"] in self.hide_types:
            return
        if "cond_indep_stack" in msg:
            msg["cond_indep_stack"] = [
                frame._replace(name=self._rename(frame.name))
                for frame in msg["cond_indep_stack"]
            ]
        msg["name"] = self._rename(msg["name"])


class do(Messenger):
    """Intervene on the sample sites named in ``data``: the site is drawn as
    usual under its own name, and the sites below it see the intervention
    value, recorded as the observed site ``{name}__CF``."""

    def __init__(self, fn=None, data=None):
        self.data = data
        self._intervener_id = str(id(self))
        super().__init__(fn)

    def process_message(self, msg):
        if msg["type"] != "sample":
            return
        already_mine = msg.get("_intervener_id", None) == self._intervener_id
        if msg.get("_do_counterfactual", False):
            # a counterfactual copy is never intervened on again: without this
            # guard two `do`s naming one site would re-dispatch each other's
            # copies without end.  A second intervener meeting another's copy
            # is a double intervention, which is warned about
            if not already_mine and self.data.get(msg["name"]) is not None:
                warnings.warn(
                    f"Attempting to intervene on variable {msg['name']} multiple times, "
                    "this is almost certainly incorrect behavior",
                    RuntimeWarning,
                    stacklevel=2,
                )
            return
        if already_mine or self.data.get(msg["name"]) is None:
            return
        msg["_intervener_id"] = self._intervener_id
        counterfactual = msg.copy()
        counterfactual["_do_counterfactual"] = True
        counterfactual["cond_indep_stack"] = list(counterfactual["cond_indep_stack"])
        apply_stack(counterfactual)
        intervention = self.data[msg["name"]]
        msg["name"] = msg["name"] + "__CF"
        msg["value"] = intervention
        msg["is_observed"] = True
        msg["stop"] = True
