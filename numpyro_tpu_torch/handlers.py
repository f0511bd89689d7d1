"""Effect handlers (port of ``trace``, ``seed``, ``substitute``, ``condition``,
``block``, ``mask``, ``replay``, ``reparam`` and ``infer_config`` from
``numpyro_tpu/handlers.py``; the rest are listed in ROADMAP.md).  A handler leaves every message type it does not know
(``plate``, ``subsample``, ``inspect``, ``_gibbs_state``,
``_subsample_panels``) as it found it.

A ``control_flow`` message (the effectful ``scan``) carries a
``substitute_stack``: ``substitute``, ``condition`` and ``replay`` push their
data onto it, so that the scan applies them to each step's sites; ``seed``
and ``block`` hand it a generator.

Random state is an explicit ``torch.Generator``: ``seed`` hands its generator
to every stochastic site below it, and each draw advances it.  JAX's split
keys have no counterpart; the generator's device decides where draws land.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from numpyro_tpu_torch.primitives import Messenger, prng_key

__all__ = [
    "block", "condition", "infer_config", "mask", "replay", "reparam", "seed", "substitute",
    "trace",
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
    ``torch.Generator``, or an int seeding a CPU one)."""

    def __init__(self, fn=None, rng_seed=None, hide_types=None):
        if isinstance(rng_seed, int):
            rng_seed = torch.Generator().manual_seed(rng_seed)
        if not isinstance(rng_seed, torch.Generator):
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
