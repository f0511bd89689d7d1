"""The effectful ``cond``: one of two branches of model code, chosen by a
predicate, its sites recorded into the handlers around it (port of
``numpyro_tpu/contrib/control_flow/cond.py``).

Each branch runs under a ``block`` and a ``trace``, seeded with the
generator of the ``control_flow`` message and under the outer
``substitute``, ``condition`` and ``replay`` maps of its
``substitute_stack``; its sites are then replayed into the outer handlers.

* **A Python predicate** (``True``/``False``) runs its branch alone.

* **A tensor predicate** may be batched over the chains of a run under
  ``torch.func.vmap``, where an ``if`` on it raises, and reading it on the
  card would be a host sync.  So both branches run, as ``lax.cond`` does
  under ``vmap``, and the result is a select: the branches must declare the
  same sites, of the same types and distribution classes (the JAX package's
  contract), and each site's value, distribution parameters and
  intermediates are ``torch.where(pred, true_branch, false_branch)``, so
  that its value and its log density are those of the branch taken.  The
  returned value is selected the same way.

A ``replay`` map substitutes the recorded values of latent sample sites, as
it does in the port's ``scan`` (the JAX package hands the recorded site
itself to ``substitute``).  Enumeration raises, as in the JAX package.
"""

from __future__ import annotations

import functools
import types

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions.util import lazy_property
from numpyro_tpu_torch.primitives import _PYRO_STACK, apply_stack

__all__ = ["cond"]

# the site types replayed into the outer handlers (a branch's plates are not)
_CARRIED_TYPES = ("sample", "deterministic", "param")
# objects that are the same in both branches or differ, never selected into
_CODE_TYPES = (types.FunctionType, types.MethodType, types.BuiltinFunctionType,
               functools.partial, type)


def _resolve(subs_map, site):
    """A site's value in a dict, or from a callable map (seeded with the
    site's generator where it has one)."""
    if callable(subs_map) and not isinstance(subs_map, dict):
        if site["type"] == "deterministic":
            return subs_map(site)
        rng_key = site["kwargs"].get("rng_key")
        fn = subs_map if rng_key is None else handlers.seed(subs_map, rng_key)
        return fn(site)
    return subs_map.get(site["name"]) if isinstance(subs_map, dict) else None


def _run_branch(fn, operand, rng_key, substitute_stack):
    """One branch: blocked, seeded, under the outer maps; returns its value
    and the sites it recorded, ready to be replayed."""
    body = fn if rng_key is None else handlers.seed(fn, rng_key)
    for kind, subs_map in substitute_stack:
        if kind == "replay":
            subs_map = {
                name: site["value"] for name, site in subs_map.items()
                if site["type"] == "sample" and not site.get("is_observed", False)
                and site["value"] is not None
            }
        wrap = handlers.condition if kind == "condition" else handlers.substitute
        kwarg = "condition_fn" if kind == "condition" else "substitute_fn"
        body = wrap(body, **{kwarg: lambda site, m=subs_map: _resolve(m, site)})
    with handlers.block(), handlers.trace() as tr:
        value = body(operand)
    carried = {}
    for name, site in tr.items():
        if site["type"] not in _CARRIED_TYPES:
            continue
        site = {k: v for k, v in site.items() if k != "stop"}
        site["_control_flow_done"] = True
        if "rng_key" in site.get("kwargs", {}):
            site["kwargs"] = {**site["kwargs"], "rng_key": None}
        carried[name] = site
    return value, carried


def _mismatch(what):
    return TypeError(f"cond: true_fun and false_fun must have identical structure: {what}")


def _select(pred, a, b, where="output"):
    """``torch.where(pred, a, b)`` through tensors, containers and the
    fields of objects (distributions, transforms, constraints) of one
    class; anything else must be the same in both."""
    if a is b:
        return a
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            raise _mismatch(f"{where} is a tensor in one branch only")
        if a.shape != b.shape or a.dtype != b.dtype:
            raise _mismatch(f"{where} is {a.dtype}{tuple(a.shape)} against "
                            f"{b.dtype}{tuple(b.shape)}")
        return torch.where(pred, a, b)
    if type(a) is not type(b):
        raise _mismatch(f"{where} is a {type(a).__name__} against a {type(b).__name__}")
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise _mismatch(f"{where} has {len(a)} against {len(b)} entries")
        items = [_select(pred, x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b))]
        return type(a)(*items) if hasattr(a, "_fields") else type(a)(items)
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise _mismatch(f"{where} has the keys {sorted(a)} against {sorted(b)}")
        return {k: _select(pred, a[k], b[k], f"{where}[{k!r}]") for k in a}
    if hasattr(a, "__dict__") and not isinstance(a, _CODE_TYPES):
        cls = type(a)
        # a lazily computed field that one branch has not computed yet is
        # left out: the selected object computes it again from its fields
        keys = [k for k in a.__dict__ if k in b.__dict__]
        for k in set(a.__dict__) ^ set(b.__dict__):
            if not isinstance(getattr(cls, k, None), lazy_property):
                raise _mismatch(f"{where}.{k} is set in one branch only")
        fields = {k: _select(pred, a.__dict__[k], b.__dict__[k], f"{where}.{k}") for k in keys}
        if len(keys) == len(a.__dict__) and all(fields[k] is a.__dict__[k] for k in keys):
            return a
        new = object.__new__(cls)
        new.__dict__.update(fields)
        return new
    try:
        same = bool(a == b)
    except (TypeError, ValueError, RuntimeError):  # no single truth value
        same = False
    if not same:
        raise _mismatch(f"{where} is {a!r} against {b!r}")
    return a


def _select_traces(pred, trace_t, trace_f):
    if list(trace_t) != list(trace_f):
        raise _mismatch(f"the sites {list(trace_t)} against {list(trace_f)}")
    merged = {}
    for name, st in trace_t.items():
        sf = trace_f[name]
        if st["type"] != sf["type"]:
            raise _mismatch(f"site {name} is a {st['type']} against a {sf['type']}")
        site = dict(st)
        site["value"] = _select(pred, st["value"], sf["value"], f"site {name}'s value")
        if st["type"] == "sample":
            if type(st["fn"]) is not type(sf["fn"]):
                raise _mismatch(f"site {name} is a {type(st['fn']).__name__} against a "
                                f"{type(sf['fn']).__name__}")
            if st["is_observed"] != sf["is_observed"]:
                raise _mismatch(f"site {name} is observed in one branch only")
            site["fn"] = _select(pred, st["fn"], sf["fn"], f"site {name}'s distribution")
            site["intermediates"] = _select(pred, st.get("intermediates", []),
                                            sf.get("intermediates", []),
                                            f"site {name}'s intermediates")
            site["scale"] = _select(pred, st.get("scale"), sf.get("scale"),
                                    f"site {name}'s scale")
        merged[name] = site
    return merged


def cond_wrapper(pred, true_fun, false_fun, operand, rng_key=None, substitute_stack=None,
                 enum=False, first_available_dim=None):
    """Run the cond: ``(value, carried sites)``."""
    if enum:
        raise RuntimeError("The cond primitive does not support enumeration")
    substitute_stack = [] if substitute_stack is None else substitute_stack
    if not isinstance(pred, torch.Tensor):
        return _run_branch(true_fun if pred else false_fun, operand, rng_key, substitute_stack)
    if pred.dim() != 0:
        raise TypeError(f"Pred must be a scalar, got a tensor of shape {tuple(pred.shape)}")
    pred = pred.to(torch.bool)
    value_t, trace_t = _run_branch(true_fun, operand, rng_key, substitute_stack)
    value_f, trace_f = _run_branch(false_fun, operand, rng_key, substitute_stack)
    return _select(pred, value_t, value_f), _select_traces(pred, trace_t, trace_f)


def cond(pred, true_fun, false_fun, operand):
    """``true_fun(operand)`` if ``pred`` else ``false_fun(operand)``, either
    of which may call primitives; their sites are recorded into the
    handlers around.  Both branches must declare the same sites with the
    same distribution classes, and return values of one structure."""
    if not _PYRO_STACK:
        value, _ = cond_wrapper(pred, true_fun, false_fun, operand)
        return value
    msg = apply_stack({
        "type": "control_flow",
        "name": None,
        "fn": cond_wrapper,
        "args": (pred, true_fun, false_fun, operand),
        "kwargs": {"rng_key": None, "substitute_stack": []},
        "value": None,
    })
    value, carried = msg["value"]
    for site in carried.values():
        apply_stack(site)
    return value
