"""Posterior draws or the joint mode of enumerated discrete sites (port of
``numpyro_tpu/contrib/enum/discrete.py``: ``infer_discrete``).

A forward pass sums out each enumerated variable in the order of the
density (a dim that markov recycles retires its previous occupant, as in
``infer_util.log_density``) and keeps the factor it summed; a backward pass
draws each variable from its conditional (``temperature=1``) or takes its
argmax under max-product (``temperature=0``, the Viterbi path), with every
variable summed out after it already fixed.  All reductions keep their dims,
so dim coordinates never move.  Every draw comes from one generator.
"""

from __future__ import annotations

from functools import reduce

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.enum.enum_messenger import (
    ENUM_DIM_KEY,
    ENUM_SERIAL_KEY,
    config_enumerate,
    enum,
)
from numpyro_tpu_torch.contrib.enum.infer_util import (
    _factor_enum_dims,
    _max_plate_nesting,
    _site_log_prob,
)

__all__ = ["infer_discrete"]

# the infer key of the factor that an enumerated scan leaves in the trace
SCAN_CHAIN_KEY = "_enum_scan_chain"


def infer_discrete(fn=None, first_available_dim=None, temperature=1, rng_key=None):
    """A model-like callable that runs ``fn`` with its enumerated discrete
    sites set to posterior draws (``temperature=1``) or to the joint mode
    (``temperature=0``).  ``rng_key`` is a ``torch.Generator``."""
    if fn is None:
        return lambda f: infer_discrete(
            f, first_available_dim=first_available_dim, temperature=temperature,
            rng_key=rng_key,
        )
    assert first_available_dim is not None and first_available_dim < 0
    assert rng_key is not None, "infer_discrete requires an rng_key"

    def wrapped_fn(*args, **kwargs):
        values = _discrete_posterior_values(
            fn, first_available_dim, temperature, rng_key, args, kwargs
        )
        return handlers.substitute(fn, data=values)(*args, **kwargs)

    return wrapped_fn


def _select_keepdims(f, axis, idx):
    """Pick ``idx`` along the negative ``axis`` of ``f``, keeping the axis
    with size one; ``idx`` has a size-one slot there already."""
    pos = f.dim() + axis
    if pos < 0:  # f does not reach this axis
        return f
    idx = idx.reshape((1,) * (f.dim() - idx.dim()) + tuple(idx.shape))
    target = tuple(f.shape[:pos]) + (1,) + tuple(f.shape[pos + 1:])
    return torch.gather(f, pos, idx.expand(target))


def _sum_foreign_plates(lp, plate_axes, owner_axes):
    for ax in sorted(plate_axes - owner_axes):
        if lp.dim() >= -ax and lp.shape[ax] > 1:
            lp = lp.sum(ax, keepdim=True)
    return lp


class _Var:
    """One enumerated variable: its site, dim, support and plate axes."""

    __slots__ = ("name", "dim", "support", "plate_axes")

    def __init__(self, name, dim, support, plate_axes):
        self.name = name
        self.dim = dim
        self.support = support
        self.plate_axes = plate_axes


def _discrete_posterior_values(model, first_available_dim, temperature, rng_key, args, kwargs):
    """``{site name: value}`` for every enumerated discrete site."""
    wrapped = enum(config_enumerate(model), first_available_dim=first_available_dim)
    # the inner trace must not leak sites into the handlers around it
    with handlers.block():
        tr = handlers.trace(handlers.seed(wrapped, rng_key)).get_trace(*args, **kwargs)
    if any(site.get("infer", {}).get(SCAN_CHAIN_KEY) for site in tr.values()):
        raise NotImplementedError(
            "infer_discrete does not decode the discrete sites of an enumerated scan in "
            "numpyro_tpu_torch: the scan sums its time block into one factor and keeps no "
            "site to decode (the JAX package draws them from their prior there); write "
            "the chain with markov (see ROADMAP.md)"
        )
    plate_ndim = _max_plate_nesting(tr)

    # forward: site-ordered factors, with markov recycling
    pending = []  # (lp, {dim: var})
    current = {}  # dim -> the _Var on it
    serials = {}  # dim -> the serial of that variable
    saved = []  # (var, combined lp, {dim: var} of the combined factor)

    def eliminate(var):
        nonlocal pending
        touching = [(f, vm) for f, vm in pending if var in vm.values()]
        if not touching:
            return
        rest = [(f, vm) for f, vm in pending if var not in vm.values()]
        summed, var_map = [], {}
        for f, vm in touching:
            plate_axes = {
                ax - f.dim()
                for ax in range(max(0, f.dim() - plate_ndim), f.dim())
                if f.shape[ax] > 1
            }
            summed.append(_sum_foreign_plates(f, plate_axes, var.plate_axes))
            var_map.update(vm)
        combined = reduce(lambda a, b: a + b, summed)
        saved.append((var, combined, dict(var_map)))
        # sum-product to draw, max-product for the joint mode
        axis = combined.dim() + var.dim
        if temperature == 0:
            reduced = combined.amax(axis, keepdim=True)
        else:
            reduced = torch.logsumexp(combined, axis, keepdim=True)
        del var_map[var.dim]
        pending = rest + [(reduced, var_map)]

    for name, site in tr.items():
        if site["type"] != "sample":
            continue
        infer = site.get("infer", {})
        d = infer.get(ENUM_DIM_KEY)
        serial = infer.get(ENUM_SERIAL_KEY)
        lp = _site_log_prob(site)
        plate_axes = {fr.dim for fr in site["cond_indep_stack"] if fr.dim is not None}
        if d is not None and d in current and serials.get(d) != serial:
            eliminate(current.pop(d))
        if d is not None:
            current[d] = _Var(name, d, site["fn"].enumerate_support(expand=False), plate_axes)
            serials[d] = serial
        # this factor refers to the current variable of each of its dims
        var_map = {dd: current[dd] for dd in _factor_enum_dims(lp, plate_ndim) if dd in current}
        pending.append((lp, var_map))

    for d in sorted(current):  # the rest, the leftmost dim first
        eliminate(current[d])

    # backward: the reverse order, with later draws fixed
    assignments = {}  # var -> index tensor with a size-one slot at var.dim
    for var, combined, var_map in reversed(saved):
        f = combined
        for dd, other in var_map.items():
            if other is not var:
                f = _select_keepdims(f, dd, assignments[other])
        logits = torch.movedim(f, f.dim() + var.dim, -1)
        if temperature == 0:
            idx = torch.argmax(logits, -1)
        else:
            if temperature != 1:
                logits = logits / temperature
            u = torch.rand(
                tuple(logits.shape), generator=rng_key, device=logits.device,
                dtype=logits.dtype,
            )
            idx = torch.argmax(logits - torch.log(-torch.log(u)), -1)
        assignments[var] = idx.unsqueeze(idx.dim() + 1 + var.dim)

    values = {}
    for var, idx in assignments.items():
        # the enumeration region is all size one by now: keep the plate region
        keep = tuple(idx.shape[max(0, idx.dim() - plate_ndim):])
        flat_support = var.support.reshape(var.support.shape[0])
        values[var.name] = flat_support[idx.reshape(keep)]
    return values
