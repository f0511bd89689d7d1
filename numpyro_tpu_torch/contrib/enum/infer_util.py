"""The enumerated log density: a sum-product over enumeration dims (port of
``numpyro_tpu/contrib/enum/infer_util.py``).

Factors are collected in site order.  An enumerated variable is summed out
(``logsumexp``) when a markov frame recycles its dim, so that a chain never
grows the rank of a tensor, or at the end.  Before a dim is summed out, each
factor that holds it is summed over the plate axes that the variable does
not live in: a global discrete sees the plate-summed likelihood, and a
plate-local one is summed out element by element.
"""

from __future__ import annotations

from functools import reduce

import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.enum.enum_messenger import ENUM_DIM_KEY, ENUM_SERIAL_KEY
from numpyro_tpu_torch.distributions.util import scale_and_mask

__all__ = ["log_density"]


def _max_plate_nesting(model_trace):
    dims = [
        frame.dim
        for site in model_trace.values()
        if site["type"] == "sample"
        for frame in site["cond_indep_stack"]
        if frame.dim is not None
    ]
    return -min(dims) if dims else 0


def _factor_enum_dims(log_prob, plate_ndim):
    """The enumeration dims a factor holds: its axes left of the plate
    region of size above one (size-one axes there are broadcast slots)."""
    ndim = log_prob.dim()
    return [axis - ndim for axis in range(ndim - plate_ndim) if log_prob.shape[axis] > 1]


def _site_log_prob(site):
    value = site["value"]
    intermediates = site.get("intermediates")
    if intermediates:
        lp = site["fn"].log_prob(value, intermediates)
    else:
        lp = site["fn"].log_prob(value)
    return scale_and_mask(lp, site.get("scale"))


def _plate_axes(site, lp, plate_ndim):
    """The site's declared plate dims, and any axis of size above one in the
    plate region: a factor that a scan made has plate axes without frames."""
    axes = {frame.dim for frame in site["cond_indep_stack"] if frame.dim is not None}
    nd = lp.dim()
    for ax in range(max(0, nd - plate_ndim), nd):
        if lp.shape[ax] > 1:
            axes.add(ax - nd)
    return axes


class _Factor:
    __slots__ = ("lp", "enum_dims", "plate_axes")

    def __init__(self, lp, enum_dims, plate_axes):
        self.lp = lp
        self.enum_dims = set(enum_dims)
        self.plate_axes = set(plate_axes)


def _sum_plate_axes(lp, axes_to_sum):
    """Sum over the given negative plate axes, keeping them as size one so
    that every other dim keeps its place."""
    for ax in axes_to_sum:
        if lp.dim() >= -ax and lp.shape[ax] > 1:
            lp = lp.sum(ax, keepdim=True)
    return lp


def _eliminate(pending, d, owner_plate_axes):
    """Sum enumeration dim ``d`` out of the pending factors."""
    touching = [f for f in pending if d in f.enum_dims]
    if not touching:
        return pending
    rest = [f for f in pending if d not in f.enum_dims]
    summed = []
    plate_axes = set()
    for f in touching:
        summed.append(_sum_plate_axes(f.lp, sorted(f.plate_axes - owner_plate_axes)))
        plate_axes |= f.plate_axes & owner_plate_axes
    combined = reduce(lambda a, b: a + b, summed)
    reduced = torch.logsumexp(combined, combined.dim() + d, keepdim=True)
    enum_dims = set().union(*(f.enum_dims for f in touching)) - {d}
    rest.append(_Factor(reduced, enum_dims, plate_axes))
    return rest


def log_density(model, model_args, model_kwargs, params):
    """The log joint with the enumerated discrete sites summed out, and the
    trace.  ``model`` must already run under
    ``enum(config_enumerate(model), first_available_dim)``."""
    model = handlers.substitute(model, data=params) if params else model
    model_trace = handlers.trace(model).get_trace(*model_args, **model_kwargs)
    plate_ndim = _max_plate_nesting(model_trace)

    pending = []
    active_serial = {}  # dim -> serial of the variable living on it
    dim_owner_axes = {}  # dim -> plate axes of that variable

    for site in model_trace.values():
        if site["type"] != "sample":
            continue
        log_prob = _site_log_prob(site)
        plate_axes = _plate_axes(site, log_prob, plate_ndim)
        infer = site.get("infer", {})
        d = infer.get(ENUM_DIM_KEY)
        serial = infer.get(ENUM_SERIAL_KEY)
        if d is not None and d in active_serial and active_serial[d] != serial:
            # markov recycling: sum out the variable that held this dim
            pending = _eliminate(pending, d, dim_owner_axes.get(d, set()))
            del active_serial[d]
        if d is not None:
            active_serial[d] = serial
            dim_owner_axes[d] = plate_axes
        pending.append(_Factor(log_prob, _factor_enum_dims(log_prob, plate_ndim), plate_axes))

    # the remaining dims, the leftmost first
    for d in sorted({d for f in pending for d in f.enum_dims}):
        pending = _eliminate(pending, d, dim_owner_axes.get(d, set()))

    total = 0.0
    for f in pending:
        total = total + f.lp.sum()
    return total, model_trace
