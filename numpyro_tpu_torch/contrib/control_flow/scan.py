"""The effectful ``scan``: model code run over the leading axis of ``xs``
with a carry, its sites recorded into the handlers around it (port of
``numpyro_tpu/contrib/control_flow/scan.py``).

PyTorch has no ``lax.scan``, so each form takes its own design:

* **No enumeration.**  A Python loop runs the body once per step, each step
  under a ``block`` and a ``trace``.  The steps' sites are stacked along
  time (the distributions tensor by tensor, ``promote_batch_shape``) and
  replayed into the outer handlers, as the JAX package replays the trace
  that ``lax.scan`` stacked.  Outer ``substitute``, ``condition`` and
  ``replay`` reach the steps through the ``substitute_stack`` of the
  ``control_flow`` message, each step taking its slice of a whole series.

* **Enumeration** (an ``enum`` handler above).  Step 0 runs alone and leaves
  its discrete on dim ``d_prev``.  Every later step then sees the same
  enumerated carry on the recycled dim pair and differs only in its ``x``,
  so the body runs ONCE for all of them under ``torch.func.vmap`` over
  time, inside whatever vmap is already around (the chains of a run).  Each
  step gives a factor ``M_t[..., cur, prev]``; a pairwise tree of
  ``logmatmulexp`` products (log2 T rounds, each a batched ``torch.matmul``)
  collapses time to ``M_T ... M_1``, which meets step 0's factor; the result
  enters the enclosing enumeration as one ``factor`` site.  That holds while
  the body's carry is its enumerated state or passes through unchanged.  A
  carry that changes otherwise (a counter, a running sum of the data) makes
  each step depend on the one before: the vmapped pass is dropped and the
  steps run one at a time, each taking the last one's carry with its
  enumerated value moved back to ``d_prev``, as the JAX package's
  ``lax.scan`` carries it.  A substituted series shorter than the scan gives
  the steps past its end a draw from the site's distribution (a
  ``torch.where`` on the step index, the JAX package's ``lax.cond``).  The
  JAX package's scope holds as well: ``history <= 1`` and one enumerated
  site per step.

``xs`` that hold a rank's rows of a data shard (``parallel.shard_data``) are
gathered once, at entry: a step takes one row, which would otherwise gather
them every step.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils import _pytree as pytree

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.enum.discrete import SCAN_CHAIN_KEY
from numpyro_tpu_torch.contrib.enum.enum_messenger import (
    _MARKOV_STACK,
    ENUM_DIM_KEY,
    config_enumerate,
)
from numpyro_tpu_torch.contrib.enum.enum_messenger import enum as enum_handler
from numpyro_tpu_torch.contrib.enum.infer_util import _site_log_prob
from numpyro_tpu_torch.distributions.batch_util import promote_batch_shape
from numpyro_tpu_torch.distributions.util import logmatmulexp
from numpyro_tpu_torch.parallel.data_shard import whole
from numpyro_tpu_torch.primitives import _PYRO_STACK, apply_stack, factor
from numpyro_tpu_torch.util import tree_leaves, tree_map

__all__ = ["scan"]

# the site types that cross the scan's boundary
_CARRIED_TYPES = ("sample", "deterministic", "param")


def _scan_length(xs, length):
    if length is not None:
        return length
    return tree_leaves(xs)[0].shape[0]


def _subs_wrapper(subs_map, i, length, site):
    """The value that an outer substitute or condition map gives one step's
    site: a per-step value as it is, a whole series at step ``i``."""
    if site["type"] != "sample":
        return None
    value = None
    if isinstance(subs_map, dict):
        value = subs_map.get(site["name"])
    elif callable(subs_map):
        rng_key = site["kwargs"].get("rng_key")
        if rng_key is not None:
            subs_map = handlers.seed(subs_map, rng_seed=rng_key)
        value = subs_map(site)
    if value is None:
        return None
    value = torch.as_tensor(value)
    sample_shape = tuple(site["kwargs"]["sample_shape"])
    fn_ndim = len(sample_shape + tuple(site["fn"].shape()))
    if value.dim() == fn_ndim:
        # a per-step value (an init strategy applied at each step)
        return value
    if value.dim() == fn_ndim + 1:
        n = value.shape[0]
        if n == length:
            return value[i]
        if n < length:
            draw = partial(site["fn"], rng_key=site["kwargs"]["rng_key"],
                           sample_shape=sample_shape)
            if isinstance(i, torch.Tensor):
                # the enumerated scan's steps run together: those past the
                # series' end take a draw
                taken = torch.index_select(value, 0, i.clamp(max=n - 1).reshape(1))[0]
                return torch.where(i < n, taken, draw())
            return value[i] if i < n else draw()
        raise RuntimeError(
            f"Substituted value for site {site['name']} requires length <= {length}, got {n}."
        )
    raise RuntimeError(
        f"Expected ndim {fn_ndim} or {fn_ndim + 1} for site {site['name']}, "
        f"got {value.dim()}.  Nested scan is not supported."
    )


def _step_fn(f, i, length, rng_key, substitute_stack):
    """The body of step ``i``: told its index, seeded, and under the outer
    substitutions, innermost first."""
    fn = handlers.infer_config(f, config_fn=lambda msg: {"_scan_current_index": i})
    if rng_key is not None:
        fn = handlers.seed(fn, rng_key)
    for subs_type, subs_map in substitute_stack:
        if subs_type == "replay":
            # replaying an outer trace substitutes its recorded latent values
            subs_map = {
                name: site["value"]
                for name, site in subs_map.items()
                if site["type"] == "sample" and not site.get("is_observed", False)
                and site["value"] is not None
            }
        subs_fn = partial(_subs_wrapper, subs_map, i, length)
        if subs_type == "condition":
            fn = handlers.condition(fn, condition_fn=subs_fn)
        else:
            fn = handlers.substitute(fn, substitute_fn=subs_fn)
    return fn


def _stack(parts):
    """Stack a list of like objects along a new leading axis: tensors, the
    tensors inside distributions, transforms and containers; anything else is
    taken from the first part."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    if isinstance(first, (list, tuple)):
        stacked = [_stack(list(p)) for p in zip(*parts)]
        return type(first)(*stacked) if hasattr(first, "_fields") else type(first)(stacked)
    if hasattr(first, "__dict__") and not isinstance(first, type):
        fields = {k: _stack([p.__dict__[k] for p in parts]) for k in first.__dict__}
        if all(fields[k] is v for k, v in first.__dict__.items()):
            return first
        new = object.__new__(type(first))
        new.__dict__.update(fields)
        return new
    return first


def _promote_value(value, fn):
    """``(T,) + value`` as the stacked ``fn`` sees it: size-one axes where
    ``fn`` has batch dims that the value does not."""
    missing = len(fn.batch_shape) - (value.dim() - fn.event_dim)
    if missing > 0:
        return value.reshape(tuple(value.shape[:1]) + (1,) * missing + tuple(value.shape[1:]))
    return value


def _stack_traces(traces, length):
    """One trace of the whole scan from the traces of its steps."""
    stacked = {}
    for name, site in traces[0].items():
        if site["type"] not in _CARRIED_TYPES:
            continue
        steps = [tr[name] for tr in traces]
        new = {k: v for k, v in site.items() if k != "stop"}
        new["_control_flow_done"] = True
        new["value"] = _stack([s["value"] for s in steps])
        if "kwargs" in site and "rng_key" in site["kwargs"]:
            new["kwargs"] = {**site["kwargs"], "rng_key": None}
        if "_scan_current_index" in site.get("infer", {}):
            new["infer"] = {**site["infer"], "_scan_current_index": None}
        if site["type"] == "sample":
            fn = promote_batch_shape(_stack([s["fn"] for s in steps]), (length,))
            new["fn"] = fn
            new["value"] = _promote_value(new["value"], fn)
            if site.get("intermediates"):
                new["intermediates"] = _stack([s["intermediates"] for s in steps])
        stacked[name] = new
    return stacked


def scan_wrapper(f, init, xs, length, reverse, rng_key=None, substitute_stack=None,
                 enum=False, history=1, first_available_dim=None, enum_boundary=None):
    """Run the scan: ``((length, rng_key, carry), (trace, ys))``."""
    length = _scan_length(xs, length)
    substitute_stack = [] if substitute_stack is None else substitute_stack
    if enum:
        return _scan_enum_wrapper(
            f, init, xs, length, reverse, rng_key=rng_key, substitute_stack=substitute_stack,
            history=history, first_available_dim=first_available_dim,
            enum_boundary=enum_boundary,
        )
    carry, traces, ys = init, [], []
    for i in range(length):
        pos = length - 1 - i if reverse else i
        x = tree_map(lambda z: z[pos], xs)
        with handlers.block():
            fn = _step_fn(f, i, length, rng_key, substitute_stack)
            with handlers.trace() as tr:
                carry, y = fn(carry, x)
        traces.append(tr)
        ys.append(y)
    if reverse:
        traces.reverse()
        ys.reverse()
    return (length, rng_key, carry), (_stack_traces(traces, length), _stack(ys))


def _chain_reduce(f0, M, d_cur, d_prev, reverse):
    """``logsumexp over x_0 .. x_T of f0(x_0) + sum_t M_t(x_t, x_(t-1))``.

    ``M`` has time on axis 0 and the current and previous enumeration axes
    at the negative step-frame positions ``d_cur`` and ``d_prev``; any other
    axis rides along as batch.  Time collapses in a pairwise tree of
    ``logmatmulexp`` products, later times on the left."""
    need = -d_cur  # the rank of one step's frame
    if M.dim() - 1 < need:
        M = M.reshape(tuple(M.shape[:1]) + (1,) * (need - (M.dim() - 1)) + tuple(M.shape[1:]))
    if f0.dim() < -d_prev:
        f0 = f0.reshape((1,) * (-d_prev - f0.dim()) + tuple(f0.shape))
    Mm = torch.movedim(M, (d_cur, d_prev), (-2, -1))
    if Mm.shape[-1] == 1 < Mm.shape[-2]:
        # the JAX package's product fails on these shapes as well
        raise NotImplementedError(
            "the enumerated site of a scan step with history=1 must depend on the carried "
            "state; a site that does not is independent per step: use history=0"
        )
    if reverse:
        Mm = Mm.flip(0)
    while Mm.shape[0] > 1:
        n = Mm.shape[0]
        even = n - n % 2
        pairs = logmatmulexp(Mm[1:even:2], Mm[0:even:2])
        Mm = torch.cat([pairs, Mm[even:]]) if n % 2 else pairs
    f0m = torch.movedim(f0, d_prev, -1).unsqueeze(-2)
    return torch.logsumexp(Mm[0] + f0m, dim=(-2, -1))


def _steps_one_at_a_time(run_step, step_factor, y_leaves_of, carry, xs_rest, unroll, n_scan,
                         history, reverse):
    """The steps after the first, each from the carry the one before gave,
    as the JAX package's ``lax.scan`` runs them: a reverse scan walks
    ``xs_rest`` from its end, and every step's factor and output land at
    its ``x``'s place in time.  Each new carry is reshaped to the old one's
    shape, which moves the enumerated value from ``d_cur`` back to
    ``d_prev``.  Returns the last carry, the factors and the outputs'
    leaves, stacked in time order."""
    factors, outputs = [None] * n_scan, [None] * n_scan
    old_leaves, spec = pytree.tree_flatten(carry)
    for j in range(n_scan):
        k = n_scan - 1 - j if reverse else j
        new_carry, y, tr = run_step(unroll + j, carry, tree_map(lambda z: z[k], xs_rest),
                                    slot=history)
        new_leaves = pytree.tree_leaves(new_carry)
        carry = pytree.tree_unflatten([
            torch.as_tensor(b).reshape(torch.as_tensor(a).shape)
            if torch.as_tensor(b).numel() == torch.as_tensor(a).numel() else b
            for a, b in zip(old_leaves, new_leaves)
        ], spec)
        old_leaves = pytree.tree_leaves(carry)
        factors[k], outputs[k] = step_factor(tr), y_leaves_of(y)
    return carry, torch.stack(factors), [torch.stack(parts) for parts in zip(*outputs)]


def _scan_enum_wrapper(f, init, xs, length, reverse, rng_key=None, substitute_stack=None,
                       history=1, first_available_dim=None, enum_boundary=None):
    """The enumerated scan: step 0 alone, the rest in one ``vmap`` over
    time, then :func:`_chain_reduce`; the time block comes back as one
    factor site."""
    if history > 1:
        raise NotImplementedError(
            "enumeration inside scan supports history <= 1; use the python-loop "
            "`markov(range(T), history=h)` form for longer dependencies"
        )
    history = min(history, length)
    unroll = history
    fad = first_available_dim
    d_prev = fad
    d_cur = fad - history
    frame = {"period": history + 1, "slot": 0, "base": None}

    def run_step(i, carry, x, slot):
        fn = _step_fn(f, i, length, rng_key, substitute_stack)
        frame["slot"] = slot
        _MARKOV_STACK.append(frame)
        try:
            with handlers.block(), handlers.trace() as tr:
                new_carry, y = enum_handler(config_enumerate(fn), first_available_dim=fad)(
                    carry, x
                )
        finally:
            _MARKOV_STACK.remove(frame)
        return new_carry, y, tr

    def step_factor(tr):
        """The broadcast sum of one step's log-probs.  Plate axes that the
        enumerated site does not live in are independent terms within the
        step and are summed here; the site's own plate axes (a chain per
        element of a plate) ride through the time collapse as batch."""
        factors, owner_axes, n_enum = [], set(), 0
        for site in tr.values():
            if site["type"] != "sample":
                continue
            d = site.get("infer", {}).get(ENUM_DIM_KEY)
            if d is not None:
                n_enum += 1
                if d not in (d_prev, d_cur):
                    raise NotImplementedError(
                        "only the carried Markov site may be enumerated inside scan "
                        f"(site {site['name']} got dim {d})"
                    )
                owner_axes |= {fr.dim for fr in site["cond_indep_stack"] if fr.dim is not None}
            factors.append(_site_log_prob(site))
        if n_enum > 1:
            raise NotImplementedError(
                "multiple enumerated sites per scan step are not supported; restructure "
                "so one discrete state is carried"
            )
        total = None
        boundary = enum_boundary if enum_boundary is not None else 0
        for lp in factors:
            for ax in range(lp.dim()):
                dd = ax - lp.dim()
                if dd > boundary and dd not in owner_axes and lp.shape[ax] > 1:
                    lp = lp.sum(ax, keepdim=True)
            total = lp if total is None else total + lp
        return torch.zeros(()) if total is None else total

    # step 0 alone: its discrete lands on d_prev
    name_hint = "scan"
    carry, y0, f0 = init, None, None
    xs_rest = xs
    if unroll > 0:
        first = length - 1 if reverse else 0
        x0 = tree_map(lambda z: z[first], xs)
        xs_rest = tree_map(lambda z: z[:-1] if reverse else z[1:], xs)
        carry, y0, tr0 = run_step(0, init, x0, slot=0)
        f0 = step_factor(tr0)
        name_hint = next((nm for nm, s in tr0.items() if s["type"] == "sample"), name_hint)

    # every later step at once while they all see the same carry
    n_scan = length - unroll
    Cs, ys = None, None
    if n_scan > 0:
        y_spec, carry_moves = [], []

        def y_leaves_of(y):
            leaves, spec = pytree.tree_flatten(y)
            y_spec[:] = [spec, [leaf is None for leaf in leaves]]
            return [torch.as_tensor(leaf) for leaf in leaves if leaf is not None]

        def body(i, x):
            new_carry, y, tr = run_step(i, carry, x, slot=history)
            enumerated = [s["value"] for s in tr.values() if ENUM_DIM_KEY in s.get("infer", {})]
            old = pytree.tree_leaves(carry)
            new = pytree.tree_leaves(new_carry)
            if len(old) != len(new) or not all(
                b is a or any(b is v for v in enumerated) for a, b in zip(old, new)
            ):
                carry_moves.append(True)
            return step_factor(tr), y_leaves_of(y)

        leaves = tree_leaves(xs_rest)
        steps = torch.arange(unroll, length, device=leaves[0].device if leaves else None)
        Cs, y_leaves = torch.func.vmap(body, randomness="different")(steps, xs_rest)
        if carry_moves:
            carry, Cs, y_leaves = _steps_one_at_a_time(
                run_step, step_factor, y_leaves_of, carry, xs_rest, unroll, n_scan, history,
                reverse)
        spec, is_none = y_spec
        it = iter(y_leaves)
        ys = pytree.tree_unflatten([None if gap else next(it) for gap in is_none], spec)

    # collapse the time block
    if history == 0:
        # independent discretes per step: sum each out, then add the steps
        chain_lp = Cs
        if chain_lp.dim() >= -d_cur + 1 and chain_lp.shape[d_cur] > 1:
            chain_lp = torch.logsumexp(chain_lp, d_cur, keepdim=True)
        chain_lp = chain_lp.sum(0)
    elif n_scan > 0:
        chain_lp = _chain_reduce(f0, Cs, d_cur, d_prev, reverse)
    else:
        chain_lp = f0
        if f0.dim() >= -d_prev and f0.shape[d_prev] > 1:
            chain_lp = torch.logsumexp(f0, d_prev, keepdim=True)
    # plate-region axes are independent terms: sum them, keeping the place
    # of any global enumeration dim
    if enum_boundary is not None and chain_lp.dim() > 0:
        for ax in range(chain_lp.dim()):
            if ax - chain_lp.dim() > enum_boundary and chain_lp.shape[ax] > 1:
                chain_lp = chain_lp.sum(ax, keepdim=True)

    # the factor as a site of its own, which scan() replays upwards
    with handlers.block(), handlers.trace() as ftr:
        factor(f"_chain_{name_hint}", chain_lp)
    trace = {}
    for nm, site in ftr.items():
        site = {k: v for k, v in site.items() if k != "stop"}
        site["_control_flow_done"] = True
        site["infer"] = {**site["infer"], SCAN_CHAIN_KEY: True}
        trace[nm] = site

    if y0 is not None and ys is not None:
        ys = tree_map(
            lambda z, z0: torch.cat(
                [z, z0[None]] if reverse else [z0[None], z]
            ),
            ys, y0,
        )
    elif y0 is not None:
        ys = tree_map(lambda z0: z0[None], y0)
    return (length, rng_key, carry), (trace, ys)


def scan(f, init, xs, length=None, reverse=False, history=1):
    """Scan ``f`` over the leading axis of ``xs`` with a carry, recording
    its ``sample`` and ``deterministic`` sites into the enclosing handlers,
    each stacked along time.

    :param f: ``(carry, x) -> (carry, y)``, which may call primitives.
    :param init: the initial carry.
    :param xs: the tensors scanned along their leading axis (or ``None``
        with ``length``).
    :param length: required when ``xs`` is ``None``.
    :param reverse: scan from the end.
    :param history: the Markov order of an enumerated carry (0 or 1).
    :return: ``(last_carry, ys)``, ``ys`` stacked along time.
    """
    xs = tree_map(whole, xs)
    if not _PYRO_STACK:
        (_, _, carry), (_, ys) = scan_wrapper(f, init, xs, length=length, reverse=reverse)
        return carry, ys
    msg = apply_stack({
        "type": "control_flow",
        "name": None,
        "fn": scan_wrapper,
        "args": (f, init, xs, length, reverse),
        "kwargs": {"rng_key": None, "substitute_stack": [], "history": history},
        "value": None,
    })
    (_, _, carry), (trace, ys) = msg["value"]
    # the stacked sites go through the outer handlers as ordinary sites
    for site in trace.values():
        apply_stack(site)
    return carry, ys
