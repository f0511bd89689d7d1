"""Likelihood proxies and block updates for energy-conserving subsampling
(port of ``numpyro_tpu/contrib/ecs_proxies.py``; Quiroz et al. 2018
difference estimator, Tran et al. 2017 block pseudo-marginal).

What runs inside a potential evaluation is written for ONE chain, as in the
JAX package, and reaches all chains through ``torch.func.vmap``:
:class:`subsample_estimator`, :class:`subsample_panels`, ``proxy_fn`` and
``proxy_init``.  What runs between potential evaluations is written for all
chains at once, with its random numbers from a draw source
(``numpyro_tpu_torch.infer.hmc_core.GeneratorDraws``): :func:`block_refresh`,
:func:`block_update` and ``proxy_update`` take index panels with any leading
chain axes.

Subsample indices are ``int64`` (see ``numpyro_tpu_torch.primitives``).
"""

from __future__ import annotations

import math
from collections import namedtuple
from contextlib import nullcontext
from functools import partial

import numpy as np
import torch

import numpyro_tpu_torch.primitives as primitives
from numpyro_tpu_torch.distributions.transforms import biject_to
from numpyro_tpu_torch.handlers import block, substitute, trace
from numpyro_tpu_torch.parallel.mesh import all_reduce, shard_sum_mode, sum_partial_panels

__all__ = [
    "TaylorProxyStats",
    "block_refresh",
    "block_update",
    "subsample_estimator",
    "subsample_panels",
    "taylor_proxy",
]


class subsample_panels(primitives.Messenger):
    """Hoist subsample gathers out of potential evaluations.

    The indices are constant within a trajectory, so the kernel gathers once
    per Gibbs step in ``record`` mode and every potential evaluation replays
    the stored panels:

    - ``record=True``: perform the enclosing subsampled plates' takes, append
      each panel to ``out``, and flag the message so the plates skip their own.
      A take from a data shard (``parallel.shard_data``) is this rank's part
      of the panel (``parallel.mesh.shard_sum_mode("defer")``): ``groups``,
      if given, gets each panel's data group (``None`` for a whole panel),
      which the caller sums over after its ``vmap``
      (``parallel.mesh.sum_partial_panels``); ``shards``, if given, maps
      each plate that took from a shard to the shard; ``axes``, if given,
      gets each panel's ``(plate name, axis)`` where one plate took it,
      else ``None``.
    - ``record=False``: put ``panels`` (in the model's call order) in place of
      the takes, in the dtype of the data they stand for (a panel carried at
      half width is widened here; the widening is exact), and flag the message.

    Record and replay traverse the same model, so call order aligns.
    """

    def __init__(self, fn=None, panels=None, record=False, out=None, groups=None, shards=None,
                 axes=None):
        self.record = record
        self.panels = out if record else panels
        self.groups, self.shards, self.axes = groups, shards, axes
        self._i = 0
        super().__init__(fn)

    def __enter__(self):
        self._i = 0
        return super().__enter__()

    def postprocess_message(self, msg):
        if msg["type"] != "subsample" or msg.get("_pregathered"):
            return
        if self.record:
            takers = [h for h in primitives._PYRO_STACK
                      if isinstance(h, primitives.plate) and h.subsample_size < h.size]
            with shard_sum_mode("defer"):
                for h in takers:
                    h.postprocess_message(msg)
            self.panels.append(msg["value"])
            if self.axes is not None:
                one = len(takers) == 1
                self.axes.append(
                    (takers[0].name, takers[0].dim - msg["kwargs"]["event_dim"]) if one else None)
            if self.groups is not None:
                self.groups.append(msg.get("_partial_over"))
            if self.shards is not None and msg.get("_shard_gathered"):
                self.shards[msg["_shard_gathered"]] = msg["_data_shard"]
        else:
            msg["value"] = self.panels[self._i].to(msg["value"].dtype)
            self._i += 1
        msg["_pregathered"] = True


def _device_memory_bytes(device):
    """The memory budget that ``auto`` modes size themselves against: the
    card's total memory for a CUDA device, and a budget no CPU run exhausts
    otherwise (so that ``auto`` keeps the statistics-carrying mode there)."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return 1e12


TaylorProxyStats = namedtuple("TaylorProxyStats", "value, grad")
"""Per-plate dicts of reference log-likelihood statistics at the current
subsample: value ``(m,)``, grad ``(m, P)``.  No per-point Hessian panel is
kept (``m P^2`` floats per chain): the degree-2 term is recomputed at
evaluation time as a second directional derivative along ``params - ref``."""


def block_refresh(draws, idx, size, num_blocks):
    """Redraw one random block of each subsample index vector.

    ``idx`` is ``(..., m)``; ``draws.block(idx, num_blocks, bs, size)`` gives
    the block number ``b`` ``(...)`` and the replacement draws ``repl``
    ``(..., bs)``.  Returns ``(new_idx, in_block, repl, start)``: ``in_block``
    marks the refreshed positions and ``start`` is the block's first position.
    """
    m = idx.shape[-1]
    bs = -(-m // num_blocks)
    b, repl = draws.block(idx, num_blocks, bs, size)
    pos = torch.arange(m, device=idx.device)
    start = (b * bs)[..., None]
    in_block = (pos >= start) & (pos < start + bs)
    sel = (pos - start).clamp(0, bs - 1)
    new_idx = torch.where(in_block, torch.take_along_dim(repl, sel, -1), idx)
    return new_idx, in_block, repl, start[..., 0]


def block_update(plate_sizes, num_blocks, draws, gibbs_sites, gibbs_state):
    """Proxy-free block update of every subsample plate."""
    new = {}
    for name in sorted(gibbs_sites):
        new[name], *_ = block_refresh(draws, gibbs_sites[name], plate_sizes[name][0], num_blocks)
    return new, gibbs_state


def _per_site_loglik(fn, value, dim):
    """Reduce a site's log_prob over every axis except the subsample dim."""
    lp = fn.log_prob(value)
    if lp.dim() == 1:
        return lp
    moved = torch.movedim(lp, dim, 0)
    return moved.reshape(moved.shape[0], -1).sum(-1)


def _ravel(params):
    """Dict of tensors -> flat vector, sites in sorted order."""
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


class subsample_estimator(primitives.Messenger):
    """Swap the exact likelihood of observed sites inside subsample plates
    for the bias-corrected difference estimator.

    Active only while a potential-energy evaluation is on the handler stack
    (found by its unconstraining substitution): tracing and prediction see
    the untouched likelihood.
    """

    def __init__(self, fn, plate_sizes, proxy_fn):
        super().__init__(fn)
        self._plate_sizes = plate_sizes
        self._proxy = proxy_fn
        self._call_args, self._call_kwargs = None, None
        self._reset()

    def _reset(self):
        self._params = None
        self._collected = {}
        self._plates_seen = {}
        self._plate_idx = {}
        self._gibbs_state = None
        self._panels = None

    def _in_potential_eval(self):
        from numpyro_tpu_torch.infer.util import _unconstrain_reparam

        for handler in primitives._PYRO_STACK[::-1]:
            if (
                isinstance(handler, substitute)
                and isinstance(handler.substitute_fn, partial)
                and handler.substitute_fn.func is _unconstrain_reparam
            ):
                return handler.substitute_fn.args[0]
        return None

    def __call__(self, *args, **kwargs):
        # the live model args: the proxy re-evaluates the model on them
        self._call_args = args
        self._call_kwargs = {
            k: v
            for k, v in kwargs.items()
            if k not in ("_gibbs_sites", "_gibbs_state", "_subsample_panels",
                         "_lean_shard_latents")
        }
        return super().__call__(*args, **kwargs)

    def __enter__(self):
        self._reset()
        self._params = self._in_potential_eval()
        return super().__enter__()

    def __exit__(self, exc_type, exc_value, tb):
        super().__exit__(exc_type, exc_value, tb)
        if exc_type is not None or self._params is None:
            return
        if primitives.get_mask() is False:
            self._reset()
            return
        sub_ll = {}
        for fn, value, dim, plate in self._collected.values():
            sub_ll[plate] = sub_ll.get(plate, 0.0) + _per_site_loglik(fn, value, dim)
        total_all, total_sub = self._proxy(
            self._params,
            tuple(sub_ll),
            self._gibbs_state,
            {k: v for k, v in self._plate_idx.items() if k in sub_ll},
            panels=self._panels,
            margs=self._call_args,
            mkwargs=self._call_kwargs,
        )
        estimate = 0.0
        for plate, ll in sub_ll.items():
            n, m = self._plate_sizes[plate]
            diff = ll - total_sub[plate]
            # Quiroz et al. difference estimator with variance correction
            # (the population variance, as ``jnp.var``)
            var = ((diff - diff.mean()) ** 2).mean()
            estimate = estimate + (
                total_all[plate] + (n / m) * diff.sum() - 0.5 * (n**2 / m) * var
            )
        primitives.factor("_subsample_likelihood_estimate", estimate)
        self._reset()

    def process_message(self, msg):
        if self._params is None:
            return
        if msg["type"] == "_gibbs_state":
            self._gibbs_state = msg["value"]
            return
        if msg["type"] == "_subsample_panels":
            self._panels = msg["value"]
            return
        if (
            msg["type"] == "plate"
            and msg["args"][1] is not None
            and msg["args"][0] > msg["args"][1]
        ):
            self._plates_seen[msg["name"]] = True
        elif msg["type"] == "sample" and msg["is_observed"]:
            for frame in msg["cond_indep_stack"]:
                if frame.name in self._plates_seen:
                    if msg["name"] in self._collected:
                        raise RuntimeError(
                            f"site {msg['name']} appears under multiple "
                            "subsample plates; reshape the data so each "
                            "observation belongs to one subsample plate"
                        )
                    # keep the original fn: the message's is masked below
                    self._collected[msg["name"]] = (
                        msg["fn"], msg["value"], frame.dim, frame.name
                    )
                    msg["fn"] = msg["fn"].mask(False)

    def postprocess_message(self, msg):
        if self._params is None:
            return
        # the final (substituted) subsample index vector of each plate: the
        # degree-2 proxy re-derives its quadratic terms at these indices
        if msg["type"] == "plate" and msg["name"] in self._plates_seen:
            self._plate_idx[msg["name"]] = msg["value"]


def _block_panels(panels, axes, fresh):
    """The data panels of the refreshed blocks' replacement rows, cut from
    the ``panels`` of the new index sets (each taken by the one plate and
    along the axis that ``axes`` gives; ``None`` if one was taken by more or
    none).  The new indices hold the replacements at the block's positions;
    where the last block is cut short, the positions past the end repeat the
    last row, which the merge leaves out."""
    if any(a is None for a in axes):
        return None
    out = []
    for panel, (name, axis) in zip(panels, axes):
        _, mask, repl, start = fresh[name]
        m, bs = mask.shape[-1], repl.shape[-1]
        pos = (start[..., None] + torch.arange(bs, device=start.device)).clamp(max=m - 1)
        lead = pos.dim() - 1
        at = panel.dim() + axis
        shape = list(panel.shape)
        view = [1] * panel.dim()
        view[:lead] = shape[:lead]
        view[at] = bs
        shape[at] = bs
        out.append(torch.take_along_dim(panel, pos.reshape(view).expand(shape), at))
    return tuple(out)


def _as_tensor(value, like):
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(value), dtype=like.dtype, device=like.device)


def taylor_proxy(reference_params, degree=2, mode="auto"):
    """Taylor control variate around reference (MAP) parameters, given as
    numpy arrays or tensors.

    Returns a constructor matching the HMCECS proxy contract:
    ``construct(prototype_trace, plate_sizes, model, args, kwargs, num_blocks,
    num_chains, hbm_budget) -> (proxy_fn, proxy_init, proxy_update)`` with
    per-chain ``proxy_fn`` and ``proxy_init(idx_dict)`` and an all-chains
    ``proxy_update(draws, idx_dict, stats)``.

    ``mode`` selects the memory/compute trade for the per-point reference
    statistics:

    - ``"stats"``: carry ``(m,)`` value and ``(m, P)`` gradient panels per
      chain in the kernel state, block-merged on each index refresh.
    - ``"recompute"``: carry nothing per chain.  Each potential evaluation
      recovers value, first and second directional terms from one nested JVP
      of the pointwise log-likelihood along ``d = params - ref``.
    - ``"auto"``: ``"stats"`` when three copies of the panels take at most
      0.15 of the device's memory (or of ``hbm_budget``), else
      ``"recompute"``.
    """
    if degree not in (1, 2):
        raise ValueError("taylor_proxy supports degree 1 or 2 only")
    if mode not in ("stats", "recompute", "auto"):
        raise ValueError("taylor_proxy mode must be stats|recompute|auto")

    def construct(prototype_trace, plate_sizes, model, model_args, model_kwargs,
                  num_blocks=1, num_chains=1, hbm_budget=None):
        names = sorted(reference_params)
        # the reference lives where the chains do, in their dtype
        likes = {k: prototype_trace[k]["value"] for k in names}
        transforms = {
            k: biject_to(prototype_trace[k]["fn"].support)
            if prototype_trace[k]["type"] == "sample" else None
            for k in names
        }

        def _apply(values, invert):
            out = {}
            for k, v in values.items():
                t = transforms[k]
                out[k] = v if t is None else (t.inv(v) if invert else t(v))
            return out

        unc = _apply({k: _as_tensor(reference_params[k], likes[k]) for k in names}, True)
        shapes = [tuple(unc[k].shape) for k in names]
        sizes = [math.prod(s) for s in shapes]
        ref_flat = _ravel(unc)
        device = ref_flat.device

        def unravel(flat):
            out, i = {}, 0
            for k, shp, n in zip(names, shapes, sizes):
                out[k] = flat[i : i + n].reshape(shp)
                i += n
            return out

        def pointwise_loglik(params_flat, idx_dict, panels=None, margs=None, mkwargs=None):
            """{plate: (m,)} per-datapoint log-likelihood at given indices.
            With ``panels`` the subsample gathers are replayed from them."""
            margs = model_args if margs is None else margs
            mkwargs = model_kwargs if mkwargs is None else mkwargs
            replay = (
                subsample_panels(panels=list(panels)) if panels is not None else nullcontext()
            )
            params = _apply(unravel(params_flat), False)
            with block(), replay, trace() as tr, substitute(data=idx_dict), substitute(data=params):
                model(*margs, **mkwargs)
            out = {}
            for site in tr.values():
                if site["type"] == "sample" and site["is_observed"]:
                    for frame in site["cond_indep_stack"]:
                        if frame.name in idx_dict:
                            ll = _per_site_loglik(site["fn"], site["value"], frame.dim)
                            out[frame.name] = out.get(frame.name, 0.0) + ll
            return out

        def _panels_at(idx_dict, margs=None, mkwargs=None, batch_dims=0):
            """The subsample plates' data panels at ``idx_dict`` (with
            ``batch_dims`` leading axes), recorded under ``vmap`` at the
            reference and summed over a data group where the data is a
            data shard (one ``all_reduce``), so they are the whole data's."""
            margs = model_args if margs is None else margs
            mkwargs = model_kwargs if mkwargs is None else mkwargs
            params = _apply(unravel(ref_flat), False)
            groups = []

            def record(idx):
                out = []
                groups.clear()
                with block(), subsample_panels(record=True, out=out, groups=groups), \
                        substitute(data=idx), substitute(data=params):
                    model(*margs, **mkwargs)
                return tuple(out)

            for _ in range(batch_dims):
                record = torch.func.vmap(record)
            return sum_partial_panels(record(idx_dict), groups)

        def _stats_at(idx_dict, margs=None, mkwargs=None, panels=None):
            if panels is None:
                panels = _panels_at(idx_dict, margs, mkwargs)
            value = pointwise_loglik(ref_flat, idx_dict, panels, margs, mkwargs)
            # forward mode: P << m, so P tangents beat m cotangents
            grad = torch.func.jacfwd(
                lambda p: pointwise_loglik(p, idx_dict, panels, margs, mkwargs)
            )(ref_flat)
            return TaylorProxyStats(value, grad)

        # full-data reference statistics, computed once: where a plate takes
        # from a data shard, over this rank's rows, then summed over the
        # data group (one all_reduce)
        shards = {}
        with block(), subsample_panels(record=True, out=[], shards=shards), substitute(
            data={k: prototype_trace[k]["value"] for k in plate_sizes}
        ), substitute(data=_apply(unravel(ref_flat), False)):
            model(*model_args, **model_kwargs)
        full_idx = {
            k: torch.arange(shards[k].start, shards[k].stop, device=device) if k in shards
            else torch.arange(v[0], device=device)
            for k, v in plate_sizes.items()
        }

        def _summed(params_flat):
            lls = pointwise_loglik(params_flat, full_idx)
            return {k: v.sum() for k, v in lls.items()}

        with shard_sum_mode("local"):
            with torch.no_grad():
                full_value = _summed(ref_flat)
            full_grad = torch.func.jacrev(_summed)(ref_flat)
            full_hess = (
                torch.func.jacfwd(torch.func.jacrev(_summed))(ref_flat) if degree == 2
                else None
            )
        groups = {id(sh.group): sh.group for sh in shards.values() if sh.group is not None}
        if len(groups) > 1:
            raise ValueError("the subsample plates take from data shards of different groups")
        if groups:
            parts = [d for d in (full_value, full_grad, full_hess) if d is not None]
            flat = torch.cat([d[k].reshape(-1) for d in parts for k in sorted(shards)])
            all_reduce(flat, next(iter(groups.values())), over_data=True)
            at = 0
            for d in parts:
                for k in sorted(shards):
                    n = d[k].numel()
                    d[k] = flat[at : at + n].reshape(d[k].shape)
                    at += n

        # --- the stats-vs-recompute trade
        resolved = mode
        if resolved == "auto":
            m_total = sum(int(m) for _, m in plate_sizes.values())
            # old, refreshed and merged copies of the (C, m, P + 1) panels
            # are live inside one Gibbs step
            stats_bytes = 3 * num_chains * m_total * (ref_flat.numel() + 1) * 4
            budget = hbm_budget if hbm_budget else _device_memory_bytes(device)
            resolved = "stats" if stats_bytes <= 0.15 * budget else "recompute"

        def _refresh_all(draws, idx_dict):
            out = {}
            for name in sorted(idx_dict):
                out[name] = block_refresh(draws, idx_dict[name], plate_sizes[name][0], num_blocks)
            return out

        def _full_terms(name, d):
            full = full_value[name] + full_grad[name] @ d
            if degree == 2:
                full = full + 0.5 * d @ full_hess[name] @ d
            return full

        if resolved == "recompute":

            def proxy_init_r(idx_dict, margs=None, mkwargs=None):
                return ()

            def proxy_update_r(draws, idx_dict, stats, margs=None, mkwargs=None,
                               panels_of=None):
                return {k: v[0] for k, v in _refresh_all(draws, idx_dict).items()}, ()

            def proxy_fn_r(params, plate_names, stats, idx_dict=None, panels=None,
                           margs=None, mkwargs=None):
                if idx_dict is None:
                    raise ValueError(
                        "recompute-mode taylor_proxy requires the subsample "
                        "indices at evaluation time"
                    )
                d = _ravel(params) - ref_flat
                one = torch.ones_like(ref_flat[0]) if ref_flat.numel() else torch.ones(())

                def along(t):
                    return pointwise_loglik(ref_flat + t * d, idx_dict, panels, margs, mkwargs)

                def val_and_first(t):
                    return torch.func.jvp(along, (t,), (one,))

                (vals, firsts), (_, seconds) = torch.func.jvp(
                    val_and_first, (torch.zeros_like(one),), (one,)
                )
                total_all, total_sub = {}, {}
                for name in plate_names:
                    sub = vals[name] + firsts[name]
                    if degree == 2:
                        sub = sub + 0.5 * seconds[name]
                    total_sub[name] = sub
                    total_all[name] = _full_terms(name, d)
                return total_all, total_sub

            proxy_fn_r.mode = resolved
            return proxy_fn_r, proxy_init_r, proxy_update_r

        def proxy_init(idx_dict, margs=None, mkwargs=None):
            return _stats_at(idx_dict, margs, mkwargs)

        def proxy_update(draws, idx_dict, stats, margs=None, mkwargs=None, panels_of=None):
            """Refresh one block of every chain's index vectors and merge the
            reference statistics of the replacements into the carried ones.
            ``panels_of(new_idx)``, if given, records the data panels of the
            new index sets for the caller and returns them with their
            ``(plate, axis)``; the replacements' panels are then cut from
            them, where each panel has one plate, and not gathered again."""
            fresh = _refresh_all(draws, idx_dict)
            new_idx = {k: v[0] for k, v in fresh.items()}
            repls = {k: v[2] for k, v in fresh.items()}
            batch_dims = next(iter(repls.values())).dim() - 1
            repl_panels = None
            if panels_of is not None:
                repl_panels = _block_panels(*panels_of(new_idx), fresh)
            if repl_panels is None:
                repl_panels = _panels_at(repls, margs, mkwargs, batch_dims)

            def stats_at(idx, panels):
                return _stats_at(idx, margs, mkwargs, panels)

            for _ in range(batch_dims):
                stats_at = torch.func.vmap(stats_at)
            repl_stats = stats_at(repls, repl_panels)

            def merge(old, new):
                """Positions inside the refreshed block take the replacement's
                statistics, the others keep theirs."""
                merged = {}
                for name in old:
                    _, mask, repl, start = fresh[name]
                    pos = torch.arange(mask.shape[-1], device=mask.device)
                    sel = (pos - start[..., None]).clamp(0, repl.shape[-1] - 1)
                    tail = (1,) * (old[name].dim() - mask.dim())
                    sel = sel.reshape(sel.shape + tail).expand(old[name].shape)
                    gathered = torch.take_along_dim(new[name], sel, mask.dim() - 1)
                    merged[name] = torch.where(
                        mask.reshape(mask.shape + tail), gathered, old[name]
                    )
                return merged

            return new_idx, TaylorProxyStats(
                merge(stats.value, repl_stats.value), merge(stats.grad, repl_stats.grad)
            )

        def _second_directional(d, idx_dict, panels=None, margs=None, mkwargs=None):
            """Per-point d^2/dt^2 loglik(ref + t d): the degree-2 quadratic
            terms, without a stored (m, P, P) Hessian panel."""
            one = torch.ones_like(d[0])

            def along(t):
                return pointwise_loglik(ref_flat + t * d, idx_dict, panels, margs, mkwargs)

            def first(t):
                return torch.func.jvp(along, (t,), (one,))[1]

            return torch.func.jvp(first, (torch.zeros_like(one),), (one,))[1]

        def proxy_fn(params, plate_names, stats, idx_dict=None, panels=None,
                     margs=None, mkwargs=None):
            # params arrive unconstrained (from the potential's substitution)
            if degree == 2 and idx_dict is None:
                # first-order per-point terms with a second-order full term
                # would break the difference estimator's telescoping
                raise ValueError(
                    "degree-2 taylor_proxy requires the subsample indices "
                    "at evaluation time"
                )
            d = _ravel(params) - ref_flat
            quad = (
                _second_directional(d, idx_dict, panels, margs, mkwargs)
                if degree == 2 else None
            )
            total_all, total_sub = {}, {}
            for name in plate_names:
                sub = stats.value[name] + stats.grad[name] @ d
                if degree == 2:
                    sub = sub + 0.5 * quad[name]
                total_sub[name] = sub
                total_all[name] = _full_terms(name, d)
            return total_all, total_sub

        proxy_fn.mode = resolved
        return proxy_fn, proxy_init, proxy_update

    return construct
