"""Gibbs-composed HMC kernels, natively chain-batched (port of ``HMCGibbs``,
``DiscreteHMCGibbs`` and ``HMCECS`` from ``numpyro_tpu/infer/hmc_gibbs.py``).

- The outer Gibbs state (site values, subsample index panels, proxy
  statistics, data panels) carries a leading chain axis; a single chain is
  ``C == 1`` squeezed at the API boundary.
- Conditioning reaches the inner kernel's potential through
  ``model_kwargs["_per_chain"]`` (see ``hmc.py``): each chain's leapfrog
  gradient sees its own Gibbs values and subsample indices.
- Where the JAX package maps a per-chain function over one key per chain, the
  port works on all chains at once and draws ``(C, ...)`` tensors from one
  draw source (``hmc_core.GeneratorDraws``): the block refresh, the
  pseudo-marginal accept, the discrete sweep, and a user's ``gibbs_fn``, which
  is called once with chain-batched sites and the run's ``torch.Generator``.
- The gradient under the accepted conditioning is selected per chain between
  the proposal's (evaluated with its potential in one batched call) and the
  carried one, which is the gradient under the kept conditioning.
"""

from __future__ import annotations

import copy
import inspect
from collections import namedtuple
from functools import partial

import numpy as np
import torch

from numpyro_tpu_torch import primitives
from numpyro_tpu_torch.contrib.ecs_proxies import (
    TaylorProxyStats,
    _device_memory_bytes,
    block_update,
    subsample_estimator,
    subsample_panels,
    taylor_proxy,
)
from numpyro_tpu_torch.handlers import block, condition, seed, substitute, trace
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc import HMC, HMCState
from numpyro_tpu_torch.infer.initialization import init_to_sample
from numpyro_tpu_torch.infer.mcmc import MCMCKernel
from numpyro_tpu_torch.parallel.data_shard import shard_of
from numpyro_tpu_torch.parallel.mesh import sum_partial_panels
from numpyro_tpu_torch.util import identity, tree_map

__all__ = [
    "DiscreteHMCGibbs", "HMCECS", "HMCECSState", "HMCGibbs", "HMCGibbsState",
    "ecs_state_from_numpy", "gibbs_state_from_numpy", "hmc_state_from_numpy",
]

HMCGibbsState = namedtuple("HMCGibbsState", "z, hmc_state, rng_key")
"""``z``: all latents (Gibbs + HMC sites); ``hmc_state``: inner kernel
state; ``rng_key``: the run's generator (or draw source)."""

HMCECSState = namedtuple(
    "HMCECSState", "z, hmc_state, rng_key, gibbs_state, accept_prob, panels"
)
# ``panels``: the subsample data panels of the current index sets, carried so
# that each Gibbs step gathers once; ``()`` in lean mode
HMCECSState.__new__.__defaults__ = ((),)


def _wrap_model(model, *args, **kwargs):
    gibbs_values = kwargs.pop("_gibbs_sites", {})
    with condition(data=gibbs_values), substitute(data=gibbs_values):
        return model(*args, **kwargs)


def _batched(tree):
    """Add a leading chain axis to every tensor leaf (the step index, the
    trajectory length and the generator are not tensors and stay)."""
    return tree_map(lambda x: x[None], tree)


def _unbatched(tree):
    return tree_map(lambda x: x[0], tree)


def _select(take, new, old):
    """Per-chain choice between two trees of ``(C, ...)`` tensors."""
    return tree_map(
        lambda a, b: torch.where(take.reshape(take.shape + (1,) * (a.dim() - 1)), a, b),
        new, old,
    )


class HMCGibbs(MCMCKernel):
    """Inner HMC/NUTS over continuous sites composed with a user-supplied
    Gibbs conditional over ``gibbs_sites``.

    ``gibbs_fn(rng_key, gibbs_sites, hmc_sites)`` is called once per
    transition with the run's ``torch.Generator`` and the sites of all chains
    (a leading chain axis on every value; none for a single chain), and
    returns the new values of the Gibbs sites in the same layout."""

    sample_field = "z"

    def __init__(self, inner_kernel, gibbs_fn, gibbs_sites):
        if not isinstance(inner_kernel, HMC):
            raise ValueError("inner_kernel must be a HMC or NUTS sampler.")
        if not callable(gibbs_fn):
            raise ValueError("gibbs_fn must be a callable")
        assert inner_kernel.model is not None, (
            "HMCGibbs does not support models specified via a potential function."
        )
        self.inner_kernel = copy.copy(inner_kernel)
        self.inner_kernel._model = partial(_wrap_model, inner_kernel.model)
        self._gibbs_sites = gibbs_sites
        self._gibbs_fn = gibbs_fn
        self._prototype_trace = None
        self._chain_mode = False  # True once init is given a chain count

    @property
    def model(self):
        return self.inner_kernel._model

    def get_diagnostics_str(self, state):
        return self.inner_kernel.get_diagnostics_str(state.hmc_state)

    def postprocess_fn(self, args, kwargs):
        def fn(z):
            model_kwargs = {} if kwargs is None else kwargs.copy()
            gibbs_sites = {k: v for k, v in z.items() if k in self._gibbs_sites}
            hmc_sites = {k: v for k, v in z.items() if k not in self._gibbs_sites}
            model_kwargs["_gibbs_sites"] = gibbs_sites
            out = self.inner_kernel.postprocess_fn(args, model_kwargs)(hmc_sites)
            return {**gibbs_sites, **out}

        return fn

    def _prototype(self, generator, model_args, model_kwargs):
        if self._prototype_trace is None:
            self._prototype_trace = trace(
                substitute(seed(self.model, generator), substitute_fn=init_to_sample())
            ).get_trace(*model_args, **model_kwargs)
        return self._prototype_trace

    def _initial_gibbs_values(self, init_params):
        values = {}
        for name, site in self._prototype_trace.items():
            if name not in self._gibbs_sites:
                continue
            if init_params and name in init_params:
                values[name] = init_params.pop(name)
            else:
                values[name] = site["value"]
        return values

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
             num_chains=None):
        model_kwargs = {} if model_kwargs is None else model_kwargs.copy()
        self._chain_mode = num_chains is not None
        state = self._init_batched(
            rng_key, num_chains or 1, num_warmup, init_params, model_args, model_kwargs
        )
        return state if self._chain_mode else _unbatched(state)

    def _init_batched(self, rng_key, num_chains, num_warmup, init_params, model_args,
                      model_kwargs):
        self._prototype(getattr(rng_key, "generator", rng_key), model_args, model_kwargs)
        gibbs_values = self._initial_gibbs_values(init_params)
        gibbs_panel = tree_map(
            lambda x: x.expand((num_chains,) + tuple(x.shape)).clone(), gibbs_values
        )
        inner_kwargs = model_kwargs.copy()
        inner_kwargs["_gibbs_sites"] = gibbs_values  # shared at init
        hmc_state = self.inner_kernel.init(
            rng_key, num_warmup, init_params, model_args, inner_kwargs, num_chains=num_chains
        )
        z = {**gibbs_panel, **hmc_state.z}
        return HMCGibbsState(z, hmc_state, rng_key)

    def _value_and_grad(self, z_hmc, per_chain, model_args, model_kwargs):
        """Potential and gradient of every chain under its own conditioning
        (``per_chain``: the keyword arguments of one chain's potential), in
        forward mode where the inner kernel asks for it."""

        def pe_fn(z_c, per_chain_c):
            potential = self.inner_kernel._potential_fn_gen(
                *model_args, **per_chain_c, **model_kwargs
            )
            return potential(z_c)

        return infer_util.batched_value_and_grad(
            pe_fn, forward_mode=self.inner_kernel._forward_mode_differentiation
        )(z_hmc, per_chain)

    def sample(self, state, model_args, model_kwargs):
        model_kwargs = {} if model_kwargs is None else model_kwargs
        if not self._chain_mode:
            state = _batched(state)
        state = self._sample_batched(state, model_args, model_kwargs)
        return state if self._chain_mode else _unbatched(state)

    def _sample_batched(self, state, model_args, model_kwargs):
        z_gibbs = {k: v for k, v in state.z.items() if k not in state.hmc_state.z}
        z_hmc = {k: v for k, v in state.z.items() if k in state.hmc_state.z}

        def constrain(z_c, z_gibbs_c):
            # one chain: a model replay (deterministic sites) sees no chain axis
            mk = dict(model_kwargs)
            mk["_gibbs_sites"] = z_gibbs_c
            return self.inner_kernel.postprocess_fn(model_args, mk)(z_c)

        constrained = torch.func.vmap(constrain, randomness="different")(z_hmc, z_gibbs)
        generator = getattr(state.rng_key, "generator", state.rng_key)
        if not self._chain_mode:
            new = self._gibbs_fn(
                rng_key=generator, gibbs_sites=_unbatched(z_gibbs),
                hmc_sites=_unbatched(constrained),
            )
            z_gibbs = _batched(new)
        else:
            z_gibbs = self._gibbs_fn(rng_key=generator, gibbs_sites=z_gibbs, hmc_sites=constrained)
        per_chain = {"_gibbs_sites": z_gibbs}
        # the potential and its gradient under the new conditioning
        pe, grad = self._value_and_grad(state.hmc_state.z, per_chain, model_args, model_kwargs)
        hmc_state = state.hmc_state._replace(z_grad=grad, potential_energy=pe)
        inner_kwargs = dict(model_kwargs)
        inner_kwargs["_per_chain"] = per_chain
        hmc_state = self.inner_kernel.sample(hmc_state, model_args, inner_kwargs)
        z = {**z_gibbs, **hmc_state.z}
        return HMCGibbsState(z, hmc_state, state.rng_key)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_prototype_trace"] = None
        return state


# ---------------------------------------------------------------------------
# Discrete-site conditionals


def _site_element_layout(support_sizes):
    """Flatten {site: per-element support size} into host-side arrays."""
    names = sorted(support_sizes)
    sizes = np.concatenate(
        [np.asarray(support_sizes[k]).reshape(-1) for k in names]
    ).astype(np.int32)
    return names, sizes


def _one_hot_set(flat, idx, value):
    """``flat[c, idx[c]] = value[c]`` for every chain, by a select (no
    scatter)."""
    pos = torch.arange(flat.shape[-1], device=flat.device)
    return torch.where(pos == idx[:, None], value[:, None].to(flat.dtype), flat)


def _element_proposal(pe_cand, pe_one, draws, flat, pe, idx, size, smax, mode):
    """Propose a new value for discrete element ``idx`` ``(C,)`` of every
    chain's flat discrete values ``flat`` ``(C, n)``, whose support size is
    ``size`` ``(C,)``.

    Returns ``(flat_prop, pe_prop, log_ratio)``, ``log_ratio`` the MH
    log-acceptance ratio (0 for the exact conditional of ``"gibbs"``, which
    needs no correction).  The conditional modes evaluate every candidate
    value of every chain in one batched call: ``pe_cand`` maps ``(C, smax,
    n)`` candidates to ``(C, smax)`` potentials; ``pe_one`` maps ``(C, n)``
    to ``(C,)``.  A categorical draw is the argmax of its logits plus
    ``draws.gumbels``, as ``jax.random.categorical`` draws it.

    ``mode``: ``"gibbs"`` (exact conditional), ``"modified-gibbs"``
    (never-stay), ``"rw"`` (uniform), ``"modified-rw"`` (uniform over the
    other values)."""
    c, n = flat.shape
    rows = torch.arange(c, device=flat.device)
    cur = flat[rows, idx]
    if mode in ("gibbs", "modified-gibbs"):
        cand = torch.arange(smax, device=flat.device)
        pos = torch.arange(n, device=flat.device)
        z_cand = torch.where(
            pos[None, None, :] == idx[:, None, None],
            cand[None, :, None].to(flat.dtype),
            flat[:, None, :],
        )
        pe_c = pe_cand(z_cand)
        logw = torch.where(cand[None, :] < size[:, None], -pe_c, -torch.inf)
        logw = torch.where(torch.isnan(logw), -torch.inf, logw)
        gumbel = draws.gumbels((c, smax), pe)
        if mode == "gibbs":
            new = torch.argmax(gumbel + logw, -1)
            return _one_hot_set(flat, idx, new), pe_c[rows, new], torch.zeros_like(pe)
        # never-stay proposal: q(z'|z) proportional to w(z') over z' != z, so
        # the MH ratio is the sum of w over k != z against that over k != z'
        logw_others = torch.where(cand[None, :] == cur[:, None], -torch.inf, logw)
        prop = torch.argmax(gumbel + logw_others, -1)
        log_fwd = torch.logsumexp(logw_others, -1)
        log_bwd = torch.logsumexp(torch.where(cand[None, :] == prop[:, None], -torch.inf, logw), -1)
        return _one_hot_set(flat, idx, prop), pe_c[rows, prop], log_fwd - log_bwd
    if mode == "rw":
        prop = draws.randints(0, size, (c,), pe)
    else:  # modified-rw: uniform over the other values (symmetric)
        raw = draws.randints(0, size - 1, (c,), pe)
        prop = torch.where(raw >= cur, raw + 1, raw)
    flat_prop = _one_hot_set(flat, idx, prop)
    pe_prop = pe_one(flat_prop)
    pe_prop = torch.where(torch.isnan(pe_prop), torch.inf, pe_prop)
    return flat_prop, pe_prop, pe - pe_prop


def _discrete_sweep(pe_cand, pe_one, draws, z_flat, pe, sizes, *, mode, smax):
    """One Metropolis-within-Gibbs sweep over every discrete element of every
    chain, each chain visiting its elements in its own random order
    (``draws.permutations``); per element the proposal's draws, then
    ``draws.uniforms((C,))`` for the accept test.  ``sizes`` is the support
    size of each element, a ``(n,)`` tensor."""
    c, nd = z_flat.shape
    order = draws.permutations((c, nd), pe)
    flat = z_flat
    for j in range(nd):
        idx = order[:, j]
        flat_prop, pe_prop, log_ratio = _element_proposal(
            pe_cand, pe_one, draws, flat, pe, idx, sizes[idx], smax, mode
        )
        take = torch.log(draws.uniforms((c,), pe)) < log_ratio
        flat = torch.where(take[:, None], flat_prop, flat)
        pe = torch.where(take, pe_prop, pe)
    return flat, pe


class DiscreteHMCGibbs(HMCGibbs):
    """Metropolis-within-Gibbs over the model's discrete latent sites with
    enumerable support, and the inner HMC/NUTS over the rest.  A discrete site
    marked ``infer={"enumerate": "parallel"}`` stays with the inner kernel,
    which sums it out.

    A transition visits every discrete element of every chain in turn (a
    random order per chain): with N discrete elements it makes N batched
    evaluations of the potential, each over all chains and, in the
    conditional modes, all candidate values at once (``vmap`` over chains of
    ``vmap`` over candidates), then the inner kernel's transition.

    :param random_walk: propose uniformly (``True``) instead of from the exact
        conditional.
    :param modified: never propose the current value."""

    def __init__(self, inner_kernel, *, random_walk=False, modified=False):
        super().__init__(inner_kernel, identity, None)
        self._random_walk = random_walk
        self._modified = modified
        self._mode = {
            (False, False): "gibbs",
            (False, True): "modified-gibbs",
            (True, False): "rw",
            (True, True): "modified-rw",
        }[(random_walk, modified)]
        self._gibbs_layout = None

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
             num_chains=None):
        model_kwargs = {} if model_kwargs is None else model_kwargs.copy()
        tr = self._prototype(getattr(rng_key, "generator", rng_key), model_args, model_kwargs)
        discrete = {
            name: site for name, site in tr.items()
            if site["type"] == "sample" and not site["is_observed"]
            and site["fn"].has_enumerate_support
        }
        self._gibbs_sites = [
            name for name, site in discrete.items()
            if site["infer"].get("enumerate", "") != "parallel"
        ]
        assert self._gibbs_sites, "Cannot detect any discrete latent variables."
        self._support_sizes = {
            name: np.broadcast_to(
                discrete[name]["fn"].enumerate_support(False).shape[0],
                tuple(discrete[name]["value"].shape),
            )
            for name in self._gibbs_sites
        }
        self._gibbs_layout = core.FlatLayout(
            {name: tr[name]["value"] for name in self._gibbs_sites}
        )
        return super().init(rng_key, num_warmup, init_params, model_args, model_kwargs,
                            num_chains=num_chains)

    def _chain_potential(self, model_args, model_kwargs):
        """The potential of one chain: (gibbs values, hmc sites) -> scalar."""

        def pe(z_gibbs_c, z_hmc_c):
            return self.inner_kernel._potential_fn_gen(
                *model_args, _gibbs_sites=z_gibbs_c, **model_kwargs
            )(z_hmc_c)

        return pe

    def _candidate_potentials(self, model_args, model_kwargs, z_hmc):
        """``(pe_cand, pe_one)`` of :func:`_element_proposal` at the chains'
        continuous values ``z_hmc`` (a dict of ``(C, ...)`` tensors or a
        ``(C, D)`` panel with ``unravel``)."""
        pe = self._chain_potential(model_args, model_kwargs)
        unravel = self._gibbs_layout.unravel_one

        def one(flat_c, z_hmc_c):
            return pe(unravel(flat_c), z_hmc_c)

        pe_one = infer_util.batched_value(one)
        pe_cand = infer_util.batched_value(torch.func.vmap(one, in_dims=(0, None)))
        return (lambda cand: pe_cand(cand, z_hmc)), (lambda flat: pe_one(flat, z_hmc))

    def _sample_batched(self, state, model_args, model_kwargs):
        draws = core.as_draws(state.rng_key)
        z_gibbs = {k: v for k, v in state.z.items() if k not in state.hmc_state.z}
        z_hmc = {k: v for k, v in state.z.items() if k in state.hmc_state.z}
        names, sizes_np = _site_element_layout(self._support_sizes)
        layout = self._gibbs_layout
        pe_cand, pe_one = self._candidate_potentials(model_args, model_kwargs, z_hmc)
        pe = state.hmc_state.potential_energy
        flat, pe = _discrete_sweep(
            pe_cand, pe_one, draws, layout.ravel_batch(z_gibbs), pe,
            torch.as_tensor(sizes_np, dtype=torch.int64, device=pe.device),
            mode=self._mode, smax=int(sizes_np.max()),
        )
        z_gibbs = layout.unravel_batch(flat)
        per_chain = {"_gibbs_sites": z_gibbs}
        # the gradient under the new conditioning (the potential is exact)
        _, grad = self._value_and_grad(state.hmc_state.z, per_chain, model_args, model_kwargs)
        hmc_state = state.hmc_state._replace(z_grad=grad, potential_energy=pe)
        inner_kwargs = dict(model_kwargs)
        inner_kwargs["_per_chain"] = per_chain
        hmc_state = self.inner_kernel.sample(hmc_state, model_args, inner_kwargs)
        z = {**z_gibbs, **hmc_state.z}
        return HMCGibbsState(z, hmc_state, state.rng_key)


# ---------------------------------------------------------------------------
# HMCECS


def _wrap_gibbs_state(model, *args, **kwargs):
    msg = {"type": "_gibbs_state", "value": kwargs.pop("_gibbs_state", ())}
    primitives.apply_stack(msg)
    panels = kwargs.pop("_subsample_panels", None)
    latents = kwargs.pop("_lean_shard_latents", None)
    if panels is None and latents is not None:
        panels = _lean_shard_panels(model, latents, args, kwargs)
    if panels is not None:
        # announce the panels to the estimator (for the proxy's pointwise
        # re-evaluations) and replay them in place of in-potential gathers
        primitives.apply_stack({"type": "_subsample_panels", "value": panels})
        with subsample_panels(panels=panels):
            return model(*args, **kwargs)
    return model(*args, **kwargs)


def _lean_shard_panels(model, latents, args, kwargs):
    """The panels of one potential evaluation in lean mode on data shards:
    every subsample plate's masked local gather, recorded in one pass of the
    model (``latents`` in place of its latent sites, so that nothing draws),
    and summed over the data group in one ``all_reduce`` for all of them
    and every chain (``parallel.mesh.sum_partial_panels`` inside the
    ``vmap``).  The evaluation then replays them, as carry mode replays its
    carried panels."""
    out, groups = [], []
    with block(), subsample_panels(record=True, out=out, groups=groups), \
            substitute(data=latents):
        model(*args, **kwargs)
    return sum_partial_panels(out, groups)


def _holds_data_shard(tree):
    """Whether a leaf of the model's arguments holds a rank's rows of a
    data shard."""
    found = []

    def visit(x):
        shard = shard_of(x)
        if shard is not None and shard.partial:
            found.append(x)
        return x

    tree_map(visit, tree)
    return bool(found)


class HMCECS(HMCGibbs):
    """HMC with Energy-Conserving Subsampling: per-chain subsample index
    panels, a batched block refresh and a batched pseudo-marginal accept
    (Dang et al. 2019, Tran et al. 2017, Quiroz et al. 2018).

    ``panel_mode``: ``"carry"`` keeps the gathered ``(chains, m, ...)`` data
    panels in the kernel state (one gather per Gibbs step), ``"bf16"`` carries
    them at half width, ``"lean"`` carries nothing and gathers inside every
    potential evaluation; ``"auto"`` picks by the panels' size against the
    device's memory.  The modes a run resolved are in ``resolved_modes``."""

    def __init__(
        self,
        inner_kernel,
        *,
        num_blocks=1,
        proxy=None,
        collect_subsample_indices=False,
        panel_mode="auto",
    ):
        if panel_mode not in ("auto", "carry", "bf16", "lean"):
            raise ValueError("panel_mode must be auto|carry|bf16|lean")
        super().__init__(inner_kernel, identity, None)
        self._collect_subsample_indices = collect_subsample_indices
        self._panel_mode = panel_mode
        self._panel_mode_resolved = None
        self._lean_on_shards = False
        self.inner_kernel._model = partial(_wrap_gibbs_state, self.inner_kernel._model)
        # the pristine wrapped model: init() layers the subsample estimator on
        # top of THIS each time, so that re-initialization is idempotent
        self._base_inner_model = self.inner_kernel._model
        self._num_blocks = num_blocks
        self._proxy = proxy
        self._proxy_update = None
        self._update_takes_panels = False
        self._has_proxy = False
        self.resolved_modes = {}

    def postprocess_fn(self, args, kwargs):
        def fn(z):
            model_kwargs = {} if kwargs is None else kwargs.copy()
            gibbs_sites = {k: v for k, v in z.items() if k in self._gibbs_sites}
            hmc_sites = {k: v for k, v in z.items() if k not in self._gibbs_sites}
            model_kwargs["_gibbs_sites"] = gibbs_sites
            out = self.inner_kernel.postprocess_fn(args, model_kwargs)(hmc_sites)
            if self._collect_subsample_indices:
                out = {**gibbs_sites, **out}
            return out

        return fn

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
             num_chains=None):
        model_kwargs = {} if model_kwargs is None else model_kwargs.copy()
        batched = num_chains is not None
        c = num_chains if batched else 1
        tr = self._prototype(getattr(rng_key, "generator", rng_key), model_args, model_kwargs)
        self._subsample_plate_sizes = {
            name: site["args"]
            for name, site in tr.items()
            if site["type"] == "plate"
            and site["args"][1] is not None
            and site["args"][0] > site["args"][1]
        }
        self._gibbs_sites = list(self._subsample_plate_sizes)
        assert self._gibbs_sites, "Cannot detect any subsample statements in the model."
        replays = any(site["type"] == "deterministic" for site in tr.values())
        if not (self._collect_subsample_indices or replays):
            # the (chains, subsample) index panels stay out of the collected
            # samples (they remain on last_state.z), unless the replay of the
            # model's deterministic sites needs each draw's subsample;
            # postprocess_fn drops them then
            self.collect_exclude_sites = tuple(self._gibbs_sites)
        self._proto_latents = {
            name: site["value"] for name, site in tr.items()
            if site["type"] == "sample" and not site["is_observed"]
        }
        if self._proxy is not None:
            if any(
                site["type"] == "sample"
                and not site["is_observed"]
                and site["fn"].support.is_discrete
                for site in tr.values()
            ):
                raise RuntimeError(
                    "The likelihood proxy does not support models with "
                    "discrete latent sites."
                )
            extra_hints = {}
            try:
                sig = inspect.signature(self._proxy)
                if "num_chains" in sig.parameters or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
                ):
                    extra_hints["num_chains"] = c
            except (TypeError, ValueError):  # builtins / odd callables
                pass
            # the proxy gets the pristine wrapped model: its pointwise
            # evaluations must not recurse into the estimator
            proxy_fn, proxy_init, self._proxy_update = self._proxy(
                tr,
                self._subsample_plate_sizes,
                self._base_inner_model,
                model_args,
                model_kwargs.copy(),
                num_blocks=self._num_blocks,
                **extra_hints,
            )
            self.inner_kernel._model = subsample_estimator(
                self._base_inner_model, self._subsample_plate_sizes, proxy_fn
            )
            self.resolved_modes["proxy"] = getattr(proxy_fn, "mode", None)
            self._update_takes_panels = "panels_of" in inspect.signature(
                self._proxy_update).parameters
        else:
            proxy_init, self._proxy_update = None, None
            self.inner_kernel._model = self._base_inner_model
        self._has_proxy = proxy_init is not None

        proto_idx = {name: tr[name]["value"] for name in self._gibbs_sites}

        def panel(x):
            return x.expand((c,) + tuple(x.shape)).clone()

        idx_panel = tree_map(panel, proto_idx)
        # every chain starts at the prototype's indices: the proxy's
        # statistics there are computed once, for one chain
        one_state = proxy_init(proto_idx, model_args, model_kwargs) if self._has_proxy else ()
        gibbs_state = tree_map(panel, one_state)
        self._resolve_panel_mode(proto_idx, model_args, model_kwargs, c)
        # lean on data shards: each evaluation gathers its panels at once
        self._lean_on_shards = self._panel_mode_resolved == "lean" and _holds_data_shard(
            (model_args, model_kwargs))
        if self._panel_mode_resolved == "lean":
            panels = ()
            if self._lean_on_shards:
                model_kwargs["_lean_shard_latents"] = self._proto_latents
        else:
            whole = self._record_panels(idx_panel, model_args, model_kwargs)
            panels = self._cast_panels(whole)
            # the init's evaluations replay the prototype's panels, at the
            # data's own width as a gather would give them
            model_kwargs["_subsample_panels"] = _unbatched(whole)

        model_kwargs["_gibbs_state"] = one_state
        state = super().init(
            rng_key, num_warmup, init_params, model_args, model_kwargs, num_chains=num_chains
        )
        like = state.hmc_state.potential_energy
        accept = torch.zeros_like(like)
        if not batched:
            gibbs_state, panels = _unbatched(gibbs_state), _unbatched(panels)
        return HMCECSState(state.z, state.hmc_state, state.rng_key, gibbs_state, accept, panels)

    def _resolve_panel_mode(self, proto_idx, model_args, model_kwargs, num_chains):
        """Pick carry/bf16/lean for ``panel_mode="auto"`` from the size of the
        carried panels (three copies, old, refreshed and selected, are live
        inside one Gibbs step) against the device's memory."""
        mode = self._panel_mode
        if mode == "auto":
            one, _ = self._record_partial_panels(_batched(proto_idx), model_args, model_kwargs)
            per_chain = sum(x.numel() * x.element_size() for x in one)
            est = 3 * num_chains * per_chain
            device = one[0].device if one else "cpu"
            budget = _device_memory_bytes(device)
            if est <= 0.15 * budget:
                mode = "carry"
            elif est / 2 <= 0.15 * budget:
                mode = "bf16"
            else:
                mode = "lean"
        self._panel_mode_resolved = mode
        self.resolved_modes["panel"] = mode

    def _record_partial_panels(self, z_gibbs, model_args, model_kwargs, axes=None):
        """Every subsample plate's data panels for the given per-chain index
        sets, each with the data group it still has to be summed over (a
        data shard's rows) or ``None``.  The model runs under ``vmap`` with
        the prototype's latent values, so no site draws and every take
        becomes one batched gather."""
        groups = []

        def one(zg):
            out = []
            groups.clear()
            if axes is not None:
                axes.clear()
            with block(), subsample_panels(record=True, out=out, groups=groups, axes=axes), \
                    substitute(data=self._proto_latents):
                self._base_inner_model(*model_args, _gibbs_sites=zg, **model_kwargs)
            return tuple(out)

        return torch.func.vmap(one)(z_gibbs), groups

    def _record_panels(self, z_gibbs, model_args, model_kwargs, axes=None):
        """Gather every subsample plate's data panels once for the given
        per-chain index sets, at the data's width; potential evaluations
        replay them.  Panels taken from data shards are summed over their
        data group after the ``vmap``: one ``all_reduce`` for all of them,
        which makes them the whole data's panels bit for bit."""
        return sum_partial_panels(*self._record_partial_panels(
            z_gibbs, model_args, model_kwargs, axes=axes))

    def _cast_panels(self, panels):
        """The panels as the state carries them: floats at half width in
        ``bf16`` mode."""
        if self._panel_mode_resolved != "bf16":
            return panels
        return tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x, panels)

    def _sample_batched(self, state, model_args, model_kwargs):
        draws = core.as_draws(state.rng_key)
        z_gibbs = {k: v for k, v in state.z.items() if k not in state.hmc_state.z}

        # propose a block refresh of each chain's subsample indices; the
        # proxy takes its replacements' panels from the new panels, so that
        # one gather (one sum over a data group) serves the step
        lean = self._panel_mode_resolved == "lean"
        recorded = []

        def panels_of(idx):
            axes = []
            recorded.append(self._record_panels(idx, model_args, model_kwargs, axes=axes))
            return recorded[-1], axes

        if self._has_proxy:
            kwargs = {} if lean or not self._update_takes_panels else {"panels_of": panels_of}
            z_gibbs_new, gibbs_state_new = self._proxy_update(
                draws, z_gibbs, state.gibbs_state, model_args, model_kwargs, **kwargs
            )
        else:
            z_gibbs_new, gibbs_state_new = block_update(
                self._subsample_plate_sizes, self._num_blocks, draws, z_gibbs, state.gibbs_state
            )

        # batched pseudo-marginal MH on the likelihood-estimator difference
        if self._lean_on_shards:
            # the evaluations gather their panels; the proxy's update has
            # gathered its own above
            model_kwargs = {**model_kwargs, "_lean_shard_latents": self._proto_latents}
        per_chain_new = {"_gibbs_sites": z_gibbs_new, "_gibbs_state": gibbs_state_new}
        if not lean:
            # one gather per step: the whole inner trajectory replays it
            whole = recorded[0] if recorded else self._record_panels(
                z_gibbs_new, model_args, model_kwargs)
            per_chain_new["_subsample_panels"] = self._cast_panels(whole)
        pe = state.hmc_state.potential_energy
        pe_new, grad_new = self._value_and_grad(
            state.hmc_state.z, per_chain_new, model_args, model_kwargs
        )
        accept_prob = torch.exp(torch.clamp(pe - pe_new, max=0.0))
        take = torch.log(draws.uniform(pe)) < (pe - pe_new)

        per_chain_old = {"_gibbs_sites": z_gibbs, "_gibbs_state": state.gibbs_state}
        if not lean:
            per_chain_old["_subsample_panels"] = state.panels
        per_chain = _select(take, per_chain_new, per_chain_old)
        hmc_state = state.hmc_state._replace(
            z_grad=_select(take, grad_new, state.hmc_state.z_grad),
            potential_energy=torch.where(take, pe_new, pe),
        )
        inner_kwargs = dict(model_kwargs)
        inner_kwargs["_per_chain"] = per_chain
        hmc_state = self.inner_kernel.sample(hmc_state, model_args, inner_kwargs)
        z = {**per_chain["_gibbs_sites"], **hmc_state.z}
        return HMCECSState(
            z, hmc_state, state.rng_key, per_chain["_gibbs_state"], accept_prob,
            per_chain.get("_subsample_panels", ()),
        )

    @staticmethod
    def taylor_proxy(reference_params, degree=2, mode="auto"):
        """Taylor-expansion control variate around MAP reference params; see
        :func:`numpyro_tpu_torch.contrib.ecs_proxies.taylor_proxy`."""
        return taylor_proxy(reference_params, degree, mode=mode)


# ---------------------------------------------------------------------------
# State carried across from the JAX package


def hmc_state_from_numpy(hs, device="cpu", rng_key=None):
    """The port's ``HMCState`` from a JAX ``HMCState`` given as numpy arrays
    (a dense or dict mass goes through ``hmc_core.adapt_from_numpy``)."""
    get = partial(infer_util.state_field, hs)
    to = partial(infer_util.tree_from_numpy, device=device)
    traj = get("trajectory_length")
    return HMCState(
        int(get("i")), to(dict(get("z"))), to(dict(get("z_grad"))), to(get("potential_energy")),
        to(get("energy")), None, float(traj) if traj is not None else None,
        to(get("num_steps")).to(torch.int32), to(get("accept_prob")),
        to(get("mean_accept_prob")), to(get("diverging")),
        core.adapt_from_numpy(get("adapt_state"), device), rng_key,
    )


def gibbs_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``HMCGibbsState`` (of ``HMCGibbs`` or ``DiscreteHMCGibbs``)
    from a JAX one whose leaves are numpy arrays; JAX's keys are dropped:
    ``rng_key`` is the generator or draw source of both the outer and the
    inner state.  Discrete values become ``int64``."""
    get = partial(infer_util.state_field, fields)
    return HMCGibbsState(
        infer_util.tree_from_numpy(dict(get("z")), device),
        hmc_state_from_numpy(get("hmc_state"), device, rng_key),
        rng_key,
    )


def ecs_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``HMCECSState`` from a JAX ``HMCECSState`` whose leaves are
    numpy arrays (namedtuples or mappings, as ``jax.tree.map(np.asarray,
    state)`` gives them), so that both packages can step from one state.
    JAX's keys are dropped: ``rng_key`` is the generator or draw source the
    port's state carries instead.  Subsample indices become ``int64``; a dense
    or dict mass goes through ``hmc_core.adapt_from_numpy``."""
    get = partial(infer_util.state_field, fields)
    to = partial(infer_util.tree_from_numpy, device=device)
    gs = get("gibbs_state")
    if isinstance(gs, tuple) and len(gs) == 0:
        gibbs_state = ()
    else:
        gibbs_state = TaylorProxyStats(to(dict(infer_util.state_field(gs, "value"))),
                                       to(dict(infer_util.state_field(gs, "grad"))))
    return HMCECSState(
        to(dict(get("z"))), hmc_state_from_numpy(get("hmc_state"), device, rng_key),
        rng_key, gibbs_state, to(get("accept_prob")), to(get("panels")),
    )