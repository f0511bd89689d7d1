"""Gibbs-composed HMC kernels, natively chain-batched (port of ``HMCGibbs``
and ``HMCECS`` from ``numpyro_tpu/infer/hmc_gibbs.py``; ``DiscreteHMCGibbs``
is not ported yet, see ROADMAP.md).

- The outer Gibbs state (site values, subsample index panels, proxy
  statistics, data panels) carries a leading chain axis; a single chain is
  ``C == 1`` squeezed at the API boundary.
- Conditioning reaches the inner kernel's potential through
  ``model_kwargs["_per_chain"]`` (see ``hmc.py``): each chain's leapfrog
  gradient sees its own Gibbs values and subsample indices.
- Where the JAX package maps a per-chain function over one key per chain, the
  port works on all chains at once and draws ``(C, ...)`` tensors from one
  draw source (``hmc_core.GeneratorDraws``): the block refresh, the
  pseudo-marginal accept, and a user's ``gibbs_fn``, which is called once with
  chain-batched sites and the run's ``torch.Generator``.
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
from numpyro_tpu_torch.util import identity, tree_map

__all__ = [
    "DiscreteHMCGibbs", "HMCECS", "HMCECSState", "HMCGibbs", "HMCGibbsState",
    "ecs_state_from_numpy",
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


class DiscreteHMCGibbs(HMCGibbs):
    """Metropolis-within-Gibbs over discrete sites: not ported yet."""

    def __init__(self, inner_kernel, *, random_walk=False, modified=False):
        raise NotImplementedError(
            "DiscreteHMCGibbs is not ported to numpyro_tpu_torch yet (see ROADMAP.md)"
        )


# ---------------------------------------------------------------------------
# HMCECS


def _wrap_gibbs_state(model, *args, **kwargs):
    msg = {"type": "_gibbs_state", "value": kwargs.pop("_gibbs_state", ())}
    primitives.apply_stack(msg)
    panels = kwargs.pop("_subsample_panels", None)
    if panels is not None:
        # announce the panels to the estimator (for the proxy's pointwise
        # re-evaluations) and replay them in place of in-potential gathers
        primitives.apply_stack({"type": "_subsample_panels", "value": panels})
        with subsample_panels(panels=panels):
            return model(*args, **kwargs)
    return model(*args, **kwargs)


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
        self.inner_kernel._model = partial(_wrap_gibbs_state, self.inner_kernel._model)
        # the pristine wrapped model: init() layers the subsample estimator on
        # top of THIS each time, so that re-initialization is idempotent
        self._base_inner_model = self.inner_kernel._model
        self._num_blocks = num_blocks
        self._proxy = proxy
        self._proxy_update = None
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
        else:
            proxy_init, self._proxy_update = None, None
            self.inner_kernel._model = self._base_inner_model
        self._has_proxy = proxy_init is not None

        proto_idx = {name: tr[name]["value"] for name in self._gibbs_sites}
        idx_panel = tree_map(lambda x: x.expand((c,) + tuple(x.shape)).clone(), proto_idx)
        if self._has_proxy:
            gibbs_state = torch.func.vmap(
                lambda idx: proxy_init(idx, model_args, model_kwargs)
            )(idx_panel)
        else:
            gibbs_state = ()
        self._resolve_panel_mode(proto_idx, model_args, model_kwargs, c)
        if self._panel_mode_resolved == "lean":
            panels = ()
        else:
            panels = self._record_panels(idx_panel, model_args, model_kwargs)

        model_kwargs["_gibbs_state"] = _unbatched(gibbs_state) if self._has_proxy else ()
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
            one = self._record_panels(_batched(proto_idx), model_args, model_kwargs, cast=False)
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

    def _record_panels(self, z_gibbs, model_args, model_kwargs, cast=True):
        """Gather every subsample plate's data panels once for the given
        per-chain index sets; potential evaluations replay them.  The model
        runs under ``vmap`` with the prototype's latent values, so no site
        draws and every take becomes one batched gather."""

        def one(zg):
            out = []
            with block(), subsample_panels(record=True, out=out), substitute(
                data=self._proto_latents
            ):
                self._base_inner_model(*model_args, _gibbs_sites=zg, **model_kwargs)
            return tuple(out)

        panels = torch.func.vmap(one)(z_gibbs)
        if cast and self._panel_mode_resolved == "bf16":
            panels = tree_map(
                lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x, panels
            )
        return panels

    def _sample_batched(self, state, model_args, model_kwargs):
        draws = core.as_draws(state.rng_key)
        z_gibbs = {k: v for k, v in state.z.items() if k not in state.hmc_state.z}

        # propose a block refresh of each chain's subsample indices
        if self._has_proxy:
            z_gibbs_new, gibbs_state_new = self._proxy_update(
                draws, z_gibbs, state.gibbs_state, model_args, model_kwargs
            )
        else:
            z_gibbs_new, gibbs_state_new = block_update(
                self._subsample_plate_sizes, self._num_blocks, draws, z_gibbs, state.gibbs_state
            )

        # batched pseudo-marginal MH on the likelihood-estimator difference
        lean = self._panel_mode_resolved == "lean"
        per_chain_new = {"_gibbs_sites": z_gibbs_new, "_gibbs_state": gibbs_state_new}
        if not lean:
            # one gather per step: the whole inner trajectory replays it
            per_chain_new["_subsample_panels"] = self._record_panels(
                z_gibbs_new, model_args, model_kwargs
            )
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


def _get(fields, name):
    return fields[name] if isinstance(fields, dict) else getattr(fields, name)


def ecs_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``HMCECSState`` from a JAX ``HMCECSState`` whose leaves are
    numpy arrays (namedtuples or mappings, as ``jax.tree.map(np.asarray,
    state)`` gives them), so that both packages can step from one state.
    JAX's keys are dropped: ``rng_key`` is the generator or draw source the
    port's state carries instead.  Subsample indices become ``int64``; a dense
    or dict mass goes through ``hmc_core.adapt_from_numpy``."""

    def to(x):
        if x is None:
            return None
        t = torch.from_numpy(np.array(x))
        if t.dtype in (torch.int32, torch.int16, torch.uint8):
            t = t.to(torch.int64)
        return t.to(device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(tree(v) for v in x)
        return to(x)

    hs = _get(fields, "hmc_state")
    adapt_t = core.adapt_from_numpy(_get(hs, "adapt_state"), device)
    z = tree(dict(_get(fields, "z")))
    hmc_state = HMCState(
        int(_get(hs, "i")),
        tree(dict(_get(hs, "z"))),
        tree(dict(_get(hs, "z_grad"))),
        to(_get(hs, "potential_energy")),
        to(_get(hs, "energy")),
        None,
        float(_get(hs, "trajectory_length")) if _get(hs, "trajectory_length") is not None else None,
        to(_get(hs, "num_steps")).to(torch.int32),
        to(_get(hs, "accept_prob")),
        to(_get(hs, "mean_accept_prob")),
        to(_get(hs, "diverging")),
        adapt_t,
        rng_key,
    )
    gs = _get(fields, "gibbs_state")
    if isinstance(gs, tuple) and len(gs) == 0:
        gibbs_state = ()
    else:
        gibbs_state = TaylorProxyStats(tree(dict(_get(gs, "value"))), tree(dict(_get(gs, "grad"))))
    return HMCECSState(
        z, hmc_state, rng_key, gibbs_state, to(_get(fields, "accept_prob")),
        tree(_get(fields, "panels")),
    )
