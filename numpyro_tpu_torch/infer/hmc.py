"""HMC / NUTS kernels on the chain-batched engine (port of
``numpyro_tpu/infer/hmc.py``).

Two ways to run a kernel:

- :meth:`HMC.fused_run`: warmup and sampling for all chains, with the
  asynchronous harvest loop of :mod:`numpyro_tpu_torch.infer.hmc_core` (the
  path that ``MCMC`` takes for plain ``HMC``/``NUTS``).
- the per-step API, ``init`` then ``sample`` once per transition, on
  ``(C, ...)`` state panels; a single chain is ``C == 1`` with the chain axis
  squeezed at the boundary.  The Gibbs-composed kernels stand on it: they
  hand each chain its own conditioning through ``model_kwargs["_per_chain"]``.

The step index ``i`` of a state is a host integer, so the JAX package's
``lax.cond(i < num_warmup, ...)`` is a plain ``if``.  ``rng_key`` is a
``torch.Generator`` or a draw source (see ``hmc_core.GeneratorDraws``).
Every entry point keeps f32 matmuls out of TF32
(``infer.util.pin_full_f32_matmul``).
"""

from __future__ import annotations

import math
import time
from collections import namedtuple

import torch

from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.infer.mcmc import MCMCKernel
from numpyro_tpu_torch.infer.util import ParamInfo, initialize_model
from numpyro_tpu_torch.util import identity, tree_map

__all__ = ["HMC", "HMCState", "NUTS", "hmc", "momentum_generator"]

HMCState = namedtuple(
    "HMCState",
    [
        "i", "z", "z_grad", "potential_energy", "energy", "r", "trajectory_length",
        "num_steps", "accept_prob", "mean_accept_prob", "diverging", "adapt_state",
        "rng_key",
    ],
)
"""Kernel state (field parity with the JAX ``HMCState``).  In batched mode
every tensor leaf carries a leading chain axis; ``i`` is a host integer
(chains are transition-synchronous under the per-step API)."""

# the fields that carry the chain axis (``rng_key`` is one generator for all)
_CHAIN_FIELDS = (
    "z", "z_grad", "potential_energy", "energy", "num_steps", "accept_prob",
    "mean_accept_prob", "diverging", "adapt_state",
)


def momentum_generator(prototype_r, mass_matrix_sqrt, rng_key):
    """Draw ``r ~ N(0, M)`` in the form of ``prototype_r`` (a tensor or a
    dict of tensors, raveled in sorted order of its keys) from the square
    root of the mass matrix: a vector (diagonal mass), a matrix (dense), or a
    dict of either by tuple of site names (structured mass), whose blocks
    draw one after another from the generator ``rng_key``.  A helper for
    kernels outside the engine, which draws its momenta in ``(C, D)``
    panels."""
    if isinstance(mass_matrix_sqrt, dict):
        out = {}
        for names, block_sqrt in mass_matrix_sqrt.items():
            out.update(momentum_generator({k: prototype_r[k] for k in names}, block_sqrt, rng_key))
        return out
    if isinstance(prototype_r, dict):
        names = sorted(prototype_r)
        flat = torch.cat([prototype_r[k].reshape(-1) for k in names])
    else:
        flat = prototype_r.reshape(-1)
    eps = torch.randn(flat.shape, generator=rng_key, dtype=flat.dtype, device=flat.device)
    if mass_matrix_sqrt.dim() == 1:
        r = mass_matrix_sqrt * eps
    elif mass_matrix_sqrt.dim() == 2:
        r = mass_matrix_sqrt @ eps
    else:
        raise ValueError("mass_matrix_sqrt must be 1- or 2-dimensional")
    if not isinstance(prototype_r, dict):
        return r.reshape(prototype_r.shape)
    sizes = [prototype_r[k].numel() for k in names]
    return {k: part.reshape(prototype_r[k].shape) for k, part in zip(names, r.split(sizes))}


def _expand0(tree):
    return tree_map(lambda x: x[None], tree)


def _squeeze0(tree):
    return tree_map(lambda x: x[0], tree)


def _map_chain_fields(fn, state):
    return state._replace(**{f: fn(getattr(state, f)) for f in _CHAIN_FIELDS})


def hmc(potential_fn=None, potential_fn_gen=None, kinetic_fn=None, algo="NUTS"):
    """Functional ``(init_kernel, sample_kernel)`` factory on the
    chain-batched engine (surface parity: ``numpyro_tpu.infer.hmc.hmc``)."""
    if kinetic_fn is not None:
        raise NotImplementedError(
            "custom kinetic_fn is not supported by the chain-batched engine;"
            " the Euclidean kinetic energy is built in"
        )
    if algo not in ("HMC", "NUTS"):
        raise ValueError("`algo` must be one of `HMC`, `NUTS`.")
    if (potential_fn is None) == (potential_fn_gen is None):
        raise ValueError("Exactly one of `potential_fn` or `potential_fn_gen` must be given.")

    # static context shared between init and sample, filled by init_kernel
    ctx = {}

    def _pe_grad(model_args, model_kwargs):
        """Batched potential and gradient.  ``model_kwargs["_per_chain"]`` is
        a pytree of chain-batched conditioning (Gibbs site values, subsample
        index panels, proxy statistics) mapped by ``vmap`` beside the position
        panel: each chain's gradient sees its own conditioning."""
        model_kwargs = dict(model_kwargs or {})
        per_chain = model_kwargs.pop("_per_chain", None)
        layout, forward_mode = ctx["layout"], ctx["forward_mode"]
        if per_chain is None:
            pe_fn = potential_fn
            if potential_fn_gen is not None:
                pe_fn = potential_fn_gen(*model_args, **model_kwargs)
            return core.batched_potential(pe_fn, layout, forward_mode=forward_mode)
        return core.batched_potential(
            lambda pc: potential_fn_gen(*model_args, **model_kwargs, **pc), layout, per_chain,
            forward_mode=forward_mode,
        )

    def _build_warmup(pe_grad):
        return core.build_warmup(
            pe_grad,
            ctx["blocks"],
            ctx["num_warmup"],
            adapt_step_size=ctx["adapt_step_size"],
            adapt_mass_matrix=ctx["adapt_mass_matrix"],
            target_accept_prob=ctx["target_accept_prob"],
            regularize_mass_matrix=ctx["regularize_mass_matrix"],
            find_step_size=ctx["adapt_step_size"] and ctx["refine_step_size"],
            pool_chains=ctx["pooled_adaptation"],
        )

    def init_kernel(
        init_params,
        num_warmup,
        *,
        step_size=1.0,
        inverse_mass_matrix=None,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        num_steps=None,
        trajectory_length=2 * math.pi,
        max_tree_depth=10,
        find_heuristic_step_size=False,
        forward_mode_differentiation=False,
        regularize_mass_matrix=True,
        refine_step_size=True,
        pooled_adaptation=False,
        model_args=(),
        model_kwargs=None,
        rng_key=None,
        num_chains=None,
    ):
        """``num_chains=None`` is one chain with unbatched state; an integer
        is that many chains with a leading chain axis on every leaf.
        ``inverse_mass_matrix`` is a tensor or array for the sole mass block or
        a dict keyed by the blocks' site-name tuples (see
        ``hmc_core.init_mass``)."""
        infer_util.pin_full_f32_matmul()
        if isinstance(init_params, ParamInfo):
            z, pe, z_grad = init_params
        else:
            z, pe, z_grad = init_params, None, None
        batched = num_chains is not None
        c = num_chains if batched else 1
        if rng_key is None:
            raise ValueError("init_kernel needs an rng_key (a torch.Generator)")
        draws = core.as_draws(rng_key)
        leaves = [z[k] for k in sorted(z)]
        if batched and leaves and all(tuple(x.shape[:1]) == (c,) for x in leaves):
            z_proto = _squeeze0(z)
        else:
            # unbatched params: one chain, or the same start for every chain
            z_proto = z
            z = tree_map(lambda x: x.expand((c,) + tuple(x.shape)), z)
            if batched:
                pe, z_grad = None, None
            else:
                pe = None if pe is None else pe[None]
                z_grad = None if z_grad is None else _expand0(z_grad)

        layout = core.FlatLayout(z_proto)
        ctx.update(
            layout=layout,
            blocks=core.build_mass_blocks(layout, dense_mass),
            forward_mode=forward_mode_differentiation,
            batched=batched,
            num_warmup=num_warmup,
            max_tree_depth=(
                max_tree_depth if isinstance(max_tree_depth, tuple)
                else (max_tree_depth, max_tree_depth)
            ),
            trajectory_length=trajectory_length,
            fixed_num_steps=num_steps,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            target_accept_prob=target_accept_prob,
            regularize_mass_matrix=regularize_mass_matrix,
            refine_step_size=refine_step_size,
            pooled_adaptation=pooled_adaptation,
        )
        pe_grad = _pe_grad(model_args, model_kwargs)
        z_flat = layout.ravel_batch(z)
        if pe is None or z_grad is None:
            pe, grad_flat = pe_grad(z_flat)
        else:
            grad_flat = layout.ravel_batch(z_grad)
        # the warmup update is rebuilt by every sample call from its own
        # potential, which may carry that step's conditioning
        wa_init, _ = _build_warmup(pe_grad)
        adapt = wa_init(draws, z_flat, pe, grad_flat, step_size, inverse_mass_matrix)
        zero_f = torch.zeros_like(pe)
        state = HMCState(
            0,
            layout.unravel_batch(z_flat),
            layout.unravel_batch(grad_flat),
            pe,
            pe,
            None,
            trajectory_length,
            torch.zeros((c,), dtype=torch.int32, device=pe.device),
            zero_f,
            zero_f,
            torch.zeros((c,), dtype=torch.bool, device=pe.device),
            adapt,
            rng_key,
        )
        return state if batched else _map_chain_fields(_squeeze0, state)

    def sample_kernel(state, model_args=(), model_kwargs=None):
        """One transition for every chain: momentum refresh, trajectory,
        proposal, and warmup adaptation while ``i < num_warmup``."""
        infer_util.pin_full_f32_matmul()
        layout, blocks = ctx["layout"], ctx["blocks"]
        batched, num_warmup = ctx["batched"], ctx["num_warmup"]
        if not batched:
            state = _map_chain_fields(_expand0, state)
        pe_grad = _pe_grad(model_args, model_kwargs)
        z_flat = layout.ravel_batch(state.z)
        grad_flat = layout.ravel_batch(state.z_grad)
        draws = core.as_draws(state.rng_key)
        adapt_draws = draws.fork()
        adapt = state.adapt_state
        i = int(state.i)
        warming = i < num_warmup

        if algo == "NUTS":
            wa_depth, post_depth = ctx["max_tree_depth"]
            out = core.nuts_transition(
                pe_grad, blocks, draws, z_flat, state.potential_energy, grad_flat,
                adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt, adapt.step_size,
                wa_depth if warming else post_depth,
                k_slots=max(*ctx["max_tree_depth"], 1),
            )
        else:
            out = core.hmc_transition(
                pe_grad, blocks, draws, z_flat, state.potential_energy, grad_flat,
                adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt, adapt.step_size,
                trajectory_length=ctx["trajectory_length"],
                num_steps=ctx["fixed_num_steps"],
            )
        if warming:
            _, wa_update = _build_warmup(pe_grad)
            adapt = wa_update(i, adapt, out.accept_prob, out.z, out.pe, out.grad, adapt_draws)
        n = i + 1 if warming else i + 1 - num_warmup
        mean_accept = state.mean_accept_prob + (out.accept_prob - state.mean_accept_prob) / n
        new_state = HMCState(
            i + 1,
            layout.unravel_batch(out.z),
            layout.unravel_batch(out.grad),
            out.pe,
            out.energy,
            None,
            state.trajectory_length,
            out.num_steps,
            out.accept_prob,
            mean_accept,
            out.diverging,
            adapt,
            state.rng_key,
        )
        return new_state if batched else _map_chain_fields(_squeeze0, new_state)

    return init_kernel, sample_kernel


class HMC(MCMCKernel):
    """Hamiltonian Monte Carlo with a fixed trajectory length (constructor
    parity with the JAX ``HMC``), natively chain-batched."""

    _algo = "HMC"

    FUSED_FIELDS = (
        "z", "energy", "diverging", "num_steps", "accept_prob",
        "mean_accept_prob", "adapt_state.step_size",
    )

    def __init__(
        self,
        model=None,
        potential_fn=None,
        kinetic_fn=None,
        step_size=1.0,
        inverse_mass_matrix=None,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        num_steps=None,
        trajectory_length=2 * math.pi,
        init_strategy=None,
        find_heuristic_step_size=False,
        forward_mode_differentiation=False,
        regularize_mass_matrix=True,
        refine_step_size=True,
        pooled_adaptation=False,
    ):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        if kinetic_fn is not None:
            raise NotImplementedError(
                "custom kinetic_fn is not supported by the chain-batched engine"
            )
        self._model = model
        self._potential_fn = potential_fn
        self._step_size = float(step_size) if isinstance(step_size, int) else step_size
        self._inverse_mass_matrix = inverse_mass_matrix
        self._adapt_step_size = adapt_step_size
        self._adapt_mass_matrix = adapt_mass_matrix
        self._dense_mass = dense_mass
        self._target_accept_prob = target_accept_prob
        self._num_steps = num_steps
        self._trajectory_length = (
            float(trajectory_length) if isinstance(trajectory_length, int) else trajectory_length
        )
        self._max_tree_depth = 10
        self._init_strategy = init_to_uniform if init_strategy is None else init_strategy
        self._forward_mode_differentiation = forward_mode_differentiation
        self._regularize_mass_matrix = regularize_mass_matrix
        self._refine_step_size = refine_step_size
        self._pooled_adaptation = pooled_adaptation
        self._init_fn = None
        self._sample_fn = None
        self._potential_fn_gen = None
        self._postprocess_fn = None
        self.last_fused_stats = {}

    @property
    def model(self):
        return self._model

    @property
    def sample_field(self):
        return "z"

    @property
    def default_fields(self):
        return ("z", "diverging")

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def get_diagnostics_str(self, state):
        """The first chain's steps, step size and mean acceptance."""
        return "{} steps of size {:.2e}. acc. prob={:.2f}".format(
            int(state.num_steps.reshape(-1)[0]),
            float(state.adapt_state.step_size.reshape(-1)[0]),
            float(state.mean_accept_prob.reshape(-1)[0]),
        )

    @property
    def supports_fused_run(self):
        return True

    def _setup(self, rng_key, num_chains, model_args, model_kwargs, init_params):
        if self._model is None:
            if init_params is None:
                raise ValueError(
                    "Valid value of `init_params` must be provided with `potential_fn`."
                )
            self._init_fn, self._sample_fn = hmc(potential_fn=self._potential_fn, algo=self._algo)
            return init_params
        info = initialize_model(
            rng_key,
            self._model,
            num_chains=num_chains,
            dynamic_args=True,
            init_strategy=self._init_strategy,
            model_args=model_args,
            model_kwargs=model_kwargs,
            forward_mode_differentiation=self._forward_mode_differentiation,
        )
        self._potential_fn_gen = info.potential_fn
        self._postprocess_fn = info.postprocess_fn
        self._init_fn, self._sample_fn = hmc(potential_fn_gen=info.potential_fn, algo=self._algo)
        return info.param_info if init_params is None else init_params

    def init(
        self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
        num_chains=None,
    ):
        """The state before the first transition.  ``rng_key`` is a
        ``torch.Generator`` on the device the chains run on (or a draw
        source); ``num_chains=None`` is one chain with unbatched state."""
        model_kwargs = {} if model_kwargs is None else model_kwargs
        generator = getattr(rng_key, "generator", rng_key)
        found = self._setup(
            generator, num_chains or 1, model_args, model_kwargs, init_params
        )
        if num_chains is None and init_params is None:
            # the model's own initial values come with a chain axis of one
            found = ParamInfo(*(_squeeze0(f) for f in found))
        return self._init_fn(
            found,
            num_warmup,
            step_size=self._step_size,
            inverse_mass_matrix=self._inverse_mass_matrix,
            adapt_step_size=self._adapt_step_size,
            adapt_mass_matrix=self._adapt_mass_matrix,
            dense_mass=self._dense_mass,
            target_accept_prob=self._target_accept_prob,
            num_steps=self._num_steps,
            trajectory_length=self._trajectory_length,
            max_tree_depth=self._max_tree_depth,
            forward_mode_differentiation=self._forward_mode_differentiation,
            regularize_mass_matrix=self._regularize_mass_matrix,
            refine_step_size=self._refine_step_size,
            pooled_adaptation=self._pooled_adaptation,
            model_args=model_args,
            model_kwargs=model_kwargs,
            rng_key=rng_key,
            num_chains=num_chains,
        )

    def sample(self, state, model_args, model_kwargs):
        return self._sample_fn(state, model_args, model_kwargs)

    def fused_run(
        self,
        rng_key,
        num_chains,
        num_warmup,
        num_samples,
        *,
        thinning=1,
        init_params=None,
        model_args=(),
        model_kwargs=None,
        collect_fields=("z", "diverging"),
        progress=None,
    ):
        """Warmup + sampling for all chains.  ``rng_key`` is a
        ``torch.Generator`` on the device the chains run on.

        Returns ``(fields, last_state)``; every collected field has shape
        ``(num_chains, num_collected, ...)``.  Wall times, the number of
        batched potential evaluations of each phase and the count of divergent
        warmup transitions of all chains land in ``self.last_fused_stats``.
        ``progress(phase, done, total)``, if given, is called after each
        warmup transition and at each check of the sampling loop, with the
        transitions that every chain has finished.
        """
        model_kwargs = {} if model_kwargs is None else model_kwargs
        infer_util.pin_full_f32_matmul()
        t0 = time.perf_counter()
        evals0, traces0 = infer_util.potential_evals, infer_util.init_traces
        generator = getattr(rng_key, "generator", rng_key)
        init_params = self._setup(generator, num_chains, model_args, model_kwargs, init_params)
        init_traces = infer_util.init_traces - traces0
        if isinstance(init_params, ParamInfo):
            z, pe, z_grad = init_params
        else:
            z, pe, z_grad = init_params, None, None
        layout = core.FlatLayout({k: v[0] for k, v in z.items()})
        blocks = core.build_mass_blocks(layout, self._dense_mass)
        pe_fn = (
            self._potential_fn_gen(*model_args, **model_kwargs)
            if self._potential_fn_gen is not None
            else self._potential_fn
        )
        pe_grad = core.batched_potential(
            pe_fn, layout, forward_mode=self._forward_mode_differentiation
        )
        depth = self._max_tree_depth
        warm_depth, post_depth = depth if isinstance(depth, tuple) else (depth, depth)
        run = core.build_fused_run(
            pe_grad,
            blocks,
            algo=self._algo,
            num_warmup=num_warmup,
            num_samples=num_samples,
            thinning=thinning,
            max_depth=post_depth,
            warmup_max_depth=warm_depth,
            trajectory_length=self._trajectory_length,
            fixed_num_steps=self._num_steps,
            adapt_step_size=self._adapt_step_size,
            adapt_mass_matrix=self._adapt_mass_matrix,
            target_accept_prob=self._target_accept_prob,
            regularize_mass_matrix=self._regularize_mass_matrix,
            find_step_size=self._adapt_step_size and self._refine_step_size,
            pool_chains=self._pooled_adaptation,
        )
        draws = core.as_draws(rng_key)
        z_flat = layout.ravel_batch(z)
        if pe is None or z_grad is None:
            pe, grad_flat = pe_grad(z_flat)
        else:
            grad_flat = layout.ravel_batch(z_grad)
        _sync(z_flat)
        init_s = time.perf_counter() - t0
        evals_init = infer_util.potential_evals - evals0

        t1 = time.perf_counter()
        warm = run.warmup(
            draws, z_flat, pe, grad_flat, self._step_size, self._inverse_mass_matrix,
            progress=progress,
        )
        _sync(warm["z"])
        warmup_s = time.perf_counter() - t1
        evals_warm = infer_util.potential_evals - evals0 - evals_init

        t2 = time.perf_counter()
        out = run.sample(draws, warm["z"], warm["pe"], warm["grad"], warm["adapt"],
                         progress=progress)
        _sync(out["samples_z"])
        sample_s = time.perf_counter() - t2
        self.last_fused_stats = {
            # initialize_model traces the model once, unbatched, to find its
            # latent sites, and once per chain and try under a strategy that
            # draws (infer.util._batched_candidates): model evaluations that
            # are not potential ones
            "init_traces": init_traces,
            "init_s": init_s,
            "warmup_s": warmup_s,
            "sample_s": sample_s,
            "potential_evals_init": evals_init,
            "potential_evals_warmup": evals_warm,
            "potential_evals_sample": infer_util.potential_evals - evals0 - evals_init - evals_warm,
            "num_divergent_warmup": int(warm["num_divergent"]),
        }

        n_collect = out["samples_z"].shape[1]
        flat2 = out["samples_z"].reshape(num_chains * n_collect, -1)
        z_samples = {
            k: v.reshape((num_chains, n_collect) + v.shape[1:])
            for k, v in layout.unravel_batch(flat2).items()
        }
        step_size = out["adapt"].step_size[:, None].expand(num_chains, n_collect)
        fields = {"z": z_samples, "adapt_state.step_size": step_size, **out["extras"]}
        fields = {k: fields[k] for k in collect_fields}
        last_state = HMCState(
            num_warmup + num_samples,
            layout.unravel_batch(out["z"]),
            layout.unravel_batch(out["grad"]),
            out["pe"],
            out["pe"],
            None,
            self._trajectory_length,
            torch.zeros((num_chains,), dtype=torch.int32, device=out["pe"].device),
            out["mean_accept_prob"],
            out["mean_accept_prob"],
            torch.zeros((num_chains,), dtype=torch.bool, device=out["pe"].device),
            out["adapt"],
            rng_key,
        )
        return fields, last_state


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class NUTS(HMC):
    """No-U-Turn Sampler (constructor parity with the JAX ``NUTS``)."""

    _algo = "NUTS"

    def __init__(
        self,
        model=None,
        potential_fn=None,
        kinetic_fn=None,
        step_size=1.0,
        inverse_mass_matrix=None,
        adapt_step_size=True,
        adapt_mass_matrix=True,
        dense_mass=False,
        target_accept_prob=0.8,
        trajectory_length=None,
        max_tree_depth=10,
        init_strategy=None,
        find_heuristic_step_size=False,
        forward_mode_differentiation=False,
        regularize_mass_matrix=True,
        refine_step_size=True,
        pooled_adaptation=False,
    ):
        super().__init__(
            model=model,
            potential_fn=potential_fn,
            kinetic_fn=kinetic_fn,
            step_size=step_size,
            inverse_mass_matrix=inverse_mass_matrix,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            dense_mass=dense_mass,
            target_accept_prob=target_accept_prob,
            trajectory_length=trajectory_length,
            init_strategy=init_strategy,
            find_heuristic_step_size=find_heuristic_step_size,
            forward_mode_differentiation=forward_mode_differentiation,
            regularize_mass_matrix=regularize_mass_matrix,
            refine_step_size=refine_step_size,
            pooled_adaptation=pooled_adaptation,
        )
        self._max_tree_depth = max_tree_depth
