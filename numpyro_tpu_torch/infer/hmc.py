"""NUTS on the chain-batched engine (port of ``numpyro_tpu/infer/hmc.py``).

The only sampling path is :meth:`HMC.fused_run`: warmup and sampling for all
chains, with the asynchronous harvest loop of
:mod:`numpyro_tpu_torch.infer.hmc_core`.  Fixed-trajectory ``HMC``, dense
mass matrices, forward-mode differentiation and the per-step
``init``/``sample`` kernel API are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
import time
from collections import namedtuple

import torch

from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.infer.util import ParamInfo, initialize_model
from numpyro_tpu_torch.util import identity

__all__ = ["HMC", "HMCState", "NUTS"]

HMCState = namedtuple(
    "HMCState",
    [
        "i", "z", "z_grad", "potential_energy", "energy", "r", "trajectory_length",
        "num_steps", "accept_prob", "mean_accept_prob", "diverging", "adapt_state",
        "rng_key",
    ],
)
"""Kernel state after a run (field parity with the JAX ``HMCState``); every
tensor leaf carries a leading chain axis."""


class HMC:
    """Hamiltonian Monte Carlo.  Only the NUTS subclass runs in this port:
    fixed trajectories are not ported yet (ROADMAP.md)."""

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
        if forward_mode_differentiation:
            raise NotImplementedError(
                "forward_mode_differentiation is not ported to numpyro_tpu_torch "
                "yet (see ROADMAP.md)"
            )
        if dense_mass is not False:
            raise NotImplementedError(
                "dense_mass is not ported to numpyro_tpu_torch yet (see ROADMAP.md)"
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
        self._trajectory_length = trajectory_length
        self._max_tree_depth = 10
        self._init_strategy = init_to_uniform if init_strategy is None else init_strategy
        self._regularize_mass_matrix = regularize_mass_matrix
        self._refine_step_size = refine_step_size
        self._pooled_adaptation = pooled_adaptation
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

    def _setup(self, rng_key, num_chains, model_args, model_kwargs, init_params):
        if self._model is None:
            if init_params is None:
                raise ValueError(
                    "Valid value of `init_params` must be provided with `potential_fn`."
                )
            return init_params
        info = initialize_model(
            rng_key,
            self._model,
            num_chains=num_chains,
            dynamic_args=True,
            init_strategy=self._init_strategy,
            model_args=model_args,
            model_kwargs=model_kwargs,
        )
        self._potential_fn_gen = info.potential_fn
        self._postprocess_fn = info.postprocess_fn
        return info.param_info if init_params is None else init_params

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
    ):
        """Warmup + sampling for all chains.  ``rng_key`` is a
        ``torch.Generator`` on the device the chains run on.

        Returns ``(fields, last_state)``; every collected field has shape
        ``(num_chains, num_collected, ...)``.  Wall times and the number of
        batched potential evaluations of each phase land in
        ``self.last_fused_stats``.
        """
        if self._algo != "NUTS":
            raise NotImplementedError(
                "fixed-trajectory HMC is not ported to numpyro_tpu_torch yet (see ROADMAP.md)"
            )
        model_kwargs = {} if model_kwargs is None else model_kwargs
        t0 = time.perf_counter()
        evals0 = infer_util.potential_evals
        init_params = self._setup(rng_key, num_chains, model_args, model_kwargs, init_params)
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
        pe_grad = core.batched_potential(pe_fn, layout)
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
            adapt_step_size=self._adapt_step_size,
            adapt_mass_matrix=self._adapt_mass_matrix,
            target_accept_prob=self._target_accept_prob,
            regularize_mass_matrix=self._regularize_mass_matrix,
            find_step_size=self._adapt_step_size and self._refine_step_size,
            pool_chains=self._pooled_adaptation,
        )
        draws = core.GeneratorDraws(rng_key)
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
            draws, z_flat, pe, grad_flat, self._step_size, self._inverse_mass_matrix
        )
        _sync(warm["z"])
        warmup_s = time.perf_counter() - t1
        evals_warm = infer_util.potential_evals - evals0 - evals_init

        t2 = time.perf_counter()
        out = run.sample(draws, warm["z"], warm["pe"], warm["grad"], warm["adapt"])
        _sync(out["samples_z"])
        sample_s = time.perf_counter() - t2
        self.last_fused_stats = {
            # initialize_model traces the model once, unbatched, to find its
            # latent sites: a model evaluation that is not a potential one
            "init_traces": int(self._model is not None),
            "init_s": init_s,
            "warmup_s": warmup_s,
            "sample_s": sample_s,
            "potential_evals_init": evals_init,
            "potential_evals_warmup": evals_warm,
            "potential_evals_sample": infer_util.potential_evals - evals0 - evals_init - evals_warm,
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
