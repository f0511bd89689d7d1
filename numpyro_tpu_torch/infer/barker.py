"""Barker-proposal MH kernel, panel-batched (port of
``numpyro_tpu/infer/barker.py``; Livingstone & Zanella, "The Barker proposal:
combining robustness and efficiency in gradient-based MCMC").

- Step-size dual averaging and Welford mass adaptation are the engine's
  (``hmc_core.build_warmup``, with the structured mass blocks), with no
  step-size search.
- Positions are a ``(C, D)`` panel and the potential and its gradient are one
  batched evaluation per transition.
- The preconditioner is the engine's ``sqrt_inv`` factor ``T`` (``T^T T`` is
  the adapted covariance): gradients are whitened with ``T`` and the jump is
  coloured back with ``T^T``.

The step index ``i`` is a host integer, so the JAX package's
``lax.cond(i < num_warmup, ...)`` is a plain ``if``.  A transition takes its
draws from the state's draw source (``hmc_core.GeneratorDraws``) in this
order: ``normals((C, D))`` (the jump magnitudes), ``uniforms((C, D))`` (the
sign flips), ``uniforms((C,))`` (the accept test).
"""

from __future__ import annotations

from collections import namedtuple
from functools import partial

import torch
import torch.nn.functional as F

from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.infer.mcmc import MCMCKernel
from numpyro_tpu_torch.infer.util import initialize_model
from numpyro_tpu_torch.util import identity, tree_map

__all__ = ["BarkerMH", "BarkerMHState", "barker_panel_transition", "barker_state_from_numpy"]

BarkerMHState = namedtuple(
    "BarkerMHState",
    ["i", "z", "potential_energy", "z_grad", "accept_prob", "mean_accept_prob", "adapt_state",
     "rng_key"],
)


def _whiten(blocks, sqrt_inv, v, transpose=False):
    """The block preconditioner ``T`` (or ``T^T``) times a ``(C, D)`` panel."""
    parts = core._as_parts(blocks, sqrt_inv)
    out = [
        core._times_block(m.transpose(-2, -1) if transpose and m.dim() == 3 else m, x)
        for m, x in zip(parts, core._block_slices(blocks, v))
    ]
    return core._unblock(blocks, out)


def barker_panel_transition(state, pe_grad, blocks, wa_update, num_warmup):
    """Advance every chain by one Barker step.  ``state.z`` and
    ``state.z_grad`` are ``(C, D)`` panels; ``pe_grad`` maps a panel to
    ``(pe, grad)``."""
    x, pe_x, grad_x = state.z, state.potential_energy, state.z_grad
    draws = core.as_draws(state.rng_key)
    adapt = state.adapt_state
    eps = draws.normals(tuple(x.shape), x)
    u_flip = draws.uniforms(tuple(x.shape), x)
    u_mh = draws.uniforms(tuple(x.shape[:1]), x)

    T = adapt.mass_matrix_sqrt_inv
    gx_w = _whiten(blocks, T, grad_x)
    # magnitude ~ N(0, eps^2) per coordinate; sign skewed toward -grad
    mag = adapt.step_size[:, None] * eps
    flip = u_flip < torch.sigmoid(-mag * gx_w)
    jump = torch.where(flip, mag, -mag)
    y = x + _whiten(blocks, T, jump, transpose=True)

    pe_y, grad_y = pe_grad(y)
    gy_w = _whiten(blocks, T, grad_y)
    # skew-detailed-balance correction (Livingstone & Zanella eq. 12)
    log_ratio = pe_x - pe_y + (F.softplus(jump * gx_w) - F.softplus(-jump * gy_w)).sum(-1)
    # a proposal with a non-finite energy or ratio is a plain rejection, and
    # never reaches the dual averaging as NaN
    accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0)).clamp(max=1.0)
    accept_prob = torch.where(torch.isfinite(log_ratio), accept_prob, 0.0)
    accept = u_mh < accept_prob

    x_new = torch.where(accept[:, None], y, x)
    pe_new = torch.where(accept, pe_y, pe_x)
    grad_new = torch.where(accept[:, None], grad_y, grad_x)
    i = int(state.i)
    if i < num_warmup:
        adapt = wa_update(i, adapt, accept_prob, x_new, pe_new, grad_new, draws)
    n = i + 1 if i < num_warmup else i + 1 - num_warmup
    mean_accept = state.mean_accept_prob + (accept_prob - state.mean_accept_prob) / n
    return BarkerMHState(i + 1, x_new, pe_new, grad_new, accept_prob, mean_accept, adapt,
                         state.rng_key)


def resolve_init(kernel, generator, num_chains, model_args, model_kwargs, init_params):
    """Initial params of a gradient-free or gradient kernel with a leading
    chain axis: from the model (``initialize_model``, one chain unbatched for
    ``num_chains=None``) or from the caller, who must give them with a
    ``potential_fn``."""
    if kernel._model is not None:
        info = initialize_model(
            generator, kernel._model, num_chains=num_chains, dynamic_args=True,
            init_strategy=kernel._init_strategy, model_args=model_args,
            model_kwargs=model_kwargs,
        )
        kernel._potential_fn_gen = info.potential_fn
        kernel._postprocess_fn = info.postprocess_fn
        if init_params is None:
            init_params = info.param_info.z
    elif init_params is None:
        raise ValueError("Valid value of `init_params` must be provided with `potential_fn`.")
    if num_chains is None:
        init_params = tree_map(lambda x: torch.as_tensor(x)[None], init_params)
    return init_params


class BarkerMH(MCMCKernel):
    """Metropolis-Hastings with the skew-symmetric Barker proposal: jumps are
    skewed coordinatewise toward the gradient.

    :param model: model callable (or pass ``potential_fn``).
    :param potential_fn: potential of one chain's params; requires explicit
        ``init_params``.
    :param step_size: initial proposal scale.
    :param adapt_step_size: dual-average the scale toward the accept target.
    :param adapt_mass_matrix: learn a Welford preconditioner during warmup.
    :param dense_mass: full covariance preconditioner (or a list of site
        groups for structured dense blocks).
    :param target_accept_prob: accept-rate target (0.4 is the Barker optimum).
    :param init_strategy: site initializer for the model path.
    """

    sample_field = "z"

    def __init__(self, model=None, potential_fn=None, step_size=1.0, adapt_step_size=True,
                 adapt_mass_matrix=True, dense_mass=False, target_accept_prob=0.4,
                 init_strategy=init_to_uniform):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        self._model = model
        self._potential_fn = potential_fn
        self._step_size = step_size
        self._adapt_step_size = adapt_step_size
        self._adapt_mass_matrix = adapt_mass_matrix
        self._dense_mass = dense_mass
        self._target_accept_prob = target_accept_prob
        self._init_strategy = init_strategy
        self._postprocess_fn = None
        self._potential_fn_gen = None
        self._num_warmup = None
        self._layout = None
        self._blocks = None
        self._wa_update = None
        self._batched = None

    @property
    def model(self):
        return self._model

    def get_diagnostics_str(self, state):
        return "step size {:.2e}. acc. prob={:.2f}".format(
            float(state.adapt_state.step_size.reshape(-1)[0]),
            float(state.mean_accept_prob.reshape(-1)[0]),
        )

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def _pe_grad(self, model_args, model_kwargs):
        pe_fn = self._potential_fn
        if self._potential_fn_gen is not None:
            pe_fn = self._potential_fn_gen(*model_args, **(model_kwargs or {}))
        return core.batched_potential(pe_fn, self._layout)

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
             num_chains=None):
        """``rng_key``: a ``torch.Generator`` on the chains' device (or a draw
        source); ``num_chains=None`` is one chain with unbatched state."""
        model_kwargs = {} if model_kwargs is None else model_kwargs
        infer_util.pin_full_f32_matmul()
        self._num_warmup = num_warmup
        self._batched = num_chains is not None
        draws = core.as_draws(rng_key)
        z0 = resolve_init(self, getattr(draws, "generator", rng_key), num_chains, model_args,
                          model_kwargs, init_params)
        self._layout = core.FlatLayout(tree_map(lambda x: x[0], z0))
        self._blocks = core.build_mass_blocks(self._layout, self._dense_mass)
        pe_grad = self._pe_grad(model_args, model_kwargs)
        panel = self._layout.ravel_batch(z0)
        pe, grad = pe_grad(panel)
        wa_init, self._wa_update = core.build_warmup(
            pe_grad, self._blocks, num_warmup, adapt_step_size=self._adapt_step_size,
            adapt_mass_matrix=self._adapt_mass_matrix,
            target_accept_prob=self._target_accept_prob, find_step_size=False,
        )
        adapt = wa_init(draws, panel, pe, grad, self._step_size)
        zero = torch.zeros_like(pe)
        state = BarkerMHState(
            0, self._layout.unravel_batch(panel), pe, self._layout.unravel_batch(grad), zero,
            zero, adapt, rng_key,
        )
        return state if self._batched else tree_map(lambda x: x[0], state)

    def sample(self, state, model_args, model_kwargs):
        infer_util.pin_full_f32_matmul()
        if not self._batched:
            state = tree_map(lambda x: x[None], state)
        layout = self._layout
        state = state._replace(z=layout.ravel_batch(state.z),
                               z_grad=layout.ravel_batch(state.z_grad))
        new = barker_panel_transition(
            state, self._pe_grad(model_args, model_kwargs), self._blocks, self._wa_update,
            self._num_warmup,
        )
        new = new._replace(z=layout.unravel_batch(new.z), z_grad=layout.unravel_batch(new.z_grad))
        return new if self._batched else tree_map(lambda x: x[0], new)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_wa_update"] = None
        state["_potential_fn_gen"] = None
        return state


def barker_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``BarkerMHState`` from a JAX ``BarkerMHState`` whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, state)``).  JAX's keys are
    dropped: ``rng_key`` is the generator or draw source the port's state
    carries instead."""
    get = partial(infer_util.state_field, fields)
    to = partial(infer_util.tree_from_numpy, device=device)
    return BarkerMHState(
        int(get("i")), to(get("z")), to(get("potential_energy")), to(get("z_grad")),
        to(get("accept_prob")), to(get("mean_accept_prob")),
        core.adapt_from_numpy(get("adapt_state"), device), rng_key,
    )