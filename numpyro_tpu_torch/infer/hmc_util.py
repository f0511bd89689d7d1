"""Single-chain HMC utilities and subposterior merging (port of
``numpyro_tpu/infer/hmc_util.py``).

The chain-batched engine is :mod:`numpyro_tpu_torch.infer.hmc_core`; this
module keeps the one-chain building blocks (dual averaging, Welford moments,
the kinetic energy, velocity Verlet, the step-size search, Stan's warmup
windows and a warmup adapter) and the merging of subposteriors drawn apart.
The arithmetic of dual averaging, the Welford update, the covariance estimate
and the warmup windows is the engine's (``hmc_core.dual_averaging_step``,
``welford_step``, ``covariance_factors`` and ``stan_windows``): one copy
serves both.

What differs from the JAX module:

- Random numbers come from a draw source (``hmc_core.GeneratorDraws``, or a
  ``torch.Generator``, which is wrapped in one) in place of split keys:
  ``find_reasonable_step_size`` draws one momentum a probe through its
  ``momentum_generator(z, inverse_mass_matrix, draws)``; ``consensus`` draws
  ``randints(0, N, (num_draws,))`` to pick its draws and ``parametric_draws``
  ``normals((num_draws, D))``.  ``warmup_adapter``'s state carries the source
  whole (JAX splits its key at every update).
- The step-size search is a Python loop that reads its condition on the host
  once a probe (one sync each); the warmup adapter's step index is a host
  integer, and its window masks are read on the host (``lax.cond`` there).
- The dual-averaging step count of the port is an integer tensor or a float;
  the averages are the engine's, which differ from JAX's in the last bits.
"""

from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from numpyro_tpu_torch.distributions.util import cholesky, inv
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer.hmc_core import FlatLayout, stan_windows
from numpyro_tpu_torch.util import identity, tree_leaves, tree_map

__all__ = [
    "AdaptWindow",
    "DualAveragingState",
    "HMCAdaptState",
    "IntegratorState",
    "WelfordCovarianceState",
    "build_adaptation_schedule",
    "consensus",
    "dual_averaging",
    "euclidean_kinetic_energy",
    "find_reasonable_step_size",
    "parametric",
    "parametric_draws",
    "velocity_verlet",
    "warmup_adapter",
    "welford_covariance",
]

AdaptWindow = namedtuple("AdaptWindow", ["start", "end"])

HMCAdaptState = namedtuple(
    "HMCAdaptState",
    [
        "step_size",
        "inverse_mass_matrix",
        "mass_matrix_sqrt",
        "mass_matrix_sqrt_inv",
        "ss_state",
        "mm_state",
        "window_idx",
        "rng_key",
    ],
)

IntegratorState = namedtuple("IntegratorState", ["z", "r", "potential_energy", "z_grad"])
IntegratorState.__new__.__defaults__ = (None,) * len(IntegratorState._fields)

DualAveragingState = namedtuple("DualAveragingState", ["x_t", "x_avg", "g_avg", "t", "prox_center"])
WelfordCovarianceState = namedtuple("WelfordCovarianceState", ["mean", "m2", "n"])


def _flat(tree):
    """A dict of tensors (sorted names, as JAX ravels) or a tensor -> 1-d."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape(-1)
    return torch.cat([tree[k].reshape(-1) for k in sorted(tree)])


# ---------------------------------------------------------------------------
# Step-size adaptation


def dual_averaging(t0=10, kappa=0.75, gamma=0.05):
    """Nesterov's primal-dual averaging, which drives the log step size
    towards the target acceptance statistic: ``(init_fn, update_fn)``, with
    ``update_fn(gradient, state)``."""

    def init_fn(prox_center=0.0):
        if not isinstance(prox_center, torch.Tensor):
            prox_center = torch.tensor(float(prox_center))
        zero = torch.zeros_like(prox_center)
        t = torch.zeros((), dtype=torch.int64, device=prox_center.device)
        return DualAveragingState(zero, zero, zero, t, prox_center)

    def update_fn(gradient, state):
        x_t, x_avg, g_avg, t = core.dual_averaging_step(
            gradient, state.t, state.g_avg, state.x_avg, state.prox_center, t0, kappa, gamma
        )
        return DualAveragingState(x_t, x_avg, g_avg, t, state.prox_center)

    return init_fn, update_fn


# ---------------------------------------------------------------------------
# Online covariance (mass-matrix estimation)


def welford_covariance(diagonal=True):
    """Welford's one-pass moments: ``(init_fn, update_fn, final_fn)``.
    ``init_fn(size, like=None)`` makes its zeros in the dtype and on the
    device of ``like`` (the default dtype on the CPU without it).
    ``final_fn(state, regularize=False)`` gives the covariance (shrunk as the
    engine shrinks it when ``regularize``) and the mass-matrix factors
    ``(sqrt, sqrt_inv)``; a dict state holds one accumulator per block of
    site names."""

    def init_fn(size, like=None):
        if isinstance(size, dict):
            return {k: init_fn(v, like) for k, v in size.items()}
        if isinstance(size, int):
            shape = (size,) if diagonal else (size, size)
        else:
            shape = tuple(size)
        like = torch.zeros(()) if like is None else like
        return WelfordCovarianceState(
            like.new_zeros(shape[-1:]), like.new_zeros(shape), like.new_zeros(())
        )

    def update_fn(sample, state):
        if isinstance(state, dict):
            return {
                names: update_fn(_flat({k: sample[k] for k in names}), block)
                for names, block in state.items()
            }
        n = state.n + 1
        mean, m2 = core.welford_step(state.mean, state.m2, n, sample, state.m2.dim() == 2)
        return WelfordCovarianceState(mean, m2, n)

    def final_fn(state, regularize=False):
        if isinstance(state, dict):
            outs = {k: final_fn(v, regularize=regularize) for k, v in state.items()}
            return tuple({k: v[j] for k, v in outs.items()} for j in range(3))
        return core.covariance_factors(state.m2, state.n, state.m2.dim() == 2, regularize)

    return init_fn, update_fn, final_fn


# ---------------------------------------------------------------------------
# Euclidean kinetic energy and velocity Verlet on one chain's pytrees


def _mass_inv_apply(inverse_mass_matrix, r):
    """``M^{-1} r`` for momenta ``r`` (a dict of tensors or a tensor); a dict
    mass holds one block per tuple of site names."""
    if isinstance(inverse_mass_matrix, dict):
        out = {}
        for names, mm in inverse_mass_matrix.items():
            part = {k: r[k] for k in names}
            flat = _flat(part)
            out.update(FlatLayout(part).unravel_one(mm * flat if mm.dim() == 1 else mm @ flat))
        return out
    flat = _flat(r)
    v = inverse_mass_matrix * flat if inverse_mass_matrix.dim() == 1 else inverse_mass_matrix @ flat
    return FlatLayout(r).unravel_one(v)


def euclidean_kinetic_energy(inverse_mass_matrix, r):
    """K(r) = <r, M^{-1} r> / 2 over a pytree of momenta."""
    v = _mass_inv_apply(inverse_mass_matrix, r)
    if isinstance(r, torch.Tensor):
        return 0.5 * (v * r).sum()
    return 0.5 * sum((v[k] * r[k]).sum() for k in sorted(r))


euclidean_kinetic_energy._kinetic_grad = _mass_inv_apply


def velocity_verlet(potential_fn, kinetic_fn, forward_mode_differentiation=False):
    """Leapfrog ``(init_fn, update_fn)`` on one chain's pytree states; the
    gradient by ``torch.func.grad_and_value`` (``jacfwd`` in forward mode)."""
    if forward_mode_differentiation:

        def value_grad(z):
            return potential_fn(z), torch.func.jacfwd(potential_fn)(z)

    else:

        def value_grad(z):
            grad, value = torch.func.grad_and_value(potential_fn)(z)
            return value, grad

    momentum_grad = getattr(kinetic_fn, "_kinetic_grad", None) or (
        lambda mm, r: torch.func.grad(kinetic_fn, argnums=1)(mm, r)
    )

    def init_fn(z, r, potential_energy=None, z_grad=None):
        if potential_energy is None or z_grad is None:
            potential_energy, z_grad = value_grad(z)
        return IntegratorState(z, r, potential_energy, z_grad)

    def update_fn(step_size, inverse_mass_matrix, state):
        z, r, _, z_grad = state
        r = tree_map(lambda a, g: a - 0.5 * step_size * g, r, z_grad)
        v = momentum_grad(inverse_mass_matrix, r)
        z = tree_map(lambda a, b: a + step_size * b, z, v)
        potential_energy, z_grad = value_grad(z)
        r = tree_map(lambda a, g: a - 0.5 * step_size * g, r, z_grad)
        return IntegratorState(z, r, potential_energy, z_grad)

    return init_fn, update_fn


def find_reasonable_step_size(potential_fn, kinetic_fn, momentum_generator, init_step_size,
                              inverse_mass_matrix, z_info, rng_key):
    """Double or halve the step size until the accept probability of one
    leapfrog crosses 0.8.  ``rng_key`` is a generator or a draw source, from
    which ``momentum_generator(z, inverse_mass_matrix, draws)`` draws one
    momentum a probe; each probe reads its outcome on the host (one sync).
    The step size is a host float, made in float32 as JAX makes it."""
    draws = core.as_draws(rng_key)
    z, _, pe, z_grad = z_info
    _, leapfrog = velocity_verlet(potential_fn, kinetic_fn)
    log_target = math.log(0.8)
    finfo = np.finfo(np.float32)
    step_size = np.float32(init_step_size)
    sign = prev_sign = 0
    while finfo.tiny < step_size < finfo.max and (prev_sign == 0 or sign == prev_sign):
        r = momentum_generator(z, inverse_mass_matrix, draws)
        state = leapfrog(float(step_size), inverse_mass_matrix, IntegratorState(z, r, pe, z_grad))
        h0 = pe + kinetic_fn(inverse_mass_matrix, r)
        h1 = state.potential_energy + kinetic_fn(inverse_mass_matrix, state.r)
        prev_sign, sign = sign, (1 if bool(log_target < h0 - h1) else -1)
        step_size = np.float32(step_size * np.float32(2.0) ** sign)
    return float(step_size / np.float32(2.0) ** sign)


# ---------------------------------------------------------------------------
# Warmup schedule and the one-chain warmup adapter


def build_adaptation_schedule(num_steps):
    """Stan's warmup windows as ``AdaptWindow`` pairs (the engine's
    ``stan_windows``)."""
    return [AdaptWindow(*w) for w in stan_windows(num_steps)]


def _identity_mass(z, inverse_mass_matrix, dense_mass):
    """The first ``(inverse_mass_matrix, sqrt, sqrt_inv)``: identity, or the
    given inverse mass; a dict of blocks when ``dense_mass`` is a list of
    site-name tuples (the sites in no tuple form one diagonal block)."""
    if isinstance(dense_mass, list):
        sites = dict(z) if isinstance(z, dict) else {}
        given = inverse_mass_matrix if isinstance(inverse_mass_matrix, dict) else {}
        if inverse_mass_matrix is not None and not isinstance(inverse_mass_matrix, dict):
            given = {tuple(sorted(sites)): inverse_mass_matrix}
        groups = list(dense_mass)
        leftover = tuple(sorted(set(sites) - {k for g in dense_mass for k in g}))
        if leftover:
            groups.append(leftover)
        inv, msqrt, msqrt_inv = {}, {}, {}
        for names in groups:
            block = {k: sites[k] for k in names}
            key = tuple(names)
            inv[key], msqrt[key], msqrt_inv[key] = _identity_mass(
                block, given.get(key), names in dense_mass
            )
        return inv, msqrt, msqrt_inv
    flat = _flat(z)
    size = flat.numel()
    if inverse_mass_matrix is None:
        eye = (torch.eye(size, dtype=flat.dtype, device=flat.device) if dense_mass
               else torch.ones(size, dtype=flat.dtype, device=flat.device))
        return eye, eye, eye
    mm = inverse_mass_matrix
    if dense_mass:
        if mm.dim() == 1:
            mm = torch.diag(mm)
        sqrt, sqrt_inv = core._precision_factors(mm)
    else:
        sqrt_inv = torch.sqrt(mm)
        sqrt = 1.0 / sqrt_inv
    return mm, sqrt, sqrt_inv


def warmup_adapter(num_adapt_steps, find_reasonable_step_size=None, adapt_step_size=True,
                   adapt_mass_matrix=True, dense_mass=False, target_accept_prob=0.8):
    """One chain's warmup adapter ``(init_fn, update_fn)``: dual averaging
    of the step size and Welford estimates of the mass over Stan's windows.
    ``find_reasonable_step_size(step_size, inverse_mass_matrix, z_info,
    draws)`` refines the step size at the start and at every window end; the
    step index ``t`` of ``update_fn(t, accept_prob, z_info, state)`` is a
    host integer."""
    refine = find_reasonable_step_size or identity
    da_init, da_update = dual_averaging()
    wf_init, wf_update, wf_final = welford_covariance(diagonal=not dense_mass)
    windows = stan_windows(num_adapt_steps) if num_adapt_steps > 0 else []
    n = max(num_adapt_steps, 1)
    middle = np.zeros(n, bool)
    window_end = np.zeros(n, bool)
    for j, (lo, hi) in enumerate(windows):
        if 0 < j < len(windows) - 1:
            middle[lo : hi + 1] = True
            window_end[hi] = True

    def _mm_sizes(inv):
        if isinstance(inv, dict):
            return {k: tuple(v.shape) for k, v in inv.items()}
        return tuple(inv.shape)

    def _step_size(value, like):
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)

    def init_fn(z_info, rng_key, step_size=1.0, inverse_mass_matrix=None, mass_matrix_size=None):
        draws = core.as_draws(rng_key)
        proto = (z_info[0] if isinstance(dense_mass, list) or mass_matrix_size is None
                 else torch.zeros(mass_matrix_size))
        inv, msqrt, msqrt_inv = _identity_mass(proto, inverse_mass_matrix, dense_mass)
        like = tree_leaves(z_info[0])[0]
        if adapt_step_size:
            step_size = refine(step_size, inv, z_info, draws)
        step_size = _step_size(step_size, like)
        return HMCAdaptState(
            step_size, inv, msqrt, msqrt_inv, da_init(torch.log(10 * step_size)),
            wf_init(_mm_sizes(inv), like), 0, draws,
        )

    def _close_window(z_info, state):
        inv, msqrt, msqrt_inv = (state.inverse_mass_matrix, state.mass_matrix_sqrt,
                                 state.mass_matrix_sqrt_inv)
        mm_state = state.mm_state
        if adapt_mass_matrix:
            inv, msqrt, msqrt_inv = wf_final(mm_state, regularize=True)
            mm_state = wf_init(_mm_sizes(inv), state.step_size)
        step_size, ss_state = state.step_size, state.ss_state
        if adapt_step_size:
            step_size = _step_size(refine(step_size, inv, z_info, state.rng_key), step_size)
            ss_state = da_init(torch.log(10 * step_size))
        return state._replace(
            step_size=step_size, inverse_mass_matrix=inv, mass_matrix_sqrt=msqrt,
            mass_matrix_sqrt_inv=msqrt_inv, ss_state=ss_state, mm_state=mm_state,
        )

    def update_fn(t, accept_prob, z_info, state):
        if adapt_step_size:
            ss_state = da_update(target_accept_prob - accept_prob, state.ss_state)
            log_ss = ss_state.x_avg if t == num_adapt_steps - 1 else ss_state.x_t
            finfo = torch.finfo(log_ss.dtype)
            state = state._replace(
                step_size=torch.clamp(torch.exp(log_ss), finfo.tiny, finfo.max),
                ss_state=ss_state,
            )
        if num_adapt_steps <= 0:
            return state
        idx = min(t, num_adapt_steps - 1)
        if adapt_mass_matrix and middle[idx]:
            z = z_info[0]
            obs = z if isinstance(state.mm_state, dict) else _flat(z)
            state = state._replace(mm_state=wf_update(obs, state.mm_state))
        if window_end[idx]:
            state = _close_window(z_info, state._replace(window_idx=state.window_idx + 1))
        return state

    return init_fn, update_fn


# ---------------------------------------------------------------------------
# Subposterior merging (embarrassingly parallel MCMC)


def _stack_subposteriors(subposteriors):
    """A list of ``{site: (N, ...)}`` dicts -> ``(K, N, D)`` flat draws and
    the function that unravels ``(n, D)`` draws."""
    layout = FlatLayout(tree_map(lambda x: x[0], subposteriors[0]))
    flat = torch.stack([layout.ravel_batch(sub) for sub in subposteriors])
    return flat, layout.unravel_batch


def _covariances(flat):
    """Unbiased covariance of each subposterior's ``(N, D)`` draws."""
    k, _, d = flat.shape
    return torch.stack([torch.cov(x.T) for x in flat]).reshape(k, d, d)


def _default_draws(rng_key, like):
    if rng_key is None:
        return core.GeneratorDraws(torch.Generator(device=like.device).manual_seed(0))
    return core.as_draws(rng_key)


def consensus(subposteriors, num_draws=None, diagonal=False, rng_key=None):
    """Consensus Monte Carlo (Scott et al. 2016): draws averaged across
    subposteriors with precision weights; ``num_draws`` of them picked at
    random (``rng_key``: a generator or draw source, seed 0 by default)."""
    flat, unravel = _stack_subposteriors(subposteriors)
    if diagonal:
        weights = 1.0 / flat.var(1, correction=1)
        merged = torch.einsum("knd,kd->nd", flat, weights / weights.sum(0))
    else:
        precisions = inv(_covariances(flat))
        total = inv(precisions.sum(0))
        merged = torch.einsum("de,kef,knf->nd", total, precisions, flat)
    if num_draws is not None:
        pick = _default_draws(rng_key, flat).randints(0, merged.shape[0], (num_draws,), flat)
        merged = merged[pick]
    return unravel(merged)


def parametric(subposteriors, diagonal=False):
    """The product of the subposteriors' Gaussian fits: ``(mean, var)`` with
    ``diagonal``, else ``(mean, cov)``."""
    flat, _ = _stack_subposteriors(subposteriors)
    means = flat.mean(1)
    if diagonal:
        precisions = 1.0 / flat.var(1, correction=1)
        var = 1.0 / precisions.sum(0)
        return var * (precisions * means).sum(0), var
    precisions = inv(_covariances(flat))
    cov = inv(precisions.sum(0))
    return cov @ torch.einsum("kde,ke->d", precisions, means), cov


def parametric_draws(subposteriors, num_draws, diagonal=False, rng_key=None):
    """``num_draws`` draws of :func:`parametric`'s Gaussian, unravelled into
    the sites (``rng_key``: a generator or draw source, seed 0 by default)."""
    flat, unravel = _stack_subposteriors(subposteriors)
    mean, scale = parametric(subposteriors, diagonal=diagonal)
    noise = _default_draws(rng_key, flat).normals((num_draws,) + tuple(mean.shape), flat)
    if diagonal:
        draws = mean + torch.sqrt(scale) * noise
    else:
        draws = mean + noise @ cholesky(scale).T
    return unravel(draws)
