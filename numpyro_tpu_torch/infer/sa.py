"""Sample-Adaptive MCMC, panel-batched (port of ``numpyro_tpu/infer/sa.py``;
Zhu 2019, "Sample Adaptive MCMC").

- The live-point pool of all chains is one ``(C, N, D)`` tensor, and a
  transition evaluates the potential once, for all chains (no gradient).
- The victim row of the pool is overwritten by the proposal through a one-hot
  select (a rejection writes nothing).
- The ``N`` leave-one-out proposal factors come from three broadcast rank-one
  Cholesky updates over the pool axis (``distributions.util.cholesky_update``).

A transition takes its draws from the state's draw source in this order:
``normals((C, D))`` (the proposal), ``gumbels((C, N + 1))`` (the victim, a
categorical draw as the argmax of its logits plus Gumbel noise, as
``jax.random.categorical`` draws it), ``randints(0, N, (C,))`` (the pool point
returned as ``z``).  ``init`` draws ``normals((C, N, D))`` (the pool) and
``randints(0, N, (C,))``.
"""

from __future__ import annotations

import math
from collections import namedtuple
from functools import partial

import torch

from numpyro_tpu_torch.distributions.util import cholesky_update
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.barker import resolve_init
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.infer.mcmc import MCMCKernel
from numpyro_tpu_torch.util import identity, tree_map

__all__ = ["SA", "SAAdaptState", "SAState", "sa_panel_transition", "sa_state_from_numpy"]

SAAdaptState = namedtuple("SAAdaptState", ["zs", "pes", "loc", "inv_mass_matrix_sqrt"])
SAState = namedtuple(
    "SAState",
    ["i", "z", "potential_energy", "accept_prob", "mean_accept_prob", "diverging", "adapt_state",
     "rng_key"],
)
SAConfig = namedtuple("SAConfig", ["dense", "num_warmup"])

_MAX_DELTA_ENERGY = 1000.0


def _fit_pool(zs, prev_scale, dense):
    """Gaussian moments of each chain's pool ``zs`` ``(C, N, D)``: the mean and
    the Cholesky factor of the covariance (the previous factor where it is
    not positive definite), or the per-coordinate std (ddof 0, as
    ``jnp.std``)."""
    loc = zs.mean(1)
    if dense:
        dz = zs - loc[:, None, :]
        cov = torch.bmm(dz.transpose(1, 2), dz) / zs.shape[1]
        chol = core._cholesky(cov)
        bad = torch.isnan(chol).any(-1, keepdim=True).any(-2, keepdim=True)
        return loc, torch.where(bad, prev_scale, chol)
    return loc, zs.std(1, correction=0)


def _gauss_draw(scale, eps):
    """Standard normals through the scale factor (diagonal or Cholesky)."""
    if scale.dim() == eps.dim() + 1:
        return (scale @ eps[..., None])[..., 0]
    return scale * eps


def _gauss_logpdf(loc, scale, x):
    """Batched ``N(loc, scale scale^T)`` log-density; a diagonal scale where
    it has the rank of ``x``."""
    d = x.shape[-1]
    diff = x - loc
    if scale.dim() == x.dim() + 1:
        scale = scale.expand(tuple(diff.shape[:-1]) + tuple(scale.shape[-2:]))
        w = torch.linalg.solve_triangular(scale, diff[..., None], upper=False)[..., 0]
        half_logdet = scale.diagonal(dim1=-2, dim2=-1).log().sum(-1)
    else:
        w = diff / scale
        half_logdet = scale.log().sum(-1)
    quad = w.square().sum(-1)
    return -0.5 * (quad + d * math.log(2 * math.pi)) - half_logdet


def _swap_out_factors(zs, loc, scale, z_new):
    """Proposal parameters with pool point ``n`` traded for ``z_new``, for
    every ``n`` at once: ``(C, N, D)`` locs and ``(C, N, [D,] D)`` factors.
    The pool covariance after the trade differs from the current one by three
    rank-one terms (add the newcomer, drop point n, and their cross term),
    each with pool weight 1/N."""
    w = 1.0 / zs.shape[1]
    locs = loc[:, None, :] + w * (z_new[:, None, :] - zs)
    if scale.dim() == 3:  # dense factors
        grown = cholesky_update(scale, z_new - loc, w)
        factors = cholesky_update(grown[:, None], zs - loc[:, None, :], -w)
        factors = cholesky_update(factors, z_new[:, None, :] - zs, -(w**2))
    else:
        var = scale.square() + w * (z_new - loc).square()
        var = var[:, None, :] - w * (zs - loc[:, None, :]).square()
        var = var - w**2 * (z_new[:, None, :] - zs).square()
        factors = var.sqrt()
    return locs, factors


def _row_select(pool, row_idx):
    """One row per chain of a ``(C, N, ...)`` panel."""
    return pool[torch.arange(pool.shape[0], device=pool.device), row_idx]


def sa_panel_transition(state, pe_batch, cfg):
    """One SA step for all chains.  ``pe_batch`` maps an ``(M, D)`` panel of
    flat positions to ``(M,)`` potentials."""
    zs, pes, _, prev_scale = state.adapt_state
    _, n_pool, d = zs.shape
    draws = core.as_draws(state.rng_key)
    # refit from the raw pool every step: rank-one drift never accumulates
    loc, scale = _fit_pool(zs, prev_scale, cfg.dense)

    eps = draws.normals(tuple(loc.shape), zs)
    z_new = loc + _gauss_draw(scale, eps)
    pe_new = pe_batch(z_new)
    pe_new = torch.where(torch.isnan(pe_new), math.inf, pe_new)
    diverging = (pe_new - state.potential_energy) > _MAX_DELTA_ENERGY

    # the Rao-Blackwellized trade rule: victim n < N means "pool point n is
    # discarded in favour of the newcomer"; victim N keeps the pool as it is
    locs, factors = _swap_out_factors(zs, loc, scale, z_new)
    lw_pool = _gauss_logpdf(locs, factors, zs) + pes  # (C, N)
    lw_keep = (_gauss_logpdf(loc, scale, z_new) + pe_new)[:, None]  # (C, 1)
    logits = torch.cat([lw_pool, lw_keep], dim=1)
    logits = torch.where(torch.isfinite(logits), logits, -math.inf)
    victim = torch.argmax(draws.gumbels(tuple(logits.shape), zs) + logits, -1)

    hit = (torch.arange(n_pool, device=zs.device)[None, :] == victim[:, None]) & (
        victim < n_pool)[:, None]
    zs = torch.where(hit[..., None], z_new[:, None, :], zs)
    pes = torch.where(hit, pe_new[:, None], pes)
    # the probability that the newcomer survived the trade
    accept_prob = 1.0 - torch.exp(logits[:, -1] - torch.logsumexp(logits, 1))

    # the victim's swap-out fit is the exact fit of the updated pool
    locs_aug = torch.cat([locs, loc[:, None, :]], dim=1)
    factors_aug = torch.cat([factors, scale[:, None]], dim=1)
    adapt = SAAdaptState(zs, pes, _row_select(locs_aug, victim), _row_select(factors_aug, victim))

    pick = draws.randints(0, n_pool, tuple(loc.shape[:1]), zs)
    i = int(state.i)
    n = i + 1 if i < cfg.num_warmup else i + 1 - cfg.num_warmup
    mean_accept = state.mean_accept_prob + (accept_prob - state.mean_accept_prob) / n
    return SAState(i + 1, _row_select(zs, pick), _row_select(pes, pick), accept_prob,
                   mean_accept, diverging, adapt, state.rng_key)


class SA(MCMCKernel):
    """Sample Adaptive MCMC: a gradient-free kernel that keeps
    ``adapt_state_size`` live points per chain, proposes from the Gaussian fit
    of the pool and trades one point per step under a Rao-Blackwellized rule.

    :param model: model callable (or pass ``potential_fn``).
    :param potential_fn: potential of one chain's params; requires explicit
        ``init_params``.
    :param adapt_state_size: live points per chain (default ``2 * dim``).
    :param dense_mass: fit a full covariance (True) or a diagonal one.
    :param init_strategy: site initializer for the model path.
    """

    sample_field = "z"

    def __init__(self, model=None, potential_fn=None, adapt_state_size=None, dense_mass=True,
                 init_strategy=init_to_uniform):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        self._model = model
        self._potential_fn = potential_fn
        self._adapt_state_size = adapt_state_size
        self._dense_mass = dense_mass
        self._init_strategy = init_strategy
        self._postprocess_fn = None
        self._potential_fn_gen = None
        self._num_warmup = None
        self._layout = None
        self._batched = None

    @property
    def model(self):
        return self._model

    @property
    def default_fields(self):
        return ("z", "diverging")

    def get_diagnostics_str(self, state):
        return "acc. prob={:.2f}".format(float(state.mean_accept_prob.reshape(-1)[0]))

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def _pe_batch(self, model_args, model_kwargs):
        pe_fn = self._potential_fn
        if self._potential_fn_gen is not None:
            pe_fn = self._potential_fn_gen(*model_args, **(model_kwargs or {}))
        layout = self._layout
        return infer_util.batched_value(lambda flat: pe_fn(layout.unravel_one(flat)))

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
        self._layout = layout = core.FlatLayout(tree_map(lambda x: x[0], z0))
        dim = layout.dim
        n_pool = self._adapt_state_size or 2 * dim
        if n_pool <= 1:
            raise ValueError("adapt_state_size should be greater than 1.")
        panel = layout.ravel_batch(z0)  # (C, D)
        c = panel.shape[0]
        # disperse the pool around the init point with a unit-scale cloud
        zs = panel[:, None, :] + draws.normals((c, n_pool, dim), panel)
        pes = self._pe_batch(model_args, model_kwargs)(zs.reshape(-1, dim)).reshape(c, n_pool)
        if self._dense_mass:
            prev = torch.eye(dim, dtype=panel.dtype, device=panel.device).expand(c, dim, dim)
        else:
            prev = panel.new_ones((c, dim))
        loc, scale = _fit_pool(zs, prev, self._dense_mass)
        pick = draws.randints(0, n_pool, (c,), panel)
        zero = panel.new_zeros((c,))
        state = SAState(
            0, layout.unravel_batch(_row_select(zs, pick)), _row_select(pes, pick), zero, zero,
            torch.zeros((c,), dtype=torch.bool, device=panel.device),
            SAAdaptState(zs, pes, loc, scale), rng_key,
        )
        return state if self._batched else tree_map(lambda x: x[0], state)

    def sample(self, state, model_args, model_kwargs):
        if not self._batched:
            state = tree_map(lambda x: x[None], state)
        state = state._replace(z=self._layout.ravel_batch(state.z))
        new = sa_panel_transition(
            state, self._pe_batch(model_args, model_kwargs),
            SAConfig(self._dense_mass, self._num_warmup),
        )
        new = new._replace(z=self._layout.unravel_batch(new.z))
        return new if self._batched else tree_map(lambda x: x[0], new)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_potential_fn_gen"] = None
        return state


def sa_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``SAState`` from a JAX ``SAState`` whose leaves are numpy
    arrays; JAX's keys are dropped for ``rng_key``."""
    get = partial(infer_util.state_field, fields)
    to = partial(infer_util.tree_from_numpy, device=device)
    adapt = get("adapt_state")
    return SAState(
        int(get("i")), to(get("z")), to(get("potential_energy")), to(get("accept_prob")),
        to(get("mean_accept_prob")), to(get("diverging")),
        SAAdaptState(*(to(infer_util.state_field(adapt, k)) for k in SAAdaptState._fields)),
        rng_key,
    )