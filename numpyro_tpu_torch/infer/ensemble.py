"""Ensemble samplers: AIES (affine-invariant, emcee family) and ESS (ensemble
slice sampling, zeus family) (port of ``numpyro_tpu/infer/ensemble.py``).

The whole ensemble is one ``(num_chains, dim)`` panel, updated in two halves
per step: the first half given the second, then the second given the
refreshed first.  Walker interactions are batched gathers, and distinct
walker pairs come from a modular offset.  They need an even number of chains,
all given to ``init`` at once (``chain_method="vectorized"``).

What differs from the JAX kernels:

- The ESS bracket loops (``lax.while_loop`` there) are Python loops that read
  their condition on the host once an iteration (one sync each); the step-out
  loop evaluates both ends of every walker's bracket in one batched call.
- With more than one move the move is drawn on the host (one sync a half
  step); ``lax.switch`` picks it on the device in JAX.
- ``KDEMove`` uses this module's :class:`gaussian_kde`, the counterpart of
  ``jax.scipy.stats.gaussian_kde`` (Scott's bandwidth rule by default).
- The step index ``i`` is a host number.

Draws come from the states' draw sources (``hmc_core.GeneratorDraws``).  A
step draws from ``state.rng_key`` the shuffle, ``permutations((C,))``, where
``randomize_split``; each half step then draws from the inner state's source:
the move (``choice``, only with more than one move), the move's own draws
(below), and for AIES ``uniforms((M,))`` (the accept test), for ESS
``uniforms((M, 1))`` (the slice height), ``uniforms((M, 1))`` twice (the
bracket's position and the split of the step budget) and one
``uniforms((M, 1))`` per shrink iteration.  The moves: ``DEMove`` draws a
distinct pair (``randints(0, n, (M,))``, then ``randints(1, n, (M,))``) and
``normals((M, 1))``; ``StretchMove`` ``uniforms((M,))`` and
``randints(0, n, (M,))``; ``RandomMove`` and ``GaussianMove``
``normals((M, D))``; ``KDEMove`` ``categorical(weights, (2M,))`` and
``normals((2M, D))``; ``DifferentialMove`` a distinct pair.
"""

from __future__ import annotations

import math
import warnings
from abc import ABC, abstractmethod
from collections import namedtuple

import torch

from numpyro_tpu_torch.distributions.util import cholesky, inv
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.ensemble_util import batch_ravel_pytree
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.infer.mcmc import MCMCKernel
from numpyro_tpu_torch.infer.util import initialize_model
from numpyro_tpu_torch.util import identity, tree_leaves

__all__ = [
    "AIES", "AIESState", "ESS", "ESSState", "EnsembleSampler", "EnsembleSamplerState",
    "ensemble_state_from_numpy", "gaussian_kde",
]

EnsembleSamplerState = namedtuple("EnsembleSamplerState", ["z", "inner_state", "rng_key"])
AIESState = namedtuple("AIESState", ["i", "accept_prob", "mean_accept_prob", "rng_key"])
ESSState = namedtuple("ESSState", ["i", "n_expansions", "n_contractions", "mu", "rng_key"])


class gaussian_kde:
    """Gaussian kernel density estimate of ``dataset`` ``(d, n)`` (or
    ``(n,)``), the counterpart of ``jax.scipy.stats.gaussian_kde``:
    ``bw_method`` is ``None`` or ``"scott"`` (Scott's rule), ``"silverman"``,
    a number, or a callable of the estimate; the kernel covariance is the
    weighted data covariance (unbiased) times the factor squared."""

    def __init__(self, dataset, bw_method=None, weights=None):
        dataset = torch.atleast_2d(dataset)
        if not dataset.numel() > 1:
            raise ValueError("`dataset` input should have multiple elements.")
        d, n = dataset.shape
        if weights is None:
            weights = torch.full((n,), 1.0 / n, dtype=dataset.dtype, device=dataset.device)
        else:
            weights = torch.atleast_1d(torch.as_tensor(weights, dtype=dataset.dtype))
            weights = weights / weights.sum()
        self.dataset, self.weights, self.d, self.n = dataset, weights, d, n
        self.neff = 1.0 / weights.square().sum()
        if bw_method is None or bw_method == "scott":
            factor = self.neff ** (-1.0 / (d + 4))
        elif bw_method == "silverman":
            factor = (self.neff * (d + 2) / 4.0) ** (-1.0 / (d + 4))
        elif isinstance(bw_method, (int, float)) and not isinstance(bw_method, bool):
            factor = bw_method
        elif callable(bw_method):
            factor = bw_method(self)
        else:
            raise ValueError(
                "`bw_method` should be 'scott', 'silverman', a scalar, or a callable."
            )
        data_cov = torch.atleast_2d(torch.cov(dataset, correction=1, aweights=weights))
        self.covariance = data_cov * factor**2
        self.inv_cov = inv(data_cov) / factor**2

    def resample(self, draws, shape=()):
        """Draws of shape ``(d,) + shape`` from the estimate; ``draws`` is a
        ``torch.Generator`` or a draw source (``categorical`` for the data
        points, then ``normals`` for the kernel noise)."""
        draws = core.as_draws(draws)
        shape = tuple(shape)
        ind = draws.categorical(self.weights, shape)
        factor = cholesky(self.covariance)
        eps = draws.normals(shape + (self.d,), self.dataset) @ factor.T
        return self.dataset[:, ind] + torch.movedim(eps, -1, 0)

    def logpdf(self, points):
        """Log density at ``points`` ``(d, m)`` (or ``(m,)`` for d = 1)."""
        points = torch.atleast_2d(torch.as_tensor(points, dtype=self.dataset.dtype))
        if points.shape[0] != self.d:
            if points.shape[0] == 1 and points.shape[1] == self.d:
                points = points.reshape(self.d, 1)
            else:
                raise ValueError(
                    f"points have dimension {points.shape[0]}, dataset has dimension {self.d}"
                )
        whitening = cholesky(self.inv_cov)
        train = self.dataset.T @ whitening
        test = points.T @ whitening
        log_norm = whitening.diagonal().log().sum() - 0.5 * self.d * math.log(2 * math.pi)
        arg = log_norm - 0.5 * (test[:, None, :] - train[None, :, :]).square().sum(-1)
        return torch.logsumexp(self.weights.log()[None, :] + arg, dim=1)


def _distinct_pair(draws, n, shape, like):
    """Uniform ordered pairs (i, j), i != j, by a modular offset."""
    i = draws.randints(0, n, shape, like)
    delta = draws.randints(1, n, shape, like)
    return i, (i + delta) % n


def _move_weights(moves):
    keys = list(moves.keys())
    assert all(callable(m) for m in keys)
    weights = torch.tensor([float(v) for v in moves.values()]) / len(keys)
    assert bool((weights >= 0).all())
    return keys, weights


class EnsembleSampler(MCMCKernel, ABC):
    """Shared machinery: one MCMC step updates the first half of the
    ensemble given the second, then the second given the refreshed first."""

    sample_field = "z"

    def __init__(self, model=None, potential_fn=None, *, randomize_split, init_strategy):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        self._model = model
        self._potential_fn = potential_fn
        self._batch_log_density = None
        self._num_chains = None
        self._randomize_split = randomize_split
        self._init_strategy = init_strategy
        self._postprocess_fn = None

    @property
    def model(self):
        return self._model

    @property
    def is_ensemble_kernel(self):
        return True

    @abstractmethod
    def init_inner_state(self, rng_key, like):
        raise NotImplementedError

    @abstractmethod
    def update_active_chains(self, active, inactive, inner_state):
        raise NotImplementedError

    def _pick_move(self, draws):
        return 0 if len(self._moves) == 1 else draws.choice(self._weights)

    def _setup_density(self, generator, model_args, model_kwargs, init_params):
        if self._model is not None:
            info = initialize_model(
                generator, self._model, num_chains=self._num_chains, dynamic_args=True,
                init_strategy=self._init_strategy, model_args=model_args,
                model_kwargs=model_kwargs, validate_grad=False,
            )
            self._potential_fn = info.potential_fn(*model_args, **model_kwargs)
            self._postprocess_fn = info.postprocess_fn
            if init_params is None:
                init_params = info.param_info.z
        flat, unravel = batch_ravel_pytree(init_params)
        pe = self._potential_fn
        value = infer_util.batched_value(pe)
        self._batch_log_density = lambda panel: -value(unravel(panel))
        dim = flat.shape[1]
        if self._num_chains < 2 * dim:
            warnings.warn(
                "ensemble samplers want num_chains >= 2 * n_params "
                f"(got num_chains={self._num_chains}, n_params={dim})",
                stacklevel=2,
            )
        return init_params, flat

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
             num_chains=None):
        """``rng_key``: a ``torch.Generator`` on the chains' device (or a draw
        source); ``num_chains`` must be given and even."""
        model_kwargs = {} if model_kwargs is None else model_kwargs
        assert num_chains is not None and num_chains > 1, (
            "EnsembleSampler only supports chain_method='vectorized' with num_chains > 1."
        )
        assert num_chains % 2 == 0, "Number of chains must be even."
        self._num_chains = num_chains
        if init_params is not None:
            assert all(x.shape[0] == num_chains for x in tree_leaves(init_params)), (
                "The batch dimension of each param must match num_chains"
            )
        elif self._model is None:
            raise ValueError("Valid value of `init_params` must be provided with `potential_fn`.")
        infer_util.pin_full_f32_matmul()
        generator = getattr(core.as_draws(rng_key), "generator", rng_key)
        init_params, flat = self._setup_density(generator, model_args, model_kwargs, init_params)
        self._weights = self._weights.to(flat.device)
        self._num_warmup = num_warmup
        return EnsembleSamplerState(init_params, self.init_inner_state(rng_key, flat), rng_key)

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def sample(self, state, model_args, model_kwargs):
        z, inner_state, rng_key = state
        core.refuse_sharded(rng_key, type(self).__name__)
        panel, unravel = batch_ravel_pytree(z)
        if self._randomize_split:
            draws = core.as_draws(rng_key)
            panel = panel[draws.permutations((self._num_chains,), panel)]
        half = self._num_chains // 2
        for mine, other in ((slice(0, half), slice(half, None)),
                            (slice(half, None), slice(0, half))):
            refreshed, inner_state = self.update_active_chains(
                panel[mine], panel[other], inner_state
            )
            panel = torch.cat([refreshed, panel[other]] if mine.start == 0
                              else [panel[other], refreshed])
        return EnsembleSamplerState(unravel(panel), inner_state, rng_key)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_batch_log_density"] = None
        return state


class AIES(EnsembleSampler):
    """Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move;
    Nelson et al. 2013 differential-evolution move).  ``moves`` maps moves to
    weights."""

    def __init__(self, model=None, potential_fn=None, randomize_split=False, moves=None,
                 init_strategy=init_to_uniform):
        if moves:
            self._moves, self._weights = _move_weights(moves)
        else:
            self._moves, self._weights = [AIES.DEMove()], torch.ones(1)
        super().__init__(model, potential_fn, randomize_split=randomize_split,
                         init_strategy=init_strategy)

    def get_diagnostics_str(self, state):
        return "acc. prob={:.2f}".format(float(state.inner_state.mean_accept_prob))

    def init_inner_state(self, rng_key, like):
        zero = like.new_zeros(())
        return AIESState(0.0, zero, zero, rng_key)

    def update_active_chains(self, active, inactive, inner_state):
        i, _, mean_accept, rng_key = inner_state
        draws = core.as_draws(rng_key)
        move = self._moves[self._pick_move(draws)]
        proposal, hastings = move(draws, active, inactive)
        log_ratio = hastings + self._batch_log_density(proposal) - self._batch_log_density(active)
        take = torch.log(draws.uniforms(tuple(log_ratio.shape), active)) < log_ratio
        refreshed = torch.where(take[:, None], proposal, active)
        accept_rate = take.to(active.dtype).mean()
        half_step = i + 0.5
        denom = half_step if i < self._num_warmup else half_step - self._num_warmup
        mean_accept = mean_accept + (accept_rate - mean_accept) / denom
        return refreshed, AIESState(half_step, accept_rate, mean_accept, rng_key)

    @staticmethod
    def DEMove(sigma=1.0e-5, g0=None):
        """Differential-evolution proposal: a step along the difference of a
        random distinct pair of complementary walkers."""

        def de_move(draws, active, inactive):
            m, dim = active.shape
            scale = g0 if g0 else 2.38 / math.sqrt(2.0 * dim)
            i, j = _distinct_pair(draws, inactive.shape[0], (m,), active)
            step = inactive[j] - inactive[i]
            gamma = scale * (1.0 + sigma * draws.normals((m, 1), active))
            return active + gamma * step, active.new_zeros(m)

        return de_move

    @staticmethod
    def StretchMove(a=2.0):
        """Stretch move: contract or expand toward a random complementary
        walker with z ~ g(z) proportional to 1/sqrt(z)."""

        def stretch_move(draws, active, inactive):
            m, dim = active.shape
            u = draws.uniforms((m,), active)
            zz = (1.0 + (a - 1.0) * u) ** 2 / a
            anchor = inactive[draws.randints(0, inactive.shape[0], (m,), active)]
            proposal = anchor + zz[:, None] * (active - anchor)
            return proposal, (dim - 1.0) * torch.log(zz)

        return stretch_move


class ESS(EnsembleSampler):
    """Ensemble slice sampling (Karamanis & Beutler 2020).  ``moves`` maps
    direction generators to weights."""

    def __init__(self, model=None, potential_fn=None, randomize_split=True, moves=None,
                 max_steps=10_000, max_iter=10_000, init_mu=1.0, tune_mu=True,
                 init_strategy=init_to_uniform):
        if moves:
            self._moves, self._weights = _move_weights(moves)
        else:
            self._moves, self._weights = [ESS.DifferentialMove()], torch.ones(1)
        assert init_mu > 0
        self._max_steps = max_steps
        self._max_iter = max_iter
        self._init_mu = init_mu
        self._tune_mu = tune_mu
        super().__init__(model, potential_fn, randomize_split=randomize_split,
                         init_strategy=init_strategy)

    def init_inner_state(self, rng_key, like):
        zero = torch.zeros((), dtype=torch.int64, device=like.device)
        return ESSState(0.0, zero, zero, torch.tensor(float(self._init_mu), dtype=like.dtype,
                                                      device=like.device), rng_key)

    def _logdens_col(self, panel):
        return self._batch_log_density(panel)[:, None]

    def update_active_chains(self, active, inactive, inner_state):
        i, n_exp, n_con, mu, rng_key = inner_state
        draws = core.as_draws(rng_key)
        move = self._moves[self._pick_move(draws)]
        directions = move(draws, inactive, mu)
        m = active.shape[0]
        # the slice height under the current point
        height = self._logdens_col(active) + torch.log(draws.uniforms((m, 1), active))
        n_out, left, right = self._expand_bracket(draws, height, active, directions)
        proposal, n_in = self._sample_bracket(draws, height, left, right, active, directions)
        n_exp = n_exp + n_out
        n_con = n_con + n_in
        half_step = i + 0.5
        if self._tune_mu and half_step % 1.0 == 0:
            # mu is retuned once per full step (on the second half update)
            exp_safe = torch.clamp(n_exp, min=1)
            mu = (2.0 * exp_safe / (exp_safe + n_con)).to(mu.dtype)
            n_exp = torch.zeros_like(n_exp)
            n_con = torch.zeros_like(n_con)
        return proposal, ESSState(half_step, n_exp, n_con, mu, rng_key)

    # direction generators

    @staticmethod
    def RandomMove():
        """Isotropic random directions (no ensemble interaction)."""

        def random_move(draws, inactive, mu):
            raw = draws.normals(tuple(inactive.shape), inactive)
            return 2.0 * mu * raw / torch.linalg.vector_norm(raw, dim=0)

        return random_move

    @staticmethod
    def KDEMove(bw_method=None):
        """Directions from a Gaussian KDE of the complementary half."""

        def kde_move(draws, inactive, mu):
            m = inactive.shape[0]
            kde = gaussian_kde(inactive.T, bw_method=bw_method)
            samples = kde.resample(draws, (2 * m,)).T
            return 2.0 * mu * (samples[:m] - samples[m:])

        return kde_move

    @staticmethod
    def GaussianMove():
        """Directions from a moment-matched Gaussian of the half."""

        def gaussian_move(draws, inactive, mu):
            cov = torch.atleast_2d(torch.cov(inactive.T))
            scale_tril = cholesky(cov)
            eps = draws.normals(tuple(inactive.shape), inactive)
            return 2.0 * mu * (scale_tril @ eps[..., None])[..., 0]

        return gaussian_move

    @staticmethod
    def DifferentialMove():
        """Directions along random distinct walker-pair differences (the
        robust default)."""

        def differential_move(draws, inactive, mu):
            m = inactive.shape[0]
            i, j = _distinct_pair(draws, m, (m,), inactive)
            return 2.0 * mu * (inactive[j] - inactive[i])

        return differential_move

    # the slice machinery

    def _expand_bracket(self, draws, height, active, directions):
        """Grow [left, right] until both ends are outside the slice, with a
        per-walker stepping budget split at random (Neal 2003's step-out,
        batched over all walkers by masks)."""
        m = active.shape[0]
        left = -draws.uniforms((m, 1), active)
        right = left + 1.0
        budget_l = torch.floor(draws.uniforms((m, 1), active) * self._max_steps)
        budget_r = (self._max_steps - 1) - budget_l
        grow_l = torch.ones((m, 1), dtype=torch.bool, device=active.device)
        grow_r = grow_l
        count = torch.zeros((), dtype=torch.int64, device=active.device)
        it = 0
        while it < self._max_iter and bool((grow_l | grow_r).any()):
            both = self._logdens_col(torch.cat([active + left * directions,
                                                active + right * directions]))
            inside_l, inside_r = both[:m] > height, both[m:] > height
            step_l, step_r = grow_l & inside_l, grow_r & inside_r
            left = torch.where(step_l, left - 1.0, left)
            right = torch.where(step_r, right + 1.0, right)
            budget_l = torch.where(step_l, budget_l - 1.0, budget_l)
            budget_r = torch.where(step_r, budget_r - 1.0, budget_r)
            # a walker keeps growing a side only while it is still inside
            grow_l = step_l & (budget_l > 0)
            grow_r = step_r & (budget_r > 0)
            count = count + step_l.sum() + step_r.sum()
            it += 1
        return count, left, right

    def _sample_bracket(self, draws, height, left, right, active, directions):
        """Draw within [left, right], shrinking toward the current point on
        each rejection (batched)."""
        m = active.shape[0]
        proposal = active
        pending = torch.ones((m, 1), dtype=torch.bool, device=active.device)
        count = torch.zeros((), dtype=torch.int64, device=active.device)
        it = 0
        while it < self._max_iter and bool(pending.any()):
            offset = left + (right - left) * draws.uniforms((m, 1), active)
            candidate = active + offset * directions
            proposal = torch.where(pending, candidate, proposal)
            rejected = pending & (self._logdens_col(proposal) < height)
            shrink_l = rejected & (offset < 0)
            shrink_r = rejected & (offset > 0)
            left = torch.where(shrink_l, offset, left)
            right = torch.where(shrink_r, offset, right)
            count = count + shrink_l.sum() + shrink_r.sum()
            pending = rejected
            it += 1
        return proposal, count


def ensemble_state_from_numpy(fields, device="cpu", rng_key=None, inner_rng_key=None):
    """The port's ``EnsembleSamplerState`` (with an ``AIESState`` or an
    ``ESSState`` inside) from a JAX one whose leaves are numpy arrays; JAX's
    keys are dropped for ``rng_key`` and ``inner_rng_key``."""
    inner = infer_util.state_field(fields, "inner_state")
    names = inner._fields if hasattr(inner, "_fields") else tuple(inner)
    cls = ESSState if "mu" in names else AIESState
    values = {
        name: infer_util.tree_from_numpy(infer_util.state_field(inner, name), device)
        for name in cls._fields if name not in ("i", "rng_key")
    }
    values["i"] = float(infer_util.state_field(inner, "i"))
    values["rng_key"] = inner_rng_key
    z = infer_util.tree_from_numpy(infer_util.state_field(fields, "z"), device)
    return EnsembleSamplerState(z, cls(**values), rng_key)