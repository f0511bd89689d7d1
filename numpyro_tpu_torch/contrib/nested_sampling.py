"""Nested sampling (port of ``numpyro_tpu/contrib/nested_sampling.py``).

The JAX package's sampler, not the ``jaxns`` wrapper of the reference:

- live points are replaced in batches (``num_delete`` worst points an
  iteration), each replacement evolved by whitened random-direction slice
  sampling, the K walkers in lock-step, so every model evaluation is one
  batched call over the walkers (``torch.func.vmap``);
- sampling happens in the unconstrained space (``biject_to``), with the
  hard-likelihood constraint L > L* inside the slice bracket;
- whitening uses the Cholesky factor of the survivors' covariance,
  refreshed every iteration (``jnp.cov``'s formula, in place of
  ``torch.cov``, which reads the host on the card);
- dead points go to a ``(max_iters * num_delete, dim)`` buffer allocated
  up front, with the batched deletion's shrinkage weights (removing the
  j-th worst of a batch compresses the volume by 1/(N - j)).

Evidence, weighted posterior samples, ESS and the information-based log Z
error come out of that buffer, as in the JAX package.

The JAX package's ``lax.while_loop`` is a Python loop here, and its
condition is the only host read of an iteration.  A slice pass makes JAX's
fixed 4 expand rounds and 10 shrink rounds (an early exit would read the
host every round).  Each round is one batched evaluation of the prior
(with the log-Jacobians) and the likelihood from one trace of the model;
an expand round probes both ends of the brackets in that one evaluation, of
2K walkers.  So an iteration makes ``14 * num_slices`` evaluations, where
it counts JAX's ``18 * num_slices * num_delete`` likelihood evaluations in
``num_likelihood_evals``; the likelihood of each walker's end point is
carried from the probe that accepted it (JAX evaluates it once more).

Draws come from a draw source (``infer.hmc_core.GeneratorDraws``) in this
order: ``prior`` (the live set: the model's own draws under ``vmap``), then
per iteration ``randints(0, num_live - num_delete, (num_delete,))`` (the
survivors to clone) and per slice pass ``normals((num_delete, dim))`` (the
directions), ``uniforms((num_delete,))`` (the slice levels) and ten
``uniforms((num_delete,))`` (the shrink rounds); ``get_samples`` draws
``categorical``.  The model is first traced once on the source's
``generator`` for its sites' shapes.

``NestedSampler(..., device=None)`` runs on ``cuda``; ``run`` raises where
there is no CUDA device and never carries on on the CPU.
"""

from __future__ import annotations

import math
import time
from collections import namedtuple

import numpy as np
import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions.util import cholesky
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.util import _get_model_transforms

__all__ = ["NestedSampler", "NestedSamplerResults"]

NestedSamplerResults = namedtuple(
    "NestedSamplerResults",
    [
        "log_Z",          # evidence estimate (log)
        "log_Z_err",      # sqrt(H / num_live) information-based error
        "ess",            # Kish effective sample size of the weighted draws
        "h",              # information (KL from prior to posterior), nats
        "num_iterations", # loop iterations actually executed
        "num_likelihood_evals",
        "samples",        # unconstrained dead points, flat (M, D)
        "log_weights",    # normalized posterior log-weights, (M,)
        "log_likelihoods",
    ],
)

EXPAND_ROUNDS, SHRINK_ROUNDS = 4, 10


def _split_densities(model, model_args, model_kwargs, inv_transforms, layout):
    """``(log_prior, log_lik)`` of one flat unconstrained point from one
    trace: the prior term sums the ``biject_to`` log-Jacobians and the
    unobserved sample sites (the density of the pushed-forward prior on the
    unconstrained space), the likelihood the observed sites."""

    def split(z_flat):
        z = layout.unravel_one(z_flat)
        x = {name: t(z[name]) for name, t in inv_transforms.items()}
        log_prior = z_flat.new_zeros(())
        for name, t in inv_transforms.items():
            log_prior = log_prior + t.log_abs_det_jacobian(z[name], x[name]).sum()
        tr = handlers.trace(handlers.substitute(model, data=x)).get_trace(
            *model_args, **model_kwargs)
        log_lik = z_flat.new_zeros(())
        for site in tr.values():
            if site["type"] != "sample":
                continue
            lp = site["fn"].log_prob(site["value"]).sum()
            if site["is_observed"]:
                log_lik = log_lik + lp
            else:
                log_prior = log_prior + lp
        return log_prior, log_lik

    return split


class NestedSampler:
    """Nested sampler over a model of the port (evidence and posterior).

    :param model: model callable with continuous latent sites.
    :param constructor_kwargs: ``num_live_points`` (default ``25 * dim``,
        at least 100), ``max_samples`` (dead-point budget, default 20000),
        ``num_delete`` (live points replaced per iteration, default
        ``num_live_points // 10``), ``num_slices`` (slice-sampling passes per
        replacement, default ``5 * dim``).
    :param termination_kwargs: ``dlogZ``: stop once the remaining live-point
        evidence can change log Z by less than this (default 1e-3).
    :param device: where the run's generator and draws live; ``None`` is
        ``torch.device("cuda")``.
    """

    def __init__(self, model, *, constructor_kwargs=None, termination_kwargs=None, device=None):
        self.model = model
        self.constructor_kwargs = dict(constructor_kwargs or {})
        self.termination_kwargs = dict(termination_kwargs or {})
        self.device = torch.device("cuda" if device is None else device)
        self._results = None
        self._layout = None
        self._inv_transforms = None
        # iterations, batched evaluations and seconds of the last run
        self.last_run_stats = {}

    # -- model bridge -------------------------------------------------------

    def _draws(self, rng_key):
        """A draw source: from an int seed or a generator on the device, or
        the caller's draw source as it is."""
        if isinstance(rng_key, (int, torch.Generator)):
            return core.as_draws(infer_util.device_generator(rng_key, self.device,
                                                             "NestedSampler"))
        return rng_key

    def _setup(self, generator, model_args, model_kwargs):
        inv_transforms, _, has_enum, trace = _get_model_transforms(
            handlers.seed(self.model, generator), model_args, model_kwargs
        )
        if has_enum or not inv_transforms:
            raise ValueError(
                "NestedSampler supports models with continuous latent sites "
                "only; marginalize discrete sites first."
            )
        self._inv_transforms = inv_transforms
        self._layout = core.FlatLayout(
            {name: t.inv(trace[name]["value"]) for name, t in inv_transforms.items()})
        split = _split_densities(self.model, model_args, model_kwargs, inv_transforms,
                                 self._layout)
        return self._layout.dim, infer_util.batched_value(split)

    def _prior_draws(self, draws, num, model_args, model_kwargs):
        """``num`` prior points in unconstrained coordinates, ``(num, dim)``."""

        def draw(generator):
            with handlers.block(), handlers.trace() as tr:
                handlers.seed(self.model, generator)(*model_args, **model_kwargs)
            return {name: tr[name]["value"] for name in self._inv_transforms}

        values = draws.prior(draw, num)
        return self._layout.ravel_batch(
            {name: t.inv(values[name]) for name, t in self._inv_transforms.items()})

    # -- the sampler --------------------------------------------------------

    def run(self, rng_key, *args, **kwargs):
        """The whole run.  ``rng_key`` is an int seed, from which the run
        makes a generator on its device, a ``torch.Generator`` on that
        device, or a draw source (this module's docstring)."""
        t0 = time.perf_counter()
        draws = self._draws(rng_key)
        dim, split = self._setup(draws.generator, args, kwargs)
        evals0 = infer_util.potential_evals

        ck = self.constructor_kwargs
        num_live = int(ck.get("num_live_points", max(100, 25 * dim)))
        num_delete = int(ck.get("num_delete", max(1, num_live // 10)))
        num_slices = int(ck.get("num_slices", 5 * dim))
        max_samples = int(ck.get("max_samples", 20000))
        max_iters = -(-max_samples // num_delete)  # ceil
        log_dlogz = math.log(float(self.termination_kwargs.get("dlogZ", 1e-3)))

        live = self._prior_draws(draws, num_live, args, kwargs)
        live_lp, live_ll = split(live)
        K = num_delete

        # the batched deletion's shrinkage: removing the j-th worst of the
        # batch (no replacement until the batch completes) compresses the
        # volume by 1/(N - j), not 1/N
        rank_rate = 1.0 / (num_live - torch.arange(K, dtype=live.dtype, device=live.device))
        rank_cum = torch.cumsum(rank_rate, 0)  # volume drop after the j-th removal
        batch_shrink = float(rank_cum[-1])  # drop per full batch
        rank_logdx = torch.log1p(-torch.exp(-rank_rate))  # log(1 - shrink_j)

        buf_z = live.new_zeros((max_iters * K, dim))
        buf_ll = live.new_full((max_iters * K,), -math.inf)
        logz = live.new_full((), -math.inf)
        it, evals = 0, 0
        while it < max_iters:
            # if every live point were at the current max likelihood, how
            # much evidence could still arrive?  (the one host read)
            remaining = live_ll.max() + (-it * batch_shrink)
            if not bool(remaining - torch.logaddexp(logz, remaining) > log_dlogz):
                break
            order = torch.argsort(live_ll, stable=True)
            dead_idx, survivor_idx = order[:K], order[K:]
            dead_ll = live_ll[dead_idx]
            lmin = dead_ll[-1]  # hardest constraint in this batch

            # record the dead batch with sequential shrinkage weights
            buf_z[it * K:(it + 1) * K] = live[dead_idx]
            buf_ll[it * K:(it + 1) * K] = dead_ll
            logw = -(it * batch_shrink + rank_cum - rank_rate) + rank_logdx
            logz = torch.logsumexp(torch.cat([logz[None], logw + dead_ll]), 0)

            # whitening from the surviving set (``jnp.cov``'s formula:
            # ``torch.cov`` reads the host on the card)
            surv = live[survivor_idx]
            centred = surv - surv.mean(0)
            cov = centred.T @ centred / (surv.shape[0] - 1) + 1e-6 * torch.eye(
                dim, dtype=live.dtype, device=live.device)
            chol = cholesky(cov)

            # clone random survivors and evolve them under L > lmin
            src = draws.randints(0, num_live - K, (K,), live)
            z_new = surv[src]
            lp_new = live_lp[survivor_idx][src]
            ll_new = live_ll[survivor_idx][src]
            for _ in range(num_slices):
                z_new, lp_new, ll_new = self._slice_pass(draws, split, z_new, lp_new, ll_new,
                                                         lmin, chol)
                evals += (2 * EXPAND_ROUNDS + SHRINK_ROUNDS) * K

            live[dead_idx] = z_new
            live_ll[dead_idx] = ll_new
            live_lp[dead_idx] = lp_new
            it += 1

        # fold the surviving live set into the evidence: the final prior
        # volume splits evenly across the N live points
        live_logw = live.new_full((num_live,), -it * batch_shrink) - math.log(num_live)
        dead_cs = torch.arange(buf_ll.shape[0], device=live.device)
        dead_it, dead_rank = dead_cs // K, dead_cs % K
        dead_logw = torch.where(
            dead_cs < it * K,
            -(dead_it.to(live.dtype) * batch_shrink + rank_cum[dead_rank] - rank_rate[dead_rank])
            + rank_logdx[dead_rank],
            -math.inf,
        )

        all_z = torch.cat([buf_z, live], dim=0)
        all_ll = torch.cat([buf_ll, live_ll], dim=0)
        all_logw = torch.cat([dead_logw, live_logw], dim=0)

        log_zi = all_logw + torch.where(torch.isfinite(all_ll), all_ll, -math.inf)
        log_z = torch.logsumexp(log_zi, 0)
        log_post = log_zi - log_z  # normalized posterior weights

        w = torch.exp(log_post)
        h = torch.sum(torch.where(w > 0, w * (all_ll - log_z), 0.0))
        self._results = NestedSamplerResults(
            log_Z=log_z,
            log_Z_err=torch.sqrt(torch.abs(h) / num_live),
            ess=torch.exp(-torch.logsumexp(2 * log_post, 0)),
            h=h,
            num_iterations=it,
            num_likelihood_evals=evals,
            samples=all_z,
            log_weights=log_post,
            log_likelihoods=all_ll,
        )
        self.last_run_stats = {"iterations": it,
                               "evaluations": infer_util.potential_evals - evals0,
                               "seconds": time.perf_counter() - t0}
        self._model_args = args
        self._model_kwargs = kwargs

    @staticmethod
    def _slice_pass(draws, split, z0, lp0, ll0, lmin, chol):
        """One whitened random-direction slice pass for a (K, D) batch.

        Neal's procedure, batched: step the bracket out until both ends
        leave the slice, then shrink with freeze-at-first-accept, so the
        draw is uniform over the slice segment."""
        K = z0.shape[0]
        ndir = draws.normals(tuple(z0.shape), z0)
        ndir = ndir / torch.linalg.norm(ndir, dim=-1, keepdim=True)
        direction = ndir @ chol.T  # the whitened step rides the live set's geometry
        level = lp0 + torch.log(draws.uniforms((K,), z0))

        def probe(t, z, lv):
            cand = z + t[:, None] * direction.repeat(t.shape[0] // K, 1)
            cand_lp, cand_ll = split(cand)
            return (cand_lp > lv) & (cand_ll > lmin), cand, cand_lp, cand_ll

        lo, hi = z0.new_full((K,), -1.0), z0.new_full((K,), 1.0)
        z2, level2 = torch.cat([z0, z0]), torch.cat([level, level])
        for _ in range(EXPAND_ROUNDS):
            ok = probe(torch.cat([lo, hi]), z2, level2)[0]
            lo = torch.where(ok[:K], 2.0 * lo, lo)
            hi = torch.where(ok[K:], 2.0 * hi, hi)

        z_cur, lp_cur, ll_cur = z0, lp0, ll0
        done = torch.zeros((K,), dtype=torch.bool, device=z0.device)
        for _ in range(SHRINK_ROUNDS):
            t = lo + (hi - lo) * draws.uniforms((K,), z0)
            ok, cand, cand_lp, cand_ll = probe(t, z0, level)
            take = ok & ~done
            z_cur = torch.where(take[:, None], cand, z_cur)
            lp_cur = torch.where(take, cand_lp, lp_cur)
            ll_cur = torch.where(take, cand_ll, ll_cur)
            done = done | ok
            # rejected endpoints shrink toward t = 0 (the current point), so
            # the bracket always keeps an acceptable segment
            miss = ~ok & ~done
            lo = torch.where(miss & (t < 0), torch.maximum(lo, t), lo)
            hi = torch.where(miss & (t >= 0), torch.minimum(hi, t), hi)
        return z_cur, lp_cur, ll_cur

    # -- results ------------------------------------------------------------

    def _constrained_samples(self, flat):
        z = self._layout.unravel_batch(flat)
        return {name: t(z[name]) for name, t in self._inv_transforms.items()}

    def get_weighted_samples(self):
        """(constrained posterior samples, normalized log-weights)."""
        res = self._require_results()
        return self._constrained_samples(res.samples), res.log_weights

    def get_samples(self, rng_key, num_samples):
        """Equal-weight posterior draws by categorical resampling;
        ``rng_key`` as in :meth:`run`."""
        res = self._require_results()
        idx = self._draws(rng_key).categorical(torch.exp(res.log_weights), (num_samples,))
        return self._constrained_samples(res.samples[idx])

    def diagnostics(self):
        return self._require_results()

    def print_summary(self):
        res = self._require_results()
        print(
            f"logZ = {float(res.log_Z):.4f} +/- {float(res.log_Z_err):.4f}  "
            f"(H = {float(res.h):.3f} nats, ESS = {float(res.ess):.1f}, "
            f"{int(res.num_iterations)} iterations, "
            f"{int(res.num_likelihood_evals)} likelihood evals)"
        )
        samples, logw = self.get_weighted_samples()
        w = torch.exp(logw)
        for name, value in samples.items():
            flat = value.reshape(value.shape[0], -1)
            mean = w @ flat
            std = torch.sqrt(w @ (flat - mean) ** 2)
            print(f"  {name}: mean {np_str(mean)}  std {np_str(std)}")

    def _require_results(self):
        if self._results is None:
            raise RuntimeError("NestedSampler.run must be called first.")
        return self._results


def np_str(x):
    return np.array2string(x.detach().cpu().numpy(), precision=3)
