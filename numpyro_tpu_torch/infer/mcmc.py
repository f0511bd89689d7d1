"""MCMC driver (port of ``numpyro_tpu/infer/mcmc.py`` for
``chain_method="vectorized"``: all chains advance together in one batched
program).  ``"parallel"`` and ``"sequential"`` are not ported yet
(ROADMAP.md)."""

from __future__ import annotations

import time

import torch

__all__ = ["MCMC"]


class MCMC:
    """MCMC driver.

    :param sampler: a ``NUTS`` kernel.
    :param chain_method: only ``"vectorized"`` is ported.
    """

    def __init__(
        self,
        sampler,
        *,
        num_warmup,
        num_samples,
        num_chains=1,
        thinning=1,
        postprocess_fn=None,
        chain_method="vectorized",
        progress_bar=False,
    ):
        if chain_method != "vectorized":
            raise NotImplementedError(
                f"chain_method={chain_method!r} is not ported to numpyro_tpu_torch "
                "yet (see ROADMAP.md); use 'vectorized'"
            )
        if progress_bar:
            raise NotImplementedError("progress_bar is not ported to numpyro_tpu_torch yet")
        if not isinstance(thinning, int) or thinning < 1:
            raise ValueError("thinning must be a positive integer")
        self.sampler = sampler
        self._sample_field = sampler.sample_field
        self._default_fields = sampler.default_fields
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.thinning = thinning
        self.postprocess_fn = postprocess_fn
        self.chain_method = chain_method
        self._states = None
        self._states_flat = None
        self._last_state = None
        # wall clock and batched potential evaluations of the last run
        self.last_run_stats = {}

    @property
    def last_state(self):
        return self._last_state

    def run(self, rng_key, *args, extra_fields=(), init_params=None, **kwargs):
        """Run warmup + sampling and collect fields.  ``rng_key`` is a
        ``torch.Generator`` on the device the chains should run on."""
        if not isinstance(rng_key, torch.Generator):
            raise TypeError("rng_key must be a torch.Generator")
        # f32 matmuls must not round through TF32 (the counterpart of the JAX
        # driver's matmul_precision="highest": truncated products bias the
        # gradients enough to distort the posterior)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        collect_fields = tuple(
            set((self._sample_field,) + tuple(self._default_fields) + tuple(extra_fields))
        )
        collect_fields = (self._sample_field,) + tuple(
            sorted(f for f in collect_fields if f != self._sample_field)
        )
        unknown = set(collect_fields) - set(self.sampler.FUSED_FIELDS)
        if unknown:
            raise NotImplementedError(f"cannot collect {sorted(unknown)} in this port")
        fields, last_state = self.sampler.fused_run(
            rng_key,
            self.num_chains,
            self.num_warmup,
            self.num_samples,
            thinning=self.thinning,
            init_params=init_params,
            model_args=args,
            model_kwargs=kwargs,
            collect_fields=collect_fields,
        )
        postprocess_fn = (
            self.sampler.postprocess_fn(args, kwargs)
            if self.postprocess_fn is None
            else self.postprocess_fn
        )
        fields[self._sample_field] = postprocess_fn(fields[self._sample_field])
        self._last_state = last_state
        self._states = fields
        self._states_flat = {
            k: _flatten_chains(v) for k, v in fields.items()
        }
        stats = dict(self.sampler.last_fused_stats)
        stats["potential_evals"] = sum(
            v for k, v in stats.items() if k.startswith("potential_evals_")
        )
        stats["total_s"] = time.perf_counter() - t0
        self.last_run_stats = stats

    def get_samples(self, group_by_chain=False):
        """Posterior samples in constrained space."""
        states = self._states if group_by_chain else self._states_flat
        return states[self._sample_field]

    def get_extra_fields(self, group_by_chain=False):
        states = self._states if group_by_chain else self._states_flat
        return {k: v for k, v in states.items() if k != self._sample_field}


def _flatten_chains(x):
    if isinstance(x, dict):
        return {k: _flatten_chains(v) for k, v in x.items()}
    return x.reshape((-1,) + tuple(x.shape[2:]))
