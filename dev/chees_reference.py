"""The JAX package's own ``CheesHMC`` run of phase 13a, on the CPU, as the
reference for ``chip_smoke.CHEES_GATE``.

    JAX_PLATFORMS=cpu python3 -m dev.chees_reference [rows_fraction] [keys]

Run from the root of the repo.  Builds the covtype-shape data of
``chip_smoke.make_data`` (581,012 x 55 with the intercept, numpy seed 0; a
fraction of the rows with ``rows_fraction``, 1 by default), the model of
``bench.py:125-127`` in split mode (``prepare_glm_data(..., "split")`` and
``bernoulli_logits_loglik``, whose CPU path is plain XLA), and runs
``CheesHMC`` at ``chip_smoke.CHEES_RUN`` (256 vectorized chains, 100 + 20,
at most 16 leapfrog steps) for each PRNG key (0 by default).  Prints each
run's seconds, step size, trajectory length, pooled accept and e = max
|posterior mean - generating coefficient|, and the gate: the bench's 0.05
where every e is under it, else max(2e, e + 0.05) for the largest e.  One
evaluation at the full size holds (256, 589,824) float32 arrays: the process
peaks near 2.1 GB and a run takes about 4 minutes on 8 CPU cores (key 0:
243.5 s, step size 0.00891, trajectory length 0.10858, pooled accept 0.7735,
e = 0.0082).
"""

import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import CHEES_RUN, D  # noqa: E402
import numpyro_tpu  # noqa: E402
import numpyro_tpu.distributions as dist  # noqa: E402
from numpyro_tpu.infer import MCMC, CheesHMC  # noqa: E402
from numpyro_tpu.ops.glm import bernoulli_logits_loglik, prepare_glm_data  # noqa: E402


def make_data(n):
    """``chip_smoke.make_data``'s numpy draws, cut to the first ``n`` rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((581_012, D - 1), dtype=np.float32)
    true_w = (0.5 * rng.standard_normal(D)).astype(np.float32)
    X = np.concatenate([x, np.ones((581_012, 1), np.float32)], axis=1)
    p = 1.0 / (1.0 + np.exp(-(X @ true_w)))
    y = (rng.random(581_012) < p).astype(np.float32)
    return X[:n], y[:n], true_w


def model(data):
    w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(D), 1.0).to_event(1))
    numpyro_tpu.factor("lik", bernoulli_logits_loglik(w, data))


def main(argv):
    frac = float(argv[0]) if argv else 1.0
    keys = [int(a) for a in argv[1:]] or [0]
    X, y, true_w = make_data(int(round(581_012 * frac)))
    data = prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype="split")
    chains, warmup, samples, max_steps, step_size, traj = CHEES_RUN
    errs = []
    for key in keys:
        mcmc = MCMC(
            CheesHMC(model, step_size=step_size, trajectory_length=traj, max_num_steps=max_steps),
            num_warmup=warmup, num_samples=samples, num_chains=chains,
            chain_method="vectorized", progress_bar=False,
        )
        t0 = time.perf_counter()
        mcmc.run(random.PRNGKey(key), data, extra_fields=("accept_prob",))
        w = np.asarray(mcmc.get_samples()["w"])
        wall = time.perf_counter() - t0
        err = float(np.abs(w.mean(0) - true_w).max())
        errs.append(err)
        adapt = mcmc.last_state.adapt_state
        accept = float(np.asarray(mcmc.get_extra_fields()["accept_prob"]).mean())
        print(f"key {key}: {X.shape[0]} rows, {chains} chains, {warmup} + {samples}: {wall:.1f} s; "
              f"step size {float(adapt.step_size):.5f}, trajectory length "
              f"{float(adapt.trajectory_length):.5f}, pooled accept {accept:.4f}; "
              f"e = {err:.4f}", flush=True)
    e = max(errs)
    gate = 0.05 if e < 0.05 else round(max(2 * e, e + 0.05), 4)
    print(f"largest e {e:.4f}: CHEES_GATE = {gate}")


if __name__ == "__main__":
    jax.config.update("jax_default_matmul_precision", "highest")
    main(sys.argv[1:])
