"""The JAX package's own run of the SKIM sparse regression, on the CPU, as
the reference for the port's phase 15a (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.skim_reference [chains warmup samples depth [keys...]]

Run from the root of the repo.  Samples ``examples/sparse_regression.py``'s
model on its data (N = 100, P = 20, S = 3, seed 0) and the hyperparameters of
its ``main``, with ``NUTS(max_tree_depth=depth)`` and vectorized chains (64,
30 + 10 at depth 3 by default, phase 15a's configuration), for each key (0,
1 and 2 by default).  For each key it prints the wall time, the divergent
share, the active dimensions by the example's 3-std rule and e, the largest
gap between the singleton means of the active dimensions and the generating
ones; then the largest e over the keys.
"""

import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from sparse_regression import get_data, model, singleton_stats  # noqa: E402

from numpyro_tpu.infer import MCMC, NUTS  # noqa: E402

HYPERS = {"expected_sparsity": 2.0, "alpha1": 3.0, "beta1": 1.0, "alpha2": 3.0, "beta2": 1.0,
          "alpha3": 1.0, "c": 1.0}


def one_run(key, chains, warmup, samples, depth):
    X, Y, expected = get_data(100, 20, 3)
    mcmc = MCMC(NUTS(model, max_tree_depth=depth), num_warmup=warmup, num_samples=samples,
                num_chains=chains, chain_method="vectorized", progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(key), X, Y, HYPERS, extra_fields=("diverging",))
    wall = time.perf_counter() - t0
    draws = mcmc.get_samples()
    mus, variances = jax.vmap(lambda s: singleton_stats(X, Y, HYPERS["c"], s))(draws)
    mean = jnp.mean(mus, 0)
    std = jnp.sqrt(jnp.mean(variances + mus**2, 0) - mean**2)
    active = np.where(np.abs(np.asarray(mean)) > 3 * np.asarray(std))[0].tolist()
    e = float(np.abs(np.asarray(mean)[:3] - np.asarray(expected)).max())
    divergent = float(np.asarray(mcmc.get_extra_fields()["diverging"]).mean())
    print(f"key {key}: {wall:.1f} s, divergent share in sampling {divergent:.4f}, active "
          f"dimensions {active}, singleton means {np.round(np.asarray(mean)[:3], 4).tolist()} "
          f"against {np.round(np.asarray(expected), 4).tolist()}, e = {e:.4f}", flush=True)
    return e


def main(argv):
    numbers = [int(a) for a in argv]
    chains, warmup, samples, depth = (numbers[:4] + [64, 30, 10, 3][len(numbers[:4]):])
    keys = numbers[4:] or [0, 1, 2]
    es = [one_run(k, chains, warmup, samples, depth) for k in keys]
    print(f"{chains} chains, {warmup} + {samples}, depth {depth}: largest e {max(es):.4f} "
          f"over keys {keys}")


if __name__ == "__main__":
    main(sys.argv[1:])
