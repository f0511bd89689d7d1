"""The JAX package's own runs of ``examples/ucbadmit.py`` and
``examples/ssbvm_mixture.py``, on the CPU, as the references for the port's
phases 16a and 16b (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.discrete_reference ucb|ssbvm [chains warmup samples \
        warmup_depth sample_depth [keys...]]

Run from the root of the repo.  Samples the example's model on its data
(``ucbadmit``'s 12-row table; ``ssbvm_mixture``'s 200 angles from numpy's
``vonmises`` with seed 0, its label ``c`` enumerated) with
``NUTS(max_tree_depth=(warmup_depth, sample_depth))`` and vectorized chains
(by default phase 16's configuration) for each key (0 to 4 by default).
``ucb`` prints, per key, the posterior mean of ``bm`` and the example's
"mean |predicted - observed admit rate|" from ``Predictive`` on the draws
(key + 1); ``ssbvm`` the mean over draws of the sorted ``loc_phi`` of each
draw.  Then the first key's values and e, the largest gap of another key's
to them, and the gate max(2e, e + 0.05).
"""

import os
import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
import ssbvm_mixture  # noqa: E402
import ucbadmit  # noqa: E402

from numpyro_tpu.infer import MCMC, NUTS, Predictive  # noqa: E402

# phase 16's configurations: chains, warmup, samples, (warmup, sampling) depths
RUNS = {"ucb": (64, 30, 15, (3, 3)), "ssbvm": (256, 20, 10, (3, 3))}


def ucb_data():
    d = ucbadmit.DATA
    return (jnp.asarray(d[:, 0].astype(np.int32)), jnp.asarray(d[:, 1].astype(np.float32)),
            jnp.asarray(d[:, 2].astype(np.float32)), jnp.asarray(d[:, 3].astype(np.float32)))


def ssbvm_angles(n=200):
    rng = np.random.RandomState(0)
    half = n // 2
    a = np.stack([rng.vonmises(-2.0, 8, half), rng.vonmises(2.0, 8, half)], 1)
    b = np.stack([rng.vonmises(1.0, 8, half), rng.vonmises(-1.0, 8, half)], 1)
    return np.concatenate([a, b]).astype(np.float32)


def one_run(which, key, chains, warmup, samples, depths):
    model = ucbadmit.model if which == "ucb" else ssbvm_mixture.model
    args = ucb_data() if which == "ucb" else (jnp.asarray(ssbvm_angles()),)
    mcmc = MCMC(NUTS(model, max_tree_depth=depths), num_warmup=warmup, num_samples=samples,
                num_chains=chains, chain_method="vectorized", progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(key), *args)
    draws = mcmc.get_samples()
    if which == "ucb":
        dept, male, apps, admit = args
        pred = np.asarray(Predictive(model, draws)(random.PRNGKey(key + 1), dept, male,
                                                   apps)["admit"])
        gap = float(np.abs(pred.mean(0) / np.asarray(apps)
                           - np.asarray(admit) / np.asarray(apps)).mean())
        values = np.array([float(np.asarray(draws["bm"]).mean()), gap])
        label = "bm mean, mean |predicted - observed admit rate|"
    else:
        values = np.sort(np.asarray(draws["loc_phi"]), -1).mean(0)
        label = "sorted loc_phi means"
    print(f"key {key}: {time.perf_counter() - t0:.1f} s, {label} "
          f"{np.round(values, 4).tolist()}", flush=True)
    return values


def main(argv):
    which = argv[0] if argv else "ucb"
    numbers = [int(a) for a in argv[1:]]
    chains, warmup, samples, dw, ds = numbers[:5] if len(numbers) >= 5 else (
        RUNS[which][:3] + RUNS[which][3])
    keys = numbers[5:] or [0, 1, 2, 3, 4]
    runs = [one_run(which, k, chains, warmup, samples, (dw, ds)) for k in keys]
    ref = runs[0]
    e = max(float(np.abs(r - ref).max()) for r in runs[1:])
    print(f"{which}: {chains} chains, {warmup} + {samples}, depths ({dw}, {ds}): key {keys[0]} "
          f"{np.round(ref, 4).tolist()}, e = {e:.4f} over keys {keys[1:]}, gate "
          f"{max(2 * e, e + 0.05):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
