"""The JAX package's own run of phase 18a's Dawid-Skene model
(``examples/annotation.py``) on the CPU, as the reference for the port's
(``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.annotation_reference [chains warmup samples \\
        warmup_depth sample_depth [keys...]]

Run from the root of the repo.  Samples ``examples/annotation.py``'s
``dawid_skene`` on the example's data (``chip_smoke.annotation_data``: 60
items, 5 annotators, 3 classes, numpy's RandomState(0)) with
``NUTS(max_tree_depth=(warmup_depth, sample_depth))`` and vectorized chains
(by default phase 18a's ``ANNOT_RUN``) for each key (0 to 4 by default),
and prints, per key, the largest |posterior mean of pi - the share of each
class among the items' true classes|.  Then the first key's error e_J, the
largest gap of another key's error to it, and the gate max(2 e_J, e_J +
0.05) of phase 18a.
"""

import os
import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from examples.annotation import dawid_skene  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS  # noqa: E402


def one_run(key, chains, warmup, samples, depths):
    true_c, annotations = cs.annotation_data()
    mcmc = MCMC(NUTS(dawid_skene, max_tree_depth=depths), num_warmup=warmup,
                num_samples=samples, num_chains=chains, chain_method="vectorized",
                progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(key), jnp.arange(cs.ANNOT_J), jnp.asarray(annotations), cs.ANNOT_K,
             cs.ANNOT_J)
    pi = np.asarray(mcmc.get_samples()["pi"], np.float64)
    shares = np.bincount(true_c, minlength=cs.ANNOT_K) / true_c.shape[0]
    e = float(np.abs(pi.mean(0) - shares).max())
    print(f"key {key}: {time.perf_counter() - t0:.1f} s, pi means "
          f"{np.round(pi.mean(0), 4).tolist()} against the shares {np.round(shares, 4).tolist()}, "
          f"largest error {e:.4f}", flush=True)
    return e


def main(argv):
    numbers = [int(a) for a in argv]
    chains, warmup, samples, dw, ds = numbers[:5] if len(numbers) >= 5 else (
        cs.ANNOT_RUN[:3] + cs.ANNOT_RUN[3])
    keys = numbers[5:] or [0, 1, 2, 3, 4]
    errors = [one_run(k, chains, warmup, samples, (dw, ds)) for k in keys]
    ref = errors[0]
    spread = max(abs(e - ref) for e in errors[1:]) if len(errors) > 1 else float("nan")
    print(f"annotation: {chains} chains, {warmup} + {samples}, depths ({dw}, {ds}): key "
          f"{keys[0]} e_J = {ref:.4f}, the others within {spread:.4f} of it, gate "
          f"max(2 e_J, e_J + 0.05) = {max(2 * ref, ref + 0.05):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
