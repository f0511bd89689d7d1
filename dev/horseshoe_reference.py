"""The JAX package's own run of the horseshoe regression, on the CPU, as the
reference for the port's phase 7 (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.horseshoe_reference [chains warmup samples [depth]] [pooled]

Run from the root of the repo.  Samples ``examples/horseshoe_regression.py``'s
model on its default data (100 x 20, 3 active) with ``NUTS(dense_mass=True,
max_tree_depth=(depth, 10))``, vectorized chains (256, 200 + 200 and a warmup
depth of 6 by default), and
prints the wall time, the leapfrogs per draw, max |posterior mean of beta -
beta_true| and the largest split R-hat of beta.  With ``pooled`` the mass
matrix is estimated from all chains together (``pooled_adaptation=True``).
"""

import os
import sys
import time

import numpy as np

from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from horseshoe_regression import make_data, model  # noqa: E402

from numpyro_tpu.diagnostics import split_gelman_rubin  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS  # noqa: E402


def main(argv):
    pooled = "pooled" in argv
    numbers = [int(a) for a in argv if a != "pooled"]
    chains, warmup, samples, depth = (numbers + [256, 200, 200, 6][len(numbers):])
    X, y, beta_true = make_data(100, 20, 3)
    mcmc = MCMC(
        NUTS(model, dense_mass=True, max_tree_depth=(depth, 10), pooled_adaptation=pooled),
        num_warmup=warmup, num_samples=samples, num_chains=chains,
        chain_method="vectorized", progress_bar=False,
    )
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(0), X, y, extra_fields=("num_steps",))
    wall = time.perf_counter() - t0
    steps = np.asarray(mcmc.get_extra_fields()["num_steps"])
    beta = np.asarray(mcmc.get_samples(group_by_chain=True)["beta"])
    err = np.abs(beta.mean((0, 1)) - beta_true).max()
    rhat = np.asarray(split_gelman_rubin(beta)).max()
    print(f"{chains} chains, {warmup} + {samples}, max_tree_depth ({depth}, 10), pooled {pooled}: "
          f"wall {wall:.1f} s; "
          f"leapfrogs per draw mean {steps.mean():.1f}, max {steps.max()}; "
          f"max |mean(beta) - beta_true| {err:.4f}; split R-hat of beta max {rhat:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
