"""The JAX package's own SVI fit of the horseshoe regression, on the CPU, as
the reference for the port's phase 8e (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.svi_horseshoe_reference [steps [particles]] [seeds]

Run from the root of the repo.  Fits ``examples/horseshoe_regression.py``'s
model on its default data (100 x 20, 3 active) with ``AutoNormal``,
``TraceMeanField_ELBO(num_particles)`` and ``Adam(0.01)`` (3,000 steps and
8 particles by default, phase 8e's configuration), and prints the wall
time, the mean of the first and last 100 losses and e = max |median of beta
- beta_true|, from which phase 8e's gate is max(2e, e + 0.05).  With
``seeds`` it repeats the fit from five seeds and prints e of each.
"""

import os
import sys
import time

import numpy as np

from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from horseshoe_regression import make_data, model  # noqa: E402

from numpyro_tpu.infer import SVI, TraceMeanField_ELBO  # noqa: E402
from numpyro_tpu.infer.autoguide import AutoNormal  # noqa: E402
from numpyro_tpu.optim import Adam  # noqa: E402


def fit(X, y, beta_true, steps, particles, seed):
    guide = AutoNormal(model)
    svi = SVI(model, guide, Adam(0.01), TraceMeanField_ELBO(num_particles=particles))
    t0 = time.perf_counter()
    res = svi.run(random.PRNGKey(seed), steps, X, y)
    losses = np.asarray(res.losses)
    wall = time.perf_counter() - t0
    err = np.abs(np.asarray(guide.median(res.params)["beta"]) - beta_true).max()
    return err, wall, losses


def main(argv):
    many = "seeds" in argv
    numbers = [int(a) for a in argv if a != "seeds"]
    steps, particles = numbers + [3000, 8][len(numbers):]
    X, y, beta_true = make_data(100, 20, 3)
    for seed in range(5) if many else (0,):
        err, wall, losses = fit(X, y, beta_true, steps, particles, seed)
        print(f"seed {seed}: {steps} steps, {particles} particles: wall {wall:.1f} s; "
              f"loss mean of the first 100 {losses[:100].mean():.2f}, of the last 100 "
              f"{losses[-100:].mean():.2f}; max |median(beta) - beta_true| {err:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
