"""The JAX package's own runs of phase 21's legs on the CPU, as the
references of the port's (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.stein_reference covtype [particles steps step_size \\
        [keys...]]
    JAX_PLATFORMS=cpu python3 -m dev.stein_reference bnn [steps draws [keys...]]

Run from the root of the repo.

- ``covtype``: ``SVGD`` with ``RBFKernel()`` and ``Adagrad(step_size)`` on
  the covtype model in split mode at full size (``chip_smoke.make_data``:
  581,012 x 55 with the intercept), by default at phase 21a's
  ``STEIN_COVTYPE``, for each key (0 by default).  Per key: the largest
  |particle mean - generating coefficient|, the particles' per-coefficient
  standard deviation (median, least, largest) and the run's seconds.  About
  2 GB and a few minutes a key.
- ``bnn``: ``examples/stein_bnn.py``'s ``SteinVI`` (8 particles, 2 ELBO
  draws, ``AutoNormal``, ``Adagrad(0.5)``, ``RBFKernel()``) on the example's
  data for ``steps`` (phase 21b's ``STEIN_BNN``), then
  ``MixtureGuidePredictive`` with ``draws`` samples of ``y``: the RMSE of
  the predictive mean against ``0.5 sin(4x)``, for each key (0 to 4 by
  default), then the gate ``max(2e, e + 0.05)`` of the first key's ``e``.
"""

import os
import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import numpyro_tpu  # noqa: E402
import numpyro_tpu.distributions as jdist  # noqa: E402
from examples.stein_bnn import model as bnn_model  # noqa: E402
from numpyro_tpu.contrib.einstein import (  # noqa: E402
    SVGD, MixtureGuidePredictive, RBFKernel, SteinVI,
)
from numpyro_tpu.infer.autoguide import AutoNormal  # noqa: E402
from numpyro_tpu.ops import glm  # noqa: E402
from numpyro_tpu.optim import Adagrad  # noqa: E402


def covtype_model(data):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(data.d), 1.0).to_event(1))
    numpyro_tpu.factor("lik", glm.bernoulli_logits_loglik(w, data))


def covtype(argv):
    particles, steps, step_size = cs.STEIN_COVTYPE
    if len(argv) >= 3:
        particles, steps, step_size = int(argv[0]), int(argv[1]), float(argv[2])
        argv = argv[3:]
    keys = [int(k) for k in argv] or [0]
    X, y, true_w, _ = cs.make_data("cpu")
    data = glm.prepare_glm_data(jnp.asarray(X.numpy()), jnp.asarray(y.numpy()), dtype="split")
    del X, y
    for key in keys:
        t0 = time.perf_counter()
        svgd = SVGD(covtype_model, Adagrad(step_size), RBFKernel(),
                    num_stein_particles=particles)
        res = svgd.run(random.PRNGKey(key), steps, data)
        w = np.asarray(res.params["auto_w_loc"])
        err = np.abs(w.mean(0) - true_w).max()
        std = w.std(0)
        losses = np.asarray(res.losses)
        print(f"key {key}: {particles} particles, {steps} steps of Adagrad({step_size}): "
              f"max |mean - true_w| {err:.4f}; per-coefficient std median "
              f"{np.median(std):.5f}, min {std.min():.5f}, max {std.max():.5f}; loss "
              f"{losses[0]:.1f} -> {losses[-1]:.1f}; {time.perf_counter() - t0:.1f} s",
              flush=True)


def bnn(argv):
    steps, draws = cs.STEIN_BNN[0], cs.STEIN_BNN[1]
    if len(argv) >= 2:
        steps, draws = int(argv[0]), int(argv[1])
        argv = argv[2:]
    keys = [int(k) for k in argv] or list(range(5))
    x, y = cs.stein_bnn_data()
    x, y = jnp.asarray(x), jnp.asarray(y)
    truth = 0.5 * np.sin(4 * np.asarray(x)[:, 0])
    errs = []
    for key in keys:
        t0 = time.perf_counter()
        guide = AutoNormal(bnn_model)
        stein = SteinVI(bnn_model, guide, Adagrad(0.5), RBFKernel(),
                        num_stein_particles=cs.STEIN_BNN_PARTICLES, num_elbo_particles=2)
        res = stein.run(random.PRNGKey(key), steps, x, y)
        pred = MixtureGuidePredictive(bnn_model, guide, res.params, set(res.params),
                                      num_samples=draws)(random.PRNGKey(key + 1000), x)
        rmse = float(np.sqrt(np.mean((np.asarray(pred["y"]).mean(0) - truth) ** 2)))
        losses = np.asarray(res.losses)
        errs.append(rmse)
        print(f"key {key}: {steps} steps, loss {losses[0]:.1f} -> {losses[-1]:.1f}; "
              f"predictive mean RMSE {rmse:.4f} ({draws} draws); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    e = errs[0]
    print(f"RMSE over keys: {np.round(errs, 4).tolist()}; gate max(2e, e + 0.05) for the "
          f"first key: {max(2 * e, e + 0.05):.4f}")


def main(argv):
    if not argv or argv[0] not in ("covtype", "bnn"):
        raise SystemExit(__doc__)
    {"covtype": covtype, "bnn": bnn}[argv[0]](argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
