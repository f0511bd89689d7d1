"""The JAX package's own ``AutoSemiDAIS`` runs on the model of
``tests/infer/test_autoguide_extra.py::test_auto_semi_dais``, on the CPU, as
the reference for the port's phase 15b (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.semi_dais_reference [steps [draws]]

Run from the root of the repo.  Prints the test's data (16 values from
``random.PRNGKey(0)``, which phase 15b takes as they are), then for keys 0-4
an SVI run of ``AutoSemiDAIS(K=3)`` with a global ``AutoNormal`` started at
theta = 0 (``init_to_value``, so that runs differ only in their noise),
``Adam(5e-3)`` and ``Trace_ELBO()`` for ``steps`` steps (70 by default): the
test's criterion (finite losses, the last 50 below the first 3) and the mean
of theta over ``draws`` draws of ``sample_posterior`` (1,000 by default).
Last, the gate max(2e, e + 0.05) for e the largest gap of keys 1-4 to key 0.
"""

import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as dist
from numpyro_tpu.infer import SVI, Trace_ELBO
from numpyro_tpu.infer.autoguide import AutoNormal, AutoSemiDAIS
from numpyro_tpu.infer.initialization import init_to_value
from numpyro_tpu.optim import Adam

N, S = 16, 8


def main(argv):
    steps = int(argv[0]) if argv else 70
    draws = int(argv[1]) if len(argv) > 1 else 1000
    data = 1.5 + 0.5 * random.normal(random.PRNGKey(0), (N,))
    print("data:", np.asarray(data).tolist())

    def global_model():
        return numpyro_tpu.sample("theta", dist.Normal(0, 3))

    def local_model(theta):
        with numpyro_tpu.plate("data", N, subsample_size=S):
            tau = numpyro_tpu.sample("tau", dist.Gamma(5.0, 5.0))
            batch = numpyro_tpu.subsample(data, event_dim=0)
            numpyro_tpu.sample("obs", dist.Normal(theta, 1 / jnp.sqrt(tau)), obs=batch)

    def model():
        return local_model(global_model())

    means = []
    for key in range(5):
        start = init_to_value(values={"theta": 0.0})
        guide = AutoSemiDAIS(model, local_model, AutoNormal(global_model, init_loc_fn=start),
                             K=3)
        t0 = time.perf_counter()
        res = SVI(model, guide, Adam(5e-3), Trace_ELBO()).run(random.PRNGKey(key), steps,
                                                             progress_bar=False)
        losses = np.asarray(res.losses)
        ok = bool(np.isfinite(losses[-50:]).all() and losses[-50:].mean() < losses[:3].mean())
        theta = guide.sample_posterior(random.PRNGKey(100 + key), res.params,
                                       sample_shape=(draws,))["theta"]
        means.append(float(np.mean(np.asarray(theta))))
        print(f"key {key}: {time.perf_counter() - t0:.1f} s, losses {losses[:3].mean():.3f} -> "
              f"{losses[-50:].mean():.3f}, criterion {ok}, mean of theta {means[-1]:.4f}",
              flush=True)
    e = max(abs(m - means[0]) for m in means[1:])
    print(f"{steps} steps: reference (key 0) {means[0]:.4f}, e = {e:.4f}, gate "
          f"max(2e, e + 0.05) = {max(2 * e, e + 0.05):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
