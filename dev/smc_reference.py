"""The JAX package's own SMC runs of phase 12's legs (a) and (b), on the CPU,
as the reference for ``chip_smoke.SMC_GATE`` and ``SMC_EVIDENCE``.

    JAX_PLATFORMS=cpu python3 -m dev.smc_reference [keys]

Run from the root of the repo.  For each PRNG key (0, 1 and 2 by default):
``SMC`` on ``examples/eight_schools.py``'s model under ``handlers.reparam``
with ``LocScaleReparam(0)``, ``chip_smoke.SMC_RUN`` particles and the
defaults otherwise, and on the conjugate Gaussian of
``tests/infer/test_smc.py`` with ``chip_smoke.SMC_GAUSS``.  Prints each run's
wall time, stages, means of ``mu`` and ``tau`` with their gaps to
``EIGHT_SCHOOLS_REF`` and log evidence, then the gates by the rule of
``chip_smoke.HS_GATE``: max(2e, e + 0.05) per site for the largest gap e over
the keys, and max(2d, d + 0.05) around key 0's log evidence for the spread d.
"""

import os
import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from eight_schools import model, sigma, y  # noqa: E402

from chip_smoke import EIGHT_SCHOOLS_REF, SMC_GAUSS, SMC_RUN, gauss_log_evidence  # noqa: E402
import numpyro_tpu  # noqa: E402
import numpyro_tpu.distributions as dist  # noqa: E402
from numpyro_tpu import handlers  # noqa: E402
from numpyro_tpu.infer import SMC  # noqa: E402
from numpyro_tpu.infer.reparam import LocScaleReparam  # noqa: E402

GAUSS_Y = (0.5, 1.5, 1.0, 0.8, 1.2)


def gauss_model(y):
    mu = numpyro_tpu.sample("mu", dist.Normal(0.0, 1.0))
    with numpyro_tpu.plate("N", y.shape[0]):
        numpyro_tpu.sample("y", dist.Normal(mu, 1.0), obs=y)


def gate(e):
    return round(max(2 * e, e + 0.05), 4)


def main(argv):
    keys = [int(a) for a in argv] or [0, 1, 2]
    model_nc = handlers.reparam(model, config={"theta": LocScaleReparam(0)})
    gaps, evidences = {"mu": [], "tau": []}, []
    for key in keys:
        t0 = time.perf_counter()
        res = SMC(model_nc, num_particles=SMC_RUN).run(random.PRNGKey(key), y, sigma)
        wall = time.perf_counter() - t0
        means = {s: float(np.mean(res.samples[s])) for s in ("mu", "tau")}
        for s in means:
            gaps[s].append(abs(means[s] - EIGHT_SCHOOLS_REF[s]["mean"]))
        evidences.append(res.log_evidence)
        particles, steps = SMC_GAUSS
        g = SMC(gauss_model, num_particles=particles, num_mcmc_steps=steps).run(
            random.PRNGKey(key), jnp.asarray(GAUSS_Y))
        print(f"key {key}: 8-schools {wall:.1f} s, {len(res.betas) - 1} stages, means "
              f"{ {s: round(v, 4) for s, v in means.items()} }, log evidence "
              f"{res.log_evidence:.4f}; Gaussian log evidence {g.log_evidence:.4f} (exact "
              f"{gauss_log_evidence(GAUSS_Y):.4f})")
    d = max(evidences) - min(evidences)
    print(f"SMC_GATE = { {s: gate(max(v)) for s, v in gaps.items()} }")
    print(f"SMC_EVIDENCE = ({evidences[0]:.4f}, {gate(d)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
