"""The JAX package's own fits of phase 13c and 13d, on the CPU, as the
reference for ``chip_smoke.LOWRANK_GATE``, ``LAPLACE_MAP``, ``LAPLACE_STD``
and ``LAPLACE_GATE``.

    JAX_PLATFORMS=cpu python3 -m dev.guides_reference [keys]

Run from the root of the repo (about 15 s).  On ``examples/eight_schools.py``'s
model under ``handlers.reparam`` with ``LocScaleReparam(0)``:

- (c) for each PRNG key (0, 1 and 2 by default), ``AutoLowRankMultivariateNormal``
  with ``Trace_ELBO`` and ``Adam`` at ``chip_smoke.ES_SVI``'s step size and
  steps; prints the guide's medians of ``mu`` and ``tau`` and their gaps to
  ``EIGHT_SCHOOLS_REF``'s means, then ``LOWRANK_GATE``: max(2e, e + 0.05)
  per site for the largest gap e over the keys.
- (d) ``AutoLaplaceApproximation`` from ``chip_smoke.LAPLACE_START`` fitted by
  ``Minimize()`` (BFGS) in one ``SVI`` step, in float32 and again in float64;
  prints the MAP (the packed unconstrained latent) and the Laplace standard
  deviations of the float32 fit, and ``LAPLACE_GATE``: max(2e, e + 0.05) for
  the largest gap e between the two fits.
"""

import os
import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
from eight_schools import model, sigma, y  # noqa: E402

from chip_smoke import EIGHT_SCHOOLS_REF, ES_SVI, LAPLACE_START  # noqa: E402
from numpyro_tpu import handlers, optim  # noqa: E402
from numpyro_tpu.infer import SVI, Trace_ELBO, init_to_value  # noqa: E402
from numpyro_tpu.infer.autoguide import (  # noqa: E402
    AutoLaplaceApproximation, AutoLowRankMultivariateNormal,
)
from numpyro_tpu.infer.reparam import LocScaleReparam  # noqa: E402


def gate(e):
    return round(max(2 * e, e + 0.05), 4)


def laplace(model_nc):
    start = {k: jnp.full((8,) if k == "theta_decentered" else (), v)
             for k, v in LAPLACE_START.items()}
    guide = AutoLaplaceApproximation(model_nc, init_loc_fn=init_to_value(values=start))
    res = SVI(model_nc, guide, optim.Minimize(), Trace_ELBO()).run(
        random.PRNGKey(0), 1, y, sigma, progress_bar=False)
    cov = np.asarray(guide.get_posterior(res.params).covariance_matrix)
    return np.asarray(res.params["auto_loc"], np.float64), np.sqrt(np.diag(cov)).astype(np.float64)


def main(argv):
    keys = [int(a) for a in argv] or [0, 1, 2]
    model_nc = handlers.reparam(model, config={"theta": LocScaleReparam(0)})
    lr, steps, _ = ES_SVI
    gaps = {"mu": [], "tau": []}
    for key in keys:
        guide = AutoLowRankMultivariateNormal(model_nc)
        res = SVI(model_nc, guide, optim.Adam(lr), Trace_ELBO()).run(
            random.PRNGKey(key), steps, y, sigma, progress_bar=False)
        med = guide.median(res.params)
        for k in gaps:
            gaps[k].append(abs(float(med[k]) - EIGHT_SCHOOLS_REF[k]["mean"]))
        print(f"(c) key {key}: medians mu {float(med['mu']):.4f}, tau {float(med['tau']):.4f}; "
              f"gaps {gaps['mu'][-1]:.4f}, {gaps['tau'][-1]:.4f}")
    print(f"LOWRANK_GATE = {({k: gate(max(v)) for k, v in gaps.items()})}")

    loc32, std32 = laplace(model_nc)
    jax.config.update("jax_enable_x64", True)
    loc64, std64 = laplace(model_nc)
    e = max(np.abs(loc32 - loc64).max(), np.abs(std32 - std64).max())
    print(f"(d) LAPLACE_MAP = {tuple(np.round(loc32, 4).tolist())}")
    print(f"(d) LAPLACE_STD = {tuple(np.round(std32, 4).tolist())}")
    print(f"(d) largest gap between the float32 and float64 fits {e:.2e}: "
          f"LAPLACE_GATE = {gate(e)}")


if __name__ == "__main__":
    main(sys.argv[1:])
