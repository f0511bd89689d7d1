"""The JAX package's own runs of the HMM legs, on the CPU, as the reference
for the port's phase 11 (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.hmm_reference [seed]

Run from the root of the repo.  On ``chip_smoke.hmm_data()`` (T = 50, the
data of ``examples/hmm_enum.py`` from numpy seed 0) with that example's
models, at the configurations of ``chip_smoke`` (PRNG key 0 by default):

(a) ``NUTS`` on ``scan_model`` at ``HMM_RUN``, vectorized chains: e, the
    largest gap over trans[0, 0], trans[1, 1] and sigma between the
    posterior mean and the generating value;
(d) ``SVI`` with ``AutoNormal``, ``TraceEnum_ELBO`` and ``Adam`` at
    ``HMM_SVI`` on ``scan_model``: the same gap for the guide's medians;
(e) ``Predictive(model, (a)'s draws, infer_discrete=True)``: a, the share of
    steps whose most frequent decoded state is the generating one.

It prints the wall time of each leg and the gates that follow:
max(2e, e + 0.05) for (a) and (d), a - 0.05 for (e).
"""

import os
import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from hmm_enum import model, scan_model  # noqa: E402

from chip_smoke import HMM_RUN, HMM_SVI, HMM_TRUE, hmm_data  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS, SVI, Predictive, TraceEnum_ELBO  # noqa: E402
from numpyro_tpu.infer.autoguide import AutoNormal  # noqa: E402
from numpyro_tpu.optim import Adam  # noqa: E402


def gap(trans, sigma):
    got = [float(trans[0, 0]), float(trans[1, 1]), float(sigma)]
    return float(np.abs(np.subtract(got, HMM_TRUE)).max())


def main(argv):
    seed = int(argv[0]) if argv else 0
    ys_np, zs = hmm_data()
    ys = jnp.asarray(ys_np)

    chains, warmup, samples, depth = HMM_RUN
    mcmc = MCMC(NUTS(scan_model, max_tree_depth=depth), num_warmup=warmup,
                num_samples=samples, num_chains=chains, chain_method="vectorized",
                progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(seed), ys)
    wall = time.perf_counter() - t0
    flat = mcmc.get_samples()
    e = gap(np.asarray(flat["trans"]).mean(0), np.asarray(flat["sigma"]).mean())
    print(f"(a) scan_model, {chains} chains, {warmup} + {samples}, max_tree_depth {depth}, key "
          f"{seed}: wall {wall:.1f} s; e {e:.4f}; gate HMM_GATE {max(2 * e, e + 0.05):.4f}")

    lr, steps = HMM_SVI
    guide = AutoNormal(scan_model)
    svi = SVI(scan_model, guide, Adam(lr), TraceEnum_ELBO())
    t0 = time.perf_counter()
    res = svi.run(random.PRNGKey(seed), steps, ys, progress_bar=False)
    wall = time.perf_counter() - t0
    med = guide.median(res.params)
    e_svi = gap(np.asarray(med["trans"]), np.asarray(med["sigma"]))
    print(f"(d) AutoNormal, TraceEnum_ELBO, Adam({lr}), {steps} steps, key {seed}: wall "
          f"{wall:.1f} s; e {e_svi:.4f}; gate HMM_SVI_GATE {max(2 * e_svi, e_svi + 0.05):.4f}")

    t0 = time.perf_counter()
    pred = Predictive(model, flat, infer_discrete=True)(random.PRNGKey(seed + 1), ys)
    wall = time.perf_counter() - t0
    z = np.stack([np.asarray(pred[f"z_{t}"]) for t in range(len(zs))], -1)
    a = float(((z.mean(0) > 0.5).astype(int) == zs).mean())
    print(f"(e) Predictive(infer_discrete=True) of {z.shape[0]} draws, key {seed + 1}: wall "
          f"{wall:.1f} s; a {a:.4f}; gate HMM_DECODE_GATE {a - 0.05:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
