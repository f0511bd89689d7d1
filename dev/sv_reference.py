"""The JAX package's own run of stochastic volatility, on the CPU, as the
reference for the port's phase 10 (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.sv_reference [seed]

Run from the root of the repo.  Samples ``examples/stochastic_volatility.py``'s
model on ``chip_smoke.sv_data()`` (T = 100, returns made in numpy from seed
0) with ``NUTS(max_tree_depth=depths, pooled_adaptation=True)``, vectorized
chains, at the chains, lengths and depths of ``chip_smoke.SV_RUN`` (PRNG key
0 by default), and prints the wall time, the largest gap over t between the
posterior mean of ``s`` and the generating log volatility (e), the split
R-hat of ``sigma`` (r), and the gates that follow from them:
max(2e, e + 0.05) and 1 + max(2 (r - 1), r - 1 + 0.05).
"""

import os
import sys
import time

import numpy as np

from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from stochastic_volatility import model  # noqa: E402

from chip_smoke import SV_RUN, sv_data  # noqa: E402
from numpyro_tpu.diagnostics import split_gelman_rubin  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS  # noqa: E402


def main(argv):
    seed = int(argv[0]) if argv else 0
    chains, warmup, samples, depth = SV_RUN
    returns, log_vol = sv_data()
    mcmc = MCMC(NUTS(model, max_tree_depth=depth, pooled_adaptation=True),
                num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method="vectorized", progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(seed), returns, extra_fields=("num_steps",))
    wall = time.perf_counter() - t0
    z = mcmc.get_samples(group_by_chain=True)
    steps = np.asarray(mcmc.get_extra_fields()["num_steps"])
    e = np.abs(np.asarray(z["s"], np.float64).mean((0, 1)) - log_vol).max()
    r = float(np.asarray(split_gelman_rubin(z["sigma"])))
    print(f"T = {len(returns)}, {chains} chains, {warmup} + {samples}, max_tree_depth {depth}, "
          f"pooled, key {seed}: wall {wall:.1f} s; leapfrogs per draw mean {steps.mean():.1f}, "
          f"max {steps.max()}; e = max |mean(s) - log vol| {e:.4f}; R-hat of sigma {r:.4f}; "
          f"gates SV_GATE {max(2 * e, e + 0.05):.4f}, "
          f"SV_RHAT_GATE {1 + max(2 * (r - 1), r - 1 + 0.05):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
