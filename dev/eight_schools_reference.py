"""The JAX package's own run of 8-schools in its non-centred form, on the
CPU, as the reference for the port's phase 9 (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.eight_schools_reference [seed]

Run from the root of the repo.  Samples ``examples/eight_schools.py``'s model
under ``handlers.reparam`` with ``LocScaleReparam(0)`` and
``NUTS(target_accept_prob=0.9)``, vectorized chains, at the chains, lengths
and tree depths of ``chip_smoke.ES_RUN`` (PRNG key 0 by default), and prints the wall
time and, as a JSON object, the posterior mean and std of ``mu``, ``tau``
and ``theta`` with their Monte-Carlo standard errors
(``chip_smoke.mc_moments``): the value of ``chip_smoke.EIGHT_SCHOOLS_REF``.
"""

import json
import os
import sys
import time

import numpy as np

from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from eight_schools import model, sigma, y  # noqa: E402

from chip_smoke import ES_RUN, mc_moments  # noqa: E402
from numpyro_tpu import handlers  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS  # noqa: E402
from numpyro_tpu.infer.reparam import LocScaleReparam  # noqa: E402


def main(argv):
    seed = int(argv[0]) if argv else 0
    chains, warmup, samples, depth = ES_RUN
    model_nc = handlers.reparam(model, config={"theta": LocScaleReparam(0)})
    mcmc = MCMC(NUTS(model_nc, target_accept_prob=0.9, max_tree_depth=depth), num_warmup=warmup,
                num_samples=samples, num_chains=chains, chain_method="vectorized",
                progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(seed), y, sigma)
    wall = time.perf_counter() - t0
    z = mcmc.get_samples(group_by_chain=True)
    ref = {site: mc_moments(np.asarray(z[site])) for site in ("mu", "tau", "theta")}
    ref = {site: {k: np.round(v, 5).tolist() for k, v in m.items()} for site, m in ref.items()}
    print(f"{chains} chains, {warmup} + {samples}, max_tree_depth {depth}, key {seed}: "
          f"wall {wall:.1f} s")
    print(json.dumps(ref))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
