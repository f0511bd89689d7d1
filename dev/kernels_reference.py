"""The JAX package's own runs of phase 12's legs (e) and (f), on the CPU, as
the reference for ``chip_smoke.KERNEL_GATES``.

    JAX_PLATFORMS=cpu python3 -m dev.kernels_reference [keys]

Run from the root of the repo.  For each PRNG key (0, 1 and 2 by default):
``BarkerMH``, ``SA``, ``AIES`` and ``ESS`` on ``examples/eight_schools.py``'s
model under ``handlers.reparam`` with ``LocScaleReparam(0)``, vectorized, at
``chip_smoke.KERNEL_RUNS``, and ``BarkerMH`` with ``chain_method=
"sequential"`` at ``chip_smoke.SEQ_RUN``.  Prints each run's means of ``mu``
and ``tau`` with their gaps to ``EIGHT_SCHOOLS_REF``, then the gates by the
rule of ``chip_smoke.HS_GATE``: max(2e, e + 0.05) per site for the largest
gap e over the keys.  Also runs the two mixtures of legs (c) and (d) at
``chip_smoke.GIBBS_RUN`` and ``MIXED_RUN`` and prints their moments against
the exact ones (those legs' gates are the JAX tests' own).
"""

import os
import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
from eight_schools import model, sigma, y  # noqa: E402

from chip_smoke import (  # noqa: E402
    EIGHT_SCHOOLS_REF, GIBBS_LOCS, GIBBS_PROBS, GIBBS_RUN, KERNEL_RUNS, MIXED_LOCS, MIXED_PROBS,
    MIXED_RUN, SEQ_RUN,
)
import numpyro_tpu  # noqa: E402
import numpyro_tpu.distributions as dist  # noqa: E402
from numpyro_tpu import handlers  # noqa: E402
from numpyro_tpu.infer import (  # noqa: E402
    AIES, ESS, HMC, MCMC, NUTS, SA, BarkerMH, DiscreteHMCGibbs, MixedHMC,
)
from numpyro_tpu.infer.reparam import LocScaleReparam  # noqa: E402

KERNELS = {"BarkerMH": BarkerMH, "SA": SA, "AIES": AIES, "ESS": ESS}


def gate(e):
    return round(max(2 * e, e + 0.05), 4)


def mixture(scale):
    def model(probs, locs):
        c = numpyro_tpu.sample("c", dist.Categorical(probs))
        numpyro_tpu.sample("x", dist.Normal(locs[c], scale))

    return model


def main(argv):
    keys = [int(a) for a in argv] or [0, 1, 2]
    model_nc = handlers.reparam(model, config={"theta": LocScaleReparam(0)})
    runs = {name: (KERNELS[name], cfg, "vectorized") for name, cfg in KERNEL_RUNS.items()}
    runs["sequential"] = (BarkerMH, SEQ_RUN, "sequential")
    gaps = {name: {"mu": [], "tau": []} for name in runs}
    for key in keys:
        for name, (cls, (chains, warmup, samples), method) in runs.items():
            t0 = time.perf_counter()
            mcmc = MCMC(cls(model_nc), num_warmup=warmup, num_samples=samples, num_chains=chains,
                        chain_method=method, progress_bar=False)
            mcmc.run(random.PRNGKey(key), y, sigma)
            z = mcmc.get_samples()
            means = {s: float(np.mean(z[s])) for s in ("mu", "tau")}
            for s in means:
                gaps[name][s].append(abs(means[s] - EIGHT_SCHOOLS_REF[s]["mean"]))
            print(f"key {key}: {name} {time.perf_counter() - t0:.1f} s, means "
                  f"{ {s: round(v, 4) for s, v in means.items()} }")
        for tag, make, cfg, probs, locs, scale in (
            ("c", lambda d: DiscreteHMCGibbs(NUTS(mixture(0.5), max_tree_depth=d)), GIBBS_RUN,
             GIBBS_PROBS, GIBBS_LOCS, 0.5),
            ("d", lambda d: MixedHMC(HMC(mixture(0.8), trajectory_length=1.2),
                                     num_discrete_updates=4), MIXED_RUN + (None,),
             MIXED_PROBS, MIXED_LOCS, 0.8),
        ):
            chains, warmup, samples, depth = cfg
            mcmc = MCMC(make(depth), num_warmup=warmup, num_samples=samples, num_chains=chains,
                        chain_method="vectorized", progress_bar=False)
            mcmc.run(random.PRNGKey(key), jnp.asarray(probs), jnp.asarray(locs))
            x = np.asarray(mcmc.get_samples()["x"])
            p, m = np.asarray(probs), np.asarray(locs)
            mean = float(p @ m)
            var = float(p @ (m - mean) ** 2) + scale**2
            print(f"key {key}: 12{tag} mean gap {abs(x.mean() - mean):.4f}, var gap "
                  f"{abs(x.var() - var):.4f}")
    print("KERNEL_GATES = {")
    for name, g in gaps.items():
        print(f"    {name!r}: { {s: gate(max(v)) for s, v in g.items()} },")
    print("}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
