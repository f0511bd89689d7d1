"""The two goodness-of-fit tests on draws of a distribution on the torus.

    python3 -m dev.torus_gof [seeds [draws]]

Run from the root of the repo (CPU only).  For each seed (40 by default),
``draws`` (by default the smoke's 20,000) draws of ``chip_smoke.py``'s
``SineBivariateVonMises`` case, exact ones (rejection from the uniform,
``tests/torch_draws.py::exact_sine_bivariate_draws``) and the port's
(float32, a CPU generator, as 16c draws them on the card), go through the
port's nearest-neighbour test (``gof.auto_goodness_of_fit``, which measures
distances in the square, not on the torus) and through the torus test
(``gof.torus_goodness_of_fit``).
Prints each seed's p-values, then for each sampler and test how many seeds
read p at most ``chip_smoke.GOF_FAILURE_RATE`` and at most 0.05 (a test
that is calibrated reads about 0.5% and 5% of them), the median p, and the
reading at the smoke's own seed, 166.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import chip_smoke as cs  # noqa: E402
from torch_draws import exact_sine_bivariate_draws  # noqa: E402

import numpyro_tpu_torch.distributions as dist  # noqa: E402
from numpyro_tpu_torch.distributions import gof  # noqa: E402


def main(seeds, n):
    name, params = cs.GOF_CASES["SineBivariateVonMises"]
    d = dist.SineBivariateVonMises(**{k: torch.tensor(v, dtype=torch.float64)
                                      for k, v in params.items()})
    port = cs.new_family(name, params, torch.device("cpu"))
    readings = {}
    for seed in list(range(seeds)) + [166]:
        draws = {"exact": torch.from_numpy(exact_sine_bivariate_draws(params, n, seed)),
                 "port": port.sample(torch.Generator().manual_seed(seed), (n,))}
        row = {}
        for sampler, x in draws.items():
            x = x.double()
            row[f"{sampler}, nearest neighbour"] = gof.auto_goodness_of_fit(x, d.log_prob(x).exp())
            row[f"{sampler}, torus"] = gof.torus_goodness_of_fit(d, x)
        print(f"seed {seed}: " + ", ".join(f"{k} p {v:.4g}" for k, v in row.items()), flush=True)
        for k, v in row.items():
            readings.setdefault(k, []).append(v)
    for k, v in readings.items():
        p = np.array(v[:-1])
        print(f"{k}: {int((p <= cs.GOF_FAILURE_RATE).sum())} of {seeds} seeds at p <= "
              f"{cs.GOF_FAILURE_RATE}, {int((p <= 0.05).sum())} at p <= 0.05, median p "
              f"{np.median(p):.3f}; seed 166 p {v[-1]:.4g}")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(args[0] if args else 40, args[1] if len(args) > 1 else cs.GOF_DRAWS)
