"""How often does ``chip_smoke.py`` 14d's ``AutoDAIS`` fit leave its
annealing idle?

    python3 -m dev.dais_spread [cpu|cuda] [first] [last] [particles]
    python3 -m dev.dais_spread compare PORT_IDLE PORT_RUNS JAX_IDLE JAX_RUNS

Run from the root of the repo.  Fits the port's ``AutoDAIS(K=4,
eta_init=0.01)`` to ``examples/dais_demo.py``'s model at
``chip_smoke.DAIS_DEMO``'s steps, step size and draws, started at w = 0,
with ``particles`` particles (``DAIS_DEMO``'s by default), once for each SVI
seed in ``first..last-1`` (0..39 by default), and prints each run's posterior
mean, sd and correlation and its learned ``eta_coeff``.  A run whose
correlation stays above -0.3 has kept its step size clipped near 0: its fit
is a mean-field one (sd about 0.15, correlation about 0).  The last line
gives the share of such runs; ``JAX_PLATFORMS=cpu python3 -m
dev.flows_reference dais_spread:8 KEYS`` gives the JAX package's.
``compare`` tests two such counts against each other: the two-sided
p-values of Fisher's exact test and of the two-proportion z test.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from numpyro_tpu_torch.infer import SVI, Trace_ELBO, autoguide, init_to_value  # noqa: E402
from numpyro_tpu_torch.optim import Adam  # noqa: E402

IDLE_CORRELATION = -0.3


def compare(port_idle, port_runs, jax_idle, jax_runs):
    from scipy import stats

    table = [[port_idle, port_runs - port_idle], [jax_idle, jax_runs - jax_idle]]
    fisher = stats.fisher_exact(table).pvalue
    p1, p2 = port_idle / port_runs, jax_idle / jax_runs
    pooled = (port_idle + jax_idle) / (port_runs + jax_runs)
    z = (p1 - p2) / (pooled * (1 - pooled) * (1 / port_runs + 1 / jax_runs)) ** 0.5
    print(f"dais_spread compare: port {port_idle} of {port_runs} idle ({p1:.4f}), JAX package "
          f"{jax_idle} of {jax_runs} ({p2:.4f}); Fisher's exact p = {fisher:.4f}; "
          f"two-proportion z = {z:.3f}, p = {2 * stats.norm.sf(abs(z)):.4f}")


def main(argv):
    if argv and argv[0] == "compare":
        return compare(*(int(a) for a in argv[1:5]))
    device = torch.device(argv[0] if argv else "cpu")
    first = int(argv[1]) if len(argv) > 1 else 0
    last = int(argv[2]) if len(argv) > 2 else 40
    n, steps, lr, particles, draws = cs.DAIS_DEMO
    particles = int(argv[3]) if len(argv) > 3 else particles
    X, y = cs.dais_demo_data(n, device)
    idle = []
    for seed in range(first, last):
        start = init_to_value(values={"w": torch.zeros(2, device=device)})
        guide = autoguide.AutoDAIS(cs.dais_demo_model, K=4, eta_init=0.01, init_loc_fn=start)
        t0 = time.perf_counter()
        res = SVI(cs.dais_demo_model, guide, Adam(lr), Trace_ELBO(num_particles=particles),
                  device=device).run(seed, steps, X, y)
        w = guide.sample_posterior(torch.Generator(device=device).manual_seed(144 + seed),
                                   res.params, sample_shape=(draws,))["w"].double()
        corr = torch.corrcoef(w.T)[0, 1].item()
        if corr > IDLE_CORRELATION:
            idle.append(seed)
        print(f"seed {seed}: {time.perf_counter() - t0:.2f} s; mean "
              f"{[round(v, 4) for v in w.mean(0).tolist()]}, sd "
              f"{[round(v, 4) for v in w.std(0).tolist()]}, correlation {corr:.3f}, eta_coeff "
              f"{res.params['auto_eta_coeff'].item():.4f}", flush=True)
    print(f"dais_spread (port, {device.type}): {particles} particles, seeds {first}-{last - 1}: "
          f"{len(idle)} of {last - first} runs idle (correlation > {IDLE_CORRELATION}): {idle}",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
