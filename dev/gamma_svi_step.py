"""One SVI step of a model whose guide draws a Gamma site per observation,
timed on the card: the cost of the gamma draw's reparameterised derivative in
a user's step.

    python3 dev/gamma_svi_step.py [--root DIR] [--label NAME]

Run from the root of the repo on a machine with a CUDA GPU.  ``--root``
names the tree whose ``numpyro_tpu_torch`` is imported (by default this
one), so that one call can time a parent commit beside the change.  The
model: ``tau ~ Gamma(2, 1)`` and ``y ~ Normal(0, tau^-1/2)`` for each of
``N`` observations; the guide: ``Gamma(conc, rate)`` per observation, both
parameters starting at ``a0``.  For ``N`` in (4,096, 1,000,000) and ``a0``
in (2, 5,000) it prints one JSON line each: the median ms of 20
``SVI.update`` steps after 5 (a CUDA sync after each step), the device
memory a step takes above its state at the peak, and the loss.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=ROOT)
    parser.add_argument("--label", default="change")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpyro_tpu_torch as npt
    import numpyro_tpu_torch.distributions as dist
    from numpyro_tpu_torch.infer import SVI, Trace_ELBO
    from numpyro_tpu_torch.optim import Adam

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this timing needs an NVIDIA GPU")

    def model(y, a0):
        with npt.plate("N", y.shape[0]):
            tau = npt.sample("tau", dist.Gamma(2.0, 1.0))
            npt.sample("y", dist.Normal(0.0, tau.rsqrt()), obs=y)

    def guide(y, a0):
        start = torch.full(y.shape, a0, device=y.device)
        conc = npt.param("conc", start, constraint=dist.constraints.positive)
        rate = npt.param("rate", start.clone(), constraint=dist.constraints.positive)
        with npt.plate("N", y.shape[0]):
            npt.sample("tau", dist.Gamma(conc, rate))

    for n in (4096, 1_000_000):
        y = torch.randn(n, generator=torch.Generator().manual_seed(0)).cuda()
        for a0 in (2.0, 5000.0):
            svi = SVI(model, guide, Adam(1e-3), Trace_ELBO())
            state = svi.init(0, y, a0)
            times = []
            for step in range(25):
                torch.cuda.synchronize()
                if step == 5:
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                state, loss = svi.update(state, y, a0)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() - base
            print(json.dumps({"tree": args.label, "N": n, "a0": a0,
                              "ms_per_step": statistics.median(times[5:]),
                              "step_peak_MiB": peak / 2**20, "loss": float(loss)}), flush=True)


if __name__ == "__main__":
    main()
