"""Are ``chip_smoke.py`` 14a's losses finite on every seed, and the same
bits on a repeat?

    python3 -m dev.iaf_finite [cpu|cuda] [rows] [seeds] [repeats]

Run from the root of the repo.  Fits ``AutoIAFNormal`` (3 flows, hidden
widths [55, 55], ELU) to the covtype-shape data of ``chip_smoke.make_data``
at ``rows`` rows (581,012 by default) in split mode with 14a's particles,
steps and ``Adam(0.01)``, for SVI seeds ``0..seeds-1`` (4 by default; 14a's
own seed, 8, is always added), each ``repeats`` times (2 by default) in one
process.  Each run prints its first and last losses, a checksum of all its
losses (equal checksums on a repeat: the run is deterministic) and the first
step whose loss is not finite.  At such a step it evaluates the loss from
the state before it on the same draws through the kernel and through the
plain version, and prints the largest entry of each parameter, so that a
fault of the kernel is told from one of the flow.  On the CPU the kernel's
place is taken by the plain version.  Exits non-zero if any loss is not
finite or a repeat differs.
"""

import functools
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from numpyro_tpu_torch.infer import SVI, Trace_ELBO, autoguide  # noqa: E402
from numpyro_tpu_torch.ops import glm  # noqa: E402
from numpyro_tpu_torch.optim import Adam  # noqa: E402
from numpyro_tpu_torch.util import tree_leaves  # noqa: E402


def fit(data, device, seed):
    particles, steps = cs.IAF_RUN
    guide = autoguide.AutoIAFNormal(cs.model, num_flows=3, hidden_dims=[cs.D, cs.D])
    svi = SVI(cs.model, guide, Adam(0.01), Trace_ELBO(num_particles=particles), device=device)
    state = svi.init(seed, data)
    losses = []
    for step in range(steps):
        before = state.rng_key.get_state()
        new_state, loss = svi.update(state, data)
        if not torch.isfinite(loss):
            params = svi.get_params(state)
            again = {}
            for name, loglik in (("the kernel", glm.bernoulli_logits_loglik),
                                 ("the plain version", glm.plain_bernoulli_logits_loglik)):
                state.rng_key.set_state(before)
                again[name] = svi.loss.loss(state.rng_key, params, functools.partial(
                    cs.model, loglik=loglik), guide, data).item()
            largest = {k: max(v.abs().max().item() for v in tree_leaves(p) if v is not None)
                       for k, p in params.items()}
            print(f"  step {step}: loss {loss.item()}; from the state before it on the same "
                  f"draws, through {again}; largest entry of each param {largest}", flush=True)
            return torch.stack(losses).cpu(), step
        losses.append(loss)
        state = new_state
    return torch.stack(losses).cpu(), None


def main(argv):
    device = torch.device(argv[0] if argv else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: this run needs an NVIDIA GPU")
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
        cs._cuda.load()
    cs.N = int(argv[1]) if len(argv) > 1 else cs.N
    seeds = sorted(set(range(int(argv[2]) if len(argv) > 2 else 4)) | {8})
    repeats = int(argv[3]) if len(argv) > 3 else 2
    X, y, _, _ = cs.make_data(device)
    data = glm.prepare_glm_data(X, y, dtype="split")
    bad = []
    for seed in seeds:
        sums = []
        for rep in range(repeats):
            t0 = time.perf_counter()
            losses, first_bad = fit(data, device, seed)
            sums.append(losses.double().sum().item())
            cs.log(f"[iaf] N {cs.N}, seed {seed}, repeat {rep}: {len(losses)} finite steps in "
                   f"{time.perf_counter() - t0:.1f} s; loss {losses[:50].mean().item():.2f} -> "
                   f"{losses[-50:].mean().item():.2f}; checksum {sums[-1]!r}; first step not "
                   f"finite: {first_bad}")
            if first_bad is not None:
                bad.append((seed, rep, first_bad))
        if len(set(sums)) > 1:
            bad.append((seed, "repeats differ", sums))
    cs.log(f"[iaf] {len(seeds) * repeats} runs; faults: {bad or 'none'}")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
