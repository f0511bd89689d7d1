"""Ops and host time of one batched potential evaluation of each form of the
HMM of phase 11 (``chip_smoke.hmm_model`` and ``hmm_scan_model``).

    python3 -m dev.hmm_ops [cpu|cuda] [chains]

Run from the root of the repo.  For each form it builds the enumerated
potential through ``initialize_model`` at T = 50 on ``chip_smoke.hmm_data()``,
evaluates it once under ``vmap(grad_and_value)`` to warm up, counts the
top-level ATen ops of one evaluation (forward and backward) with
``torch.profiler``, and prints the median host milliseconds of 20 timed
evaluations (synchronized on the card).  The device is ``cuda`` by default,
64 chains by default.
"""

import statistics
import sys
import time

import torch

from chip_smoke import hmm_data, hmm_model, hmm_scan_model
from numpyro_tpu_torch.infer.util import (
    batched_value_and_grad,
    initialize_model,
    pin_full_f32_matmul,
)


def top_level_ops(fn):
    """The count of ATen ops that no other ATen op called, in one call."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(
        1 for e in prof.events()
        if e.name.startswith("aten::")
        and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))
    )


def main(argv):
    device = torch.device(argv[0] if argv else "cuda")
    chains = int(argv[1]) if len(argv) > 1 else 64
    pin_full_f32_matmul()
    ys = torch.from_numpy(hmm_data()[0]).to(device)
    for model in (hmm_scan_model, hmm_model):
        gen = torch.Generator(device=device).manual_seed(0)
        info = initialize_model(gen, model, num_chains=chains, model_args=(ys,))
        evaluate = batched_value_and_grad(info.potential_fn)
        z = info.param_info.z

        def once():
            value, _ = evaluate(z)
            if value.is_cuda:
                torch.cuda.synchronize()

        once()
        ops = top_level_ops(once)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            once()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{model.__name__}: {chains} chains on {device}: {ops} top-level ops an "
              f"evaluation, {statistics.median(times):.2f} ms (median of 20)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
