"""Step the HMCECS leg of the smoke run transition by transition on one GPU.

    python3 -m dev.ecs_probe [chains] [warmup_depth,sampling_depth]

Run from the root of the repo.  Builds ``chip_smoke``'s HMCECS kernel with the
Taylor proxy (1,024 chains and the bench's ``max_tree_depth=(6, 10)`` by
default), then calls ``init`` and 100 + 100 times ``sample`` and prints, every
ten transitions, the seconds and potential evaluations they took, the mean and
the largest leapfrog count of the last one, the smallest and the median adapted
step size, the block-accept rate and the number of divergent chains: what one
transition costs while the loop waits for its deepest tree.  Ends with the
largest error of the posterior means.
"""

import sys
import time

import torch

import chip_smoke
from numpyro_tpu_torch.infer import HMCECS, NUTS
from numpyro_tpu_torch.infer import util as infer_util

WARMUP = SAMPLES = 100


def main(argv):
    chains = int(argv[0]) if argv else chip_smoke.ECS_MAIN[0]
    depth = tuple(int(d) for d in argv[1].split(",")) if len(argv) > 1 else (6, 10)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi(), flush=True)
    X, y, true_w, _ = chip_smoke.make_data(dev)
    kernel = HMCECS(
        NUTS(chip_smoke.model_ecs, max_tree_depth=depth),
        num_blocks=chip_smoke.NUM_BLOCKS,
        proxy=HMCECS.taylor_proxy({"w": true_w}),
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    t0, e0 = time.perf_counter(), infer_util.potential_evals
    state = kernel.init(gen, WARMUP, None, (X, y), {}, num_chains=chains)
    torch.cuda.synchronize()
    print(f"init {time.perf_counter() - t0:.1f} s, {infer_util.potential_evals - e0} "
          f"evaluations, resolved {kernel.resolved_modes}", flush=True)
    t0, e0 = time.perf_counter(), infer_util.potential_evals
    draws = []
    for i in range(WARMUP + SAMPLES):
        state = kernel.sample(state, (X, y), {})
        if i >= WARMUP:
            draws.append(state.hmc_state.z["w"])
        if i % 10 == 9:
            torch.cuda.synchronize()
            hs = state.hmc_state
            ss = hs.adapt_state.step_size
            print(f"transitions {i - 8}-{i + 1}: {time.perf_counter() - t0:.1f} s, "
                  f"{infer_util.potential_evals - e0} evaluations; leapfrogs of the last: mean "
                  f"{hs.num_steps.float().mean().item():.1f}, max {hs.num_steps.max().item()}; "
                  f"step size min {ss.min().item():.4f}, median {ss.median().item():.4f}; "
                  f"block-accept {state.accept_prob.mean().item():.3f}; "
                  f"divergent {int(hs.diverging.sum())}", flush=True)
            t0, e0 = time.perf_counter(), infer_util.potential_evals
    w = torch.stack(draws, 1)
    err = (w.mean((0, 1)).cpu() - torch.from_numpy(true_w)).abs().max().item()
    print(f"max |mean(w) - true_w| {err:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
