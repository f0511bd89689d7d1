"""Profile a window of NUTS ticks of the covtype model on one NVIDIA GPU.

    python3 -m dev.profile_ticks [mode] [chains]
    python3 -m dev.profile_ticks dense [chains]
    python3 -m dev.profile_ticks ecs [chains]

Run from the root of the repo.  Runs the engine's tick (one leapfrog, that is one batched potential
evaluation, plus the tree bookkeeping) for 256 chains at the covtype shape
with a step size small enough that every tree runs to the depth cap, so that a
transition is a window of 2^6 = 64 warmup-style ticks.  One transition warms
up; the next is timed on the host's clock (ending in a synchronize) and traced
with ``torch.profiler``.  Prints host ms per tick, device ms per tick (the sum
of the kernels' own device time over the window), the device's idle share and
the kernels by device time.

With ``dense`` the same window runs in split mode twice, under the diagonal
mass and then under a dense one that is the same for every chain (as pooled
adaptation leaves it), and both are printed.

With ``ecs`` the window is HMCECS transitions with the Taylor proxy (1,024
chains by default, the smoke run's configuration): after a few warmup
transitions, a few more are timed and then traced, and the same figures are
printed per batched potential evaluation.
"""

import sys
import time

import torch

import chip_smoke
from numpyro_tpu_torch.infer import HMCECS, NUTS
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import (
    FlatLayout, GeneratorDraws, batched_potential, build_mass_blocks, init_mass,
    nuts_transition,
)
from numpyro_tpu_torch.ops import glm

MODES = {"split": "split", "bf16": torch.bfloat16, "f32": torch.float32}
DEPTH = 6


def _traced(fn, count, unit):
    """Time ``fn`` untraced and under the profiler; ``count()`` is the number
    of ``unit``s done since its last call."""
    count()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    n = count()
    print(f"untraced: {n} {unit}s in {wall * 1e3:.1f} ms = {wall * 1e3 / n:.3f} ms per "
          f"{unit} on the host's clock", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_traced = time.perf_counter() - t0
    n = count()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    device_ms = sum(by_name.values()) / 1e3
    print(f"traced: {n} {unit}s, wall {wall_traced * 1e3 / n:.3f} ms per {unit} (with the "
          f"profiler's overhead), device {device_ms / n:.3f} ms per {unit} in "
          f"{len(events) / n:.0f} device operations, device idle share "
          f"{1 - device_ms / (wall_traced * 1e3):.3f} of the traced wall time and "
          f"{1 - device_ms / n / (wall * 1e3 / n):.3f} of the untraced", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3 / n:.4f} ms per {unit}  {name[:90]}", flush=True)


def profile_ecs(chains):
    dev = torch.device("cuda", 0)
    X, y, true_w, _ = chip_smoke.make_data(dev)
    kernel = HMCECS(
        NUTS(chip_smoke.model_ecs, max_tree_depth=(6, 10)),
        num_blocks=chip_smoke.NUM_BLOCKS,
        proxy=HMCECS.taylor_proxy({"w": true_w}),
    )
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    state = kernel.init(gen, 100, None, (X, y), {}, num_chains=chains)
    torch.cuda.synchronize()
    print(f"init {time.perf_counter() - t0:.2f} s, resolved {kernel.resolved_modes}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    box = {"state": state, "evals": infer_util.potential_evals}

    def steps(n=3):
        for _ in range(n):
            box["state"] = kernel.sample(box["state"], (X, y), {})
        torch.cuda.synchronize()

    def count():
        done = infer_util.potential_evals - box["evals"]
        box["evals"] = infer_util.potential_evals
        return done

    steps(5)
    _traced(steps, count, "evaluation")
    hs = box["state"].hmc_state
    print(f"after {hs.i} transitions: leapfrogs per chain in the last "
          f"{hs.num_steps.float().mean().item():.1f} (max {hs.num_steps.max().item()}), "
          f"block-accept {box['state'].accept_prob.mean().item():.3f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return 0


def profile_nuts(mode, chains, dense=False):
    dev = torch.device("cuda", 0)
    X, y, true_w, _ = chip_smoke.make_data(dev)
    data = glm.prepare_glm_data(X, y, dtype=MODES[mode])
    gen = torch.Generator(device=dev).manual_seed(5)
    z = torch.from_numpy(true_w).to(dev) + 0.01 * torch.randn(
        (chains, chip_smoke.D), generator=gen, device=dev)
    layout = FlatLayout({"w": z[0]})
    pe_fn, _ = infer_util.get_potential_fn(chip_smoke.model, {}, model_args=(data,))
    pe_grad = batched_potential(pe_fn, layout)
    blocks = build_mass_blocks(layout, dense)
    d = chip_smoke.D
    # one correlated positive definite matrix for every chain
    pooled = torch.eye(d) + 0.5 * torch.ones(d, d) / d if dense else None
    inv, sqrt, _ = init_mass(blocks, chains, z, init_inverse=pooled)
    step = torch.full((chains,), 1e-4, device=dev)
    draws = GeneratorDraws(gen)
    pe, grad = pe_grad(z)

    def transition():
        nuts_transition(pe_grad, blocks, draws, z, pe, grad, inv, sqrt, step, DEPTH)
        torch.cuda.synchronize()

    def ticks():
        done = sum(v for k, v in glm.launch_counts.items() if k != "plain")
        glm.reset_launch_counts()
        return done

    transition()
    _traced(transition, ticks, "tick")
    return 0


def main(argv):
    mode = argv[0] if argv else "split"
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi(), flush=True)
    if mode == "ecs":
        return profile_ecs(int(argv[1]) if len(argv) > 1 else chip_smoke.ECS_MAIN[0])
    chains = int(argv[1]) if len(argv) > 1 else chip_smoke.CHAINS
    if mode == "dense":
        for dense in (False, True):
            print(f"split mode, {chains} chains, {'dense' if dense else 'diagonal'} mass:",
                  flush=True)
            profile_nuts("split", chains, dense)
        return 0
    return profile_nuts(mode, chains)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
