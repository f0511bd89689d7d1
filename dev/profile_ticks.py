"""Profile a window of NUTS ticks of the covtype model on one NVIDIA GPU.

    python3 -m dev.profile_ticks [mode] [chains]

Run from the root of the repo.  Runs the engine's tick (one leapfrog, that is one batched potential
evaluation, plus the tree bookkeeping) for 256 chains at the covtype shape
with a step size small enough that every tree runs to the depth cap, so that a
transition is a window of 2^6 = 64 warmup-style ticks.  One transition warms
up; the next is timed on the host's clock (ending in a synchronize) and traced
with ``torch.profiler``.  Prints host ms per tick, device ms per tick (the sum
of the kernels' own device time over the window), the device's idle share and
the kernels by device time.
"""

import sys
import time

import torch

import chip_smoke
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import (
    FlatLayout, GeneratorDraws, batched_potential, build_mass_blocks, init_mass,
    nuts_transition,
)
from numpyro_tpu_torch.ops import glm

MODES = {"split": "split", "bf16": torch.bfloat16, "f32": torch.float32}
DEPTH = 6


def main(argv):
    mode = argv[0] if argv else "split"
    chains = int(argv[1]) if len(argv) > 1 else chip_smoke.CHAINS
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi(), flush=True)
    X, y, true_w, _ = chip_smoke.make_data(dev)
    data = glm.prepare_glm_data(X, y, dtype=MODES[mode])
    gen = torch.Generator(device=dev).manual_seed(5)
    z = torch.from_numpy(true_w).to(dev) + 0.01 * torch.randn(
        (chains, chip_smoke.D), generator=gen, device=dev)
    layout = FlatLayout({"w": z[0]})
    pe_fn, _ = infer_util.get_potential_fn(chip_smoke.model, {}, model_args=(data,))
    pe_grad = batched_potential(pe_fn, layout)
    blocks = build_mass_blocks(layout, False)
    inv, sqrt, _ = init_mass(blocks, chains, z)
    step = torch.full((chains,), 1e-4, device=dev)
    draws = GeneratorDraws(gen)
    pe, grad = pe_grad(z)

    def transition():
        out = nuts_transition(pe_grad, blocks, draws, z, pe, grad, inv, sqrt, step, DEPTH)
        torch.cuda.synchronize()
        return out

    transition()
    glm.reset_launch_counts()
    t0 = time.perf_counter()
    out = transition()
    wall = time.perf_counter() - t0
    ticks = sum(v for k, v in glm.launch_counts.items() if k != "plain")
    print(f"untraced: {ticks} ticks in {wall * 1e3:.1f} ms = {wall * 1e3 / ticks:.3f} ms per "
          f"tick on the host's clock; leapfrogs per chain {out.num_steps.float().mean().item():.1f}",
          flush=True)

    glm.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        transition()
        wall = time.perf_counter() - t0
    ticks = sum(v for k, v in glm.launch_counts.items() if k != "plain")
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    device_ms = sum(by_name.values()) / 1e3
    print(f"traced: {ticks} ticks, wall {wall * 1e3 / ticks:.3f} ms per tick (with the "
          f"profiler's overhead), device {device_ms / ticks:.3f} ms per tick, device idle "
          f"share {1 - device_ms / (wall * 1e3):.3f} of the traced wall time", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3 / ticks:.4f} ms per tick  {name[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
