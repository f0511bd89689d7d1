"""End-to-end smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints on its own lines; any failure exits non-zero):

1. device   -- require CUDA; print the card's name and power limit.
2. build    -- compile the hand-written CUDA kernels from numpyro_tpu_torch/csrc.
3. kernels  -- at the covtype shape (581,012 x 55 with the intercept, 256
               chains) run each GLM kernel and its plain PyTorch version on
               the same inputs; print errors and median times (CUDA events).
4. main     -- with every launch count set to 0: MCMC(NUTS) with 256
               vectorized chains on the covtype model in each precision mode.
               Split mode (the bench's) runs 200 + 200 transitions, f32 mode
               (``prepare_glm_data``'s default) 100 + 100, and both must
               recover the generating coefficients to 0.05.  bf16 mode runs a
               short depth-6 chain whose draws must be finite (its quantized
               ``w`` stalls NUTS at this data concentration, so it has no
               coefficient gate).  Every potential evaluation of every run
               must have launched its mode's kernel exactly once.
5. f32/bf16 -- one batched potential-and-gradient evaluation of the f32- and
               bf16-mode models through ``batched_potential``, checked
               against the plain version.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.diagnostics import effective_sample_size
from numpyro_tpu_torch.infer import MCMC, NUTS
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import FlatLayout, batched_potential
from numpyro_tpu_torch.ops import _cuda, glm

N, D, CHAINS = 581_012, 55, 256
# tolerances of kernel against plain version: the two add the same exact
# (or f32-FMA) products in another order (per-block f32 partials reduced in
# f64, against cuBLAS's f32 accumulation), so they differ by summation
# rounding only: ~1e-7 relative on the potential, and on the gradient, whose
# components are sums of 581k signed terms, far less than rtol 1e-3
LL_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-3, 1e-3
KERNELS = {
    # launch-count name: (mode, TPU kernel it replaces)
    "glm_split": ("split", "numpyro_tpu/ops/glm.py:264"),
    "glm_fused_f32": (torch.float32, "numpyro_tpu/ops/glm.py:370"),
    "glm_fused_bf16": (torch.bfloat16, "numpyro_tpu/ops/glm.py:370"),
}
# main-path runs: kernel -> (warmup, samples, max_tree_depth, coefficient gate)
RUNS = {
    "glm_split": (200, 200, (6, 10), 0.05),
    "glm_fused_f32": (100, 100, (6, 10), 0.05),
    "glm_fused_bf16": (20, 20, 6, None),
}


def log(msg):
    print(msg, flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(device):
    """Synthetic covtype-shape data, as bench.py builds it, all in numpy."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D - 1), dtype=np.float32)
    true_w = (0.5 * rng.standard_normal(D)).astype(np.float32)
    X = np.concatenate([x, np.ones((N, 1), np.float32)], axis=1)
    p = 1.0 / (1.0 + np.exp(-(X @ true_w)))
    y = (rng.random(N) < p).astype(np.float32)
    w_chains = (true_w + 0.1 * rng.standard_normal((CHAINS, D))).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(X), to(y), true_w, to(w_chains)


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_kernels(X, y, w_chains):
    results = {}
    for name, (mode, replaces) in KERNELS.items():
        data = glm.prepare_glm_data(X, y, dtype=mode)
        ll_k, g_k = glm.glm_value_and_grad(w_chains, data)
        ll_p, g_p = glm.plain_value_and_grad(w_chains, data)
        torch.cuda.synchronize()
        ll_rel = ((ll_k - ll_p).abs() / ll_p.abs()).max().item()
        g_abs = (g_k - g_p).abs().max().item()
        ok = (
            torch.isfinite(ll_k).all().item()
            and torch.isfinite(g_k).all().item()
            and ll_rel <= LL_RTOL
            and torch.allclose(g_k, g_p, rtol=G_RTOL, atol=G_ATOL)
        )
        ms = cuda_ms(lambda: glm.glm_value_and_grad(w_chains, data))
        plain_ms = cuda_ms(lambda: glm.plain_value_and_grad(w_chains, data))
        log(
            f"[kernels] {name}: loglik max rel err {ll_rel:.3e} (rtol {LL_RTOL}), "
            f"grad max abs err {g_abs:.3e} (rtol {G_RTOL}, atol {G_ATOL}); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms at C={CHAINS}, "
            f"D_pad={data.x_t.shape[0]}, N_pad={data.x_t.shape[1]}"
        )
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version")
        results[name] = {
            "name": name,
            "route": "cuda",
            "source": "numpyro_tpu_torch/csrc/glm.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": g_abs,
            "loglik_max_rel_err": ll_rel,
            "ms": ms,
            "plain_ms": plain_ms,
        }
        del data
    torch.cuda.empty_cache()
    return results


def model(data):
    w = npt.sample(
        "w", dist.Normal(torch.zeros(D, device=data.device), 1.0).to_event(1)
    )
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


def phase_main(X, y, true_w, name):
    """One MCMC(NUTS) run in the mode of kernel ``name``; returns its stats."""
    warmup, samples, depth, gate = RUNS[name]
    data = glm.prepare_glm_data(X, y, dtype=KERNELS[name][0])
    mcmc = MCMC(
        NUTS(model, max_tree_depth=depth),
        num_warmup=warmup,
        num_samples=samples,
        num_chains=CHAINS,
        chain_method="vectorized",
    )
    before = glm.launch_counts[name]
    mcmc.run(torch.Generator(device=X.device).manual_seed(1), data,
             extra_fields=("num_steps",))
    stats = mcmc.last_run_stats
    launches = glm.launch_counts[name] - before
    draws = mcmc.get_samples(group_by_chain=True)["w"]
    if draws.shape != (CHAINS, samples, D) or not torch.isfinite(draws).all():
        raise SystemExit(f"{name}: bad draws, shape {tuple(draws.shape)}")
    w_err = (draws.mean((0, 1)).cpu() - torch.from_numpy(true_w)).abs().max().item()
    ess = effective_sample_size(draws)
    leapfrogs = int(mcmc.get_extra_fields()["num_steps"].sum().item())
    log(
        f"[main] {name}: {warmup} + {samples} transitions, max_tree_depth {depth}; "
        f"warmup {stats['warmup_s']:.2f} s, sampling {stats['sample_s']:.2f} s, "
        f"init {stats['init_s']:.2f} s; potential evaluations {stats['potential_evals']} "
        f"(warmup {stats['potential_evals_warmup']}, sampling "
        f"{stats['potential_evals_sample']}) + {stats['init_traces']} init trace; "
        f"{name} launches {launches}; "
        f"leapfrogs counted in draws {leapfrogs}; ESS median "
        f"{ess.median().item():.1f} (min {ess.min().item():.1f}); "
        f"max |mean(w) - true_w| {w_err:.4f}"
    )
    # one launch per batched potential evaluation, plus the one unbatched
    # model trace with which initialization finds the latent sites
    if launches != stats["potential_evals"] + stats["init_traces"]:
        raise SystemExit(
            f"{name} launched {launches} times for {stats['potential_evals']} "
            f"potential evaluations and {stats['init_traces']} init trace(s)"
        )
    if gate is not None and not w_err < gate:
        raise SystemExit(f"{name}: posterior means off by {w_err:.4f} (>= {gate})")
    return stats


def phase_fused(X, y):
    """One batched potential evaluation per fused-kernel mode, held against
    the plain version (these launches are not the main path's)."""
    gen = torch.Generator(device=X.device).manual_seed(3)
    z = {"w": 0.1 * torch.randn((CHAINS, D), generator=gen, device=X.device)}
    layout = FlatLayout({"w": z["w"][0]})
    for name, mode in (("glm_fused_f32", torch.float32), ("glm_fused_bf16", torch.bfloat16)):
        data = glm.prepare_glm_data(X, y, dtype=mode)
        pe_fn, _ = infer_util.get_potential_fn(model, {}, model_args=(data,))
        pe_grad = batched_potential(pe_fn, layout)
        before = dict(glm.launch_counts)
        pe, grad = pe_grad(layout.ravel_batch(z))
        torch.cuda.synchronize()
        launched = glm.launch_counts[name] - before[name]
        ll_p, g_p = glm.plain_value_and_grad(z["w"], data)
        prior = dist.Normal(torch.zeros(D, device=X.device), 1.0).to_event(1)
        pe_ref = -(ll_p + prior.log_prob(z["w"]))
        g_ref = -(g_p - z["w"])
        pe_rel = ((pe - pe_ref).abs() / pe_ref.abs()).max().item()
        log(
            f"[fused] {name}: one batched evaluation launched it {launched} "
            f"time(s); potential max rel err vs plain {pe_rel:.3e}"
        )
        if launched != 1 or pe_rel > LL_RTOL:
            raise SystemExit(f"{name} model path failed")
        # a gradient component sums 581k signed terms: two f32 summation
        # orders leave ~1e-7 of the largest component on every component, so
        # near-zero components get an atol scaled by it (5e-7 of it measured
        # on an H100)
        g_atol = 2e-6 * g_ref.abs().max().item()
        g_err = (grad - g_ref).abs().max().item()
        log(f"[fused] {name}: model gradient max abs err {g_err:.3e} "
            f"(rtol {G_RTOL}, atol {g_atol:.3e})")
        if not torch.allclose(grad, g_ref, rtol=G_RTOL, atol=g_atol):
            raise SystemExit(f"{name} model gradient disagrees with the plain version")
        del data


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this smoke run needs an NVIDIA GPU")
    card = smi()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    device = torch.device("cuda", 0)
    # full-f32 matmuls in the plain versions (the counterpart of the JAX
    # driver's matmul_precision="highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_cuda.build_info['path']})")
    for line in _cuda.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    X, y, true_w, w_chains = make_data(device)
    kernels = phase_kernels(X, y, w_chains)

    glm.reset_launch_counts()
    stats = {name: phase_main(X, y, true_w, name) for name in RUNS}
    counts = dict(glm.launch_counts)

    split = stats["glm_split"]
    split_ms = kernels["glm_split"]["ms"]
    share = split["potential_evals_sample"] * split_ms / 1e3 / split["sample_s"]
    share_all = split["potential_evals"] * split_ms / 1e3 / (
        split["warmup_s"] + split["sample_s"])
    log(f"[main] split kernel share of wall time: sampling {share:.3f}, "
        f"warmup+sampling {share_all:.3f} (launches x {split_ms:.3f} ms)")
    phase_fused(X, y)

    for name, entry in kernels.items():
        entry["launches"] = counts[name]
        if counts[name] == 0:
            raise SystemExit(f"{name} was never launched on the main path")
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
