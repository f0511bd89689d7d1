"""Build the GLM kernels and hold each mode against its plain PyTorch version
at a few shapes on one NVIDIA GPU; print errors, determinism and times.

    python3 -m dev.kernel_check [modes] [--sass] [--f64]

Run from the root of the repo.  ``modes`` is a comma-separated subset of
split,bf16,f32 (default: all).  ``--sass`` also counts the tensor-core
instructions in the built library with ``cuobjdump -sass``.  ``--f64`` also
holds kernel and plain version each against a float64 reference at the
covtype shape.  The comparison and its tolerances are ``chip_smoke.py``'s; the
covtype shape is checked on the smoke run's data and on two more seeds, so
that no tolerance is fitted to one dataset.  Every shape is run; the exit code
is non-zero if any disagreed.
"""

import sys

import numpy as np
import torch

import chip_smoke
from numpyro_tpu_torch.ops import _cuda, glm

MODES = {"split": "split", "bf16": torch.bfloat16, "f32": torch.float32}
COVTYPE = (chip_smoke.N, chip_smoke.D, chip_smoke.CHAINS)
# (n, d, chains, seed): small, ragged (two d-blocks, a partial chain tile), one
# warpgroup pair splitting the columns, several chain tiles, four d-blocks;
# then the covtype shape: seed None is the smoke run's own data
SHAPES = [(5000, 7, 5, 0), (70000, 70, 100, 0), (40000, 9, 33, 0), (70000, 55, 300, 0),
          (33000, 200, 70, 0), (*COVTYPE, None), (*COVTYPE, 1), (*COVTYPE, 2)]


def problem(n, d, c, device, seed):
    if seed is None:
        X, y, _, W = chip_smoke.make_data(device)
        return X, y, W
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    true_w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ true_w))).astype(np.float32)
    W = (true_w + 0.05 * rng.standard_normal((c, d))).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(X), to(y), to(W)


def back_to_back_ms(fn, reps=10):
    """Mean milliseconds of ``reps`` calls between two CUDA events."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def f64_value_and_grad(w, data, chunk=32):
    """The function of ``plain_value_and_grad`` with float64 products and sums
    (the same bf16 pieces of ``w`` and the residual, which are part of the
    function), a few chains at a time."""
    d_pad, n_pad = data.x_t.shape
    x = data.x_t.to(torch.float64)
    y = data.y_row.to(torch.float64)

    def pieces(v, k):  # the sum of the first k bf16 pieces of f32 v, in f64
        if k == 3:
            return sum(p.to(torch.float64) for p in glm.split_hi_mid_lo(v))
        hi, lo = glm.split_hi_lo(v)
        return hi.to(torch.float64) + (lo.to(torch.float64) if k == 2 else 0)

    k = {"bf16": 1, "split": 2, "f32": 3}[data.mode]
    lls, grads = [], []
    for w_c in w.split(chunk):
        w_pad = torch.zeros((w_c.shape[0], d_pad), dtype=torch.float32, device=w.device)
        w_pad[:, :data.d] = w_c
        w64 = w_pad.to(torch.float64) if k == 3 else pieces(w_pad, k)
        logits = w64 @ x
        e = torch.exp(-logits.abs())
        nll = (logits.clamp(min=0) + torch.log1p(e) - y * logits).sum(-1)
        r = torch.where(logits >= 0, 1.0, e) / (1.0 + e) - y
        r64 = r if k == 3 else pieces(r.to(torch.float32), k)
        lls.append(-(nll - (n_pad - data.n) * np.log(2.0)))
        grads.append(-(r64 @ x.T)[:, :data.d])
    return torch.cat(lls), torch.cat(grads)


def against_f64(w, data):
    """Readings of kernel and plain version against the float64 reference."""
    _, g_ref = f64_value_and_grad(w, data)
    out = []
    for what, fn in (("kernel", glm.glm_value_and_grad), ("plain", glm.plain_value_and_grad)):
        err = fn(w, data)[1].to(torch.float64) - g_ref
        needed = (err.abs() - chip_smoke.G_RTOL * g_ref.abs()).max().item()
        out.append(f"{what} vs f64: max abs {err.abs().max().item():.3e}, mean signed "
                   f"{(err * g_ref.sign()).mean().item():+.2e}, atol needed {needed:.3e}")
    return "; ".join(out)


def main(argv):
    modes = [a for a in argv if not a.startswith("--")]
    modes = modes[0].split(",") if modes else list(MODES)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi(), flush=True)
    _cuda.load()
    print(f"built in {_cuda.build_info['seconds']:.1f} s", flush=True)
    for line in _cuda.ptxas_summary():
        print(line, flush=True)
    if "--sass" in argv:
        import subprocess

        sass = subprocess.run(["cuobjdump", "-sass", _cuda.build_info["path"]],
                              capture_output=True, text=True).stdout
        print({op: sass.count(op) for op in ("HGMMA", "HMMA", "UTMALDG", "FFMA")}, flush=True)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    bad = 0
    for n, d, c, seed in SHAPES:
        X, y, W = problem(n, d, c, dev, seed)
        for mode in modes:
            data = glm.prepare_glm_data(X, y, dtype=MODES[mode])
            got = chip_smoke.compare(W, data)
            ll_rtol, _, atol = glm.kernel_tolerances(data.mode, n)
            ok = (got["finite"] and got["same_bits"] and got["ll_rel"] <= ll_rtol
                  and got["atol_needed"] <= atol)
            t = back_to_back_ms(lambda: glm.glm_value_and_grad(W, data))
            plan = glm.glm_launch_plan(data.mode, c, *data.x_t.shape, sm_count)
            print(f"{'ok ' if ok else 'BAD'} {mode:5s} n={n} d={d} c={c} seed={seed}: "
                  f"ll rel {got['ll_rel']:.2e}, g abs {got['g_abs']:.3e} (max |g| "
                  f"{got['g_max']:.3e}), atol needed {got['atol_needed']:.3e} of {atol:.3e} "
                  f"({got['atol_needed'] / n ** 0.5:.2e} sqrt(n)), same bits {got['same_bits']}, "
                  f"{t:.3f} ms, {plan}", flush=True)
            if "--f64" in argv and (n, d, c) == COVTYPE:
                print("    " + against_f64(W, data), flush=True)
            bad += not ok
            del data
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
