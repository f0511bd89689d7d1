"""Phase 22 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase22 [cpu [rows]] [--twice]

Run from the root of the repo.  On a machine with a CUDA GPU it builds the
kernels, makes the covtype data at full size, runs phase 4's per-step leg
(which saves its ``post_warmup_state`` to a checkpoint) and then phase 22's
legs with their checks, printing each leg's seconds; ``--twice`` runs phase
22 a second time, warm.  With ``cpu`` it rehearses them on the CPU with
``rows`` rows of the data (5,000 by default): the GLM op's plain version
stands for ``glm_split``, and 22b and 22c hold the CPU against itself, which
checks the code, not the card.  Exits non-zero where a leg fails.
"""

import functools
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main(argv):
    cpu = bool(argv) and argv[0] == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run with `cpu` to rehearse on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cpu:
        rows = [a for a in argv[1:] if not a.startswith("--")]
        cs.N = int(rows[0]) if rows else 5_000
        device = torch.device("cpu")
        cs.MCMC = functools.partial(cs.MCMC, device="cpu")
        cs.SVI = functools.partial(cs.SVI, device="cpu")
        # the plain version stands for the kernel: count its calls as launches
        counts = cs.glm.launch_counts
        real_plain = cs.glm.plain_value_and_grad

        def plain(w, data):
            counts["glm_split"] += 1
            counts["plain"] -= 1
            return real_plain(w, data)

        cs.glm.glm_value_and_grad = lambda w, data: plain(w, data)
    else:
        device = torch.device("cuda", 0)
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
        cs._cuda.load()
    X, y, _, _ = cs.make_data(device)
    with tempfile.TemporaryDirectory(prefix="phase22_") as tmp:
        t0 = time.perf_counter()
        resume = cs.phase_per_step(X, y, os.path.join(tmp, "per_step_warm.pt"))
        cs.log(f"[main] per-step leg: {time.perf_counter() - t0:.1f} s")
        for _ in range(2 if "--twice" in argv else 1):
            t0 = time.perf_counter()
            walls, ms, syncs, launches = cs.phase_twenty_two(device, resume)
            cs.log(f"[port tail] phase 22 alone: {time.perf_counter() - t0:.1f} s ("
                   + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
                   + f"; ms per step {ms}; host syncs in a 22b step {syncs}; 22a launches "
                   f"{launches})")


if __name__ == "__main__":
    main(sys.argv[1:])
