"""Phase 21 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase21 [cpu] [--sizing]

Run from the root of the repo.  On a machine with a CUDA GPU it builds the
kernels, makes the covtype-shape data, runs a short split-mode NUTS leg of
phase 4 (20 + 10 transitions, for the posterior std beside 21a's
particles), then phase 21's legs with their gates, printing each leg's
seconds.  With ``cpu`` it rehearses them on the CPU: 21a at a tenth of the
rows (58,101; the plain version's calls counted in the kernel's place, no
NUTS leg, so no std ratio), 21b and 21c as they are, where 21c holds the
CPU against itself, which checks the code, not the card.  ``--sizing``
opens 21b's gate and runs the phase twice, cold then warm.  Exits non-zero
where a leg fails.
"""

import functools
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from numpyro_tpu_torch.ops import glm  # noqa: E402


def main(argv):
    cpu = "cpu" in argv
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run with `cpu` to rehearse on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--sizing" in argv:
        cs.STEIN_BNN_GATE = None
    if cpu:
        device = torch.device("cpu")
        torch.set_num_threads(min(4, os.cpu_count() or 1))
        cs.N = cs.N // 10
        for name in ("SVGD", "SteinVI", "MixtureGuidePredictive"):
            setattr(cs, name, functools.partial(getattr(cs, name), device=device))
    else:
        device = torch.device("cuda", 0)
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
        cs._cuda.load()
    X, y, true_w, _ = cs.make_data(device)
    if cpu:
        posterior = {"std": torch.full((cs.D,), float("nan"))}
    else:
        glm.reset_launch_counts()
        posterior = cs.phase_main(X, y, true_w, "glm_split", run=(20, 10, (5, 10), None),
                                  tag="probe")["posterior"]
    kernels = {"glm_split": {}}
    for _ in range(2 if "--sizing" in argv else 1):
        t0 = time.perf_counter()
        walls, ms, syncs, launches = cs.phase_twenty_one(X, y, true_w, posterior, kernels)
        cs.log(f"[stein] phase 21 alone: {time.perf_counter() - t0:.1f} s ("
               + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
               + f"; ms per step {ms}; host syncs in a step {syncs}; 21a launches {launches})")


if __name__ == "__main__":
    main(sys.argv[1:])
