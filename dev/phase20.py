"""Phase 20 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase20 [cpu] [--sizing]

Run from the root of the repo.  On a machine with a CUDA GPU it runs phase
20's legs with their checks on the card, printing each leg's seconds; with
``cpu`` it rehearses them on the CPU at about a tenth of the work of the
NUTS and potential legs (32 points in place of 256, 8 chains in place of
32; the nested and the DCC/SDVI legs as they are), where the potential
checks hold the CPU against itself, which checks the code, not the card.
``--sizing`` opens 20a's gate against the JAX package's run and runs the
phase twice, cold then warm (to size the legs before new reference
constants).  Exits non-zero where a leg fails.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main(argv):
    cpu = "cpu" in argv
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run with `cpu` to rehearse on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--sizing" in argv:
        cs.HSGP_REF = {k: {"mean": 0.0, "se_mean": float("inf")} for k in cs.HSGP_REF}
    if cpu:
        device = torch.device("cpu")
        cs.HSGP_POINTS, cs.SS_POINTS = 32, 8
        cs.HSGP_RUN = (8,) + cs.HSGP_RUN[1:]
    else:
        device = torch.device("cuda", 0)
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
    for _ in range(2 if "--sizing" in argv else 1):
        t0 = time.perf_counter()
        walls, ms_a, ms_c, syncs = cs.phase_twenty(device)
        cs.log(f"[contrib] phase 20 alone: {time.perf_counter() - t0:.1f} s ("
               + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
               + f"; 20a {ms_a:.2f} ms per evaluation, nested runs' ms per evaluation "
               + ", ".join(f"{k} {v:.2f}" for k, v in ms_c.items())
               + f"; host syncs per evaluation {syncs})")


if __name__ == "__main__":
    main(sys.argv[1:])
