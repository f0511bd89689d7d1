"""Phase 15 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase15 [cpu]

Run from the root of the repo.  On a machine with a CUDA GPU it runs phase
15's legs with their gates on the card and prints each leg's seconds; with
``cpu`` it rehearses them on the CPU (the device checks of 15c are left out
there).  Exits non-zero where a leg fails.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    cpu = sys.argv[1:] == ["cpu"]
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run with `cpu` to rehearse on the CPU")
    device = torch.device("cpu" if cpu else "cuda")
    if not cpu:
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    walls = cs.phase_fifteen(device)
    cs.log(f"[semi] phase 15 alone: {time.perf_counter() - t0:.1f} s ({walls})")


if __name__ == "__main__":
    main()
