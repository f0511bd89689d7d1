"""Phase 16 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase16 [cpu]
    python3 -m dev.phase16 --sizing [chains warmup samples]

Run from the root of the repo.  On a machine with a CUDA GPU it runs phase
16's legs with their gates on the card and prints each leg's seconds; with
``cpu`` it rehearses them on the CPU (16c then holds the CPU against itself,
which checks the code, not the card).  Exits non-zero where a leg fails.

``--sizing`` (on the card) opens 16a's and 16b's gates and runs the phase
twice in one process, cold then warm, to size its lengths before the JAX
references are run: the optional numbers set both legs' chains, warmup and
samples (depths stay (3, 3)); by default the committed ``UCB_RUN`` and
``SSBVM_RUN``.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main(argv):
    cpu = argv == ["cpu"]
    sizing = argv[:1] == ["--sizing"]
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run with `cpu` to rehearse on the CPU")
    device = torch.device("cpu" if cpu else "cuda")
    if not cpu:
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sizing:
        if argv[1:]:
            chains, warmup, samples = (int(a) for a in argv[1:])
            cs.UCB_RUN = cs.SSBVM_RUN = (chains, warmup, samples, (3, 3))
        cs.UCB_GATE = cs.SSBVM_GATE = float("inf")
    for label in ("cold", "warm") if sizing else ("alone",):
        t0 = time.perf_counter()
        walls, ms, predictive_s = cs.phase_sixteen(device)
        if cpu:
            walls["16c"] = cs.phase_new_families(device)
        cs.log(f"[discrete] phase 16 {label}: {time.perf_counter() - t0:.1f} s ({walls}, {ms} ms "
               f"per evaluation, Predictive {predictive_s:.3f} s)")


if __name__ == "__main__":
    main(sys.argv[1:])
