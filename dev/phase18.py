"""Phase 18 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase18 [cpu]
    python3 -m dev.phase18 --sizing [chains warmup samples]

Run from the root of the repo.  On a machine with a CUDA GPU it runs phase
18's legs with their gates on the card and prints each leg's seconds; with
``cpu`` it rehearses them on the CPU (the potential checks then hold the CPU
against itself, which checks the code, not the card).  Exits non-zero where
a leg fails.

``--sizing`` opens 18a's gate and runs the phase twice in one process, cold
then warm, to size its length before the JAX reference is run: the optional
numbers set 18a's chains, warmup and samples (depths stay (3, 3)); by
default the committed ``ANNOT_RUN``.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main(argv):
    cpu = "cpu" in argv
    sizing = "--sizing" in argv
    numbers = [a for a in argv if a not in ("cpu", "--sizing")]
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run with `cpu` to rehearse on the CPU")
    device = torch.device("cpu" if cpu else "cuda")
    if not cpu:
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sizing:
        if numbers:
            chains, warmup, samples = (int(a) for a in numbers)
            cs.ANNOT_RUN = (chains, warmup, samples, (3, 3))
        cs.ANNOT_REF, cs.ANNOT_GATE = 0.0, float("inf")
    for label in ("cold", "warm") if sizing else ("alone",):
        t0 = time.perf_counter()
        walls, ms, syncs = cs.phase_eighteen(device)
        cs.log(f"[dsl] phase 18 {label}: {time.perf_counter() - t0:.1f} s ({walls}, 18a "
               f"{ms:.2f} ms an evaluation, host syncs per evaluation {syncs})")


if __name__ == "__main__":
    main(sys.argv[1:])
