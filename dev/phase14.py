"""Phase 14 of ``chip_smoke.py`` alone, on the card, in a fresh process.

    python3 -m dev.phase14

Run from the root of the repo on a machine with a CUDA GPU.  Builds the
kernels, makes the covtype-shape data, runs a short split-mode NUTS leg of
phase 4 (20 + 10 transitions, for 14b's comparison of evaluations per draw
and ms per evaluation), then phase 14's legs with their gates, and prints
each leg's seconds.  Exits non-zero where a leg fails.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from numpyro_tpu_torch.ops import glm  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this run needs an NVIDIA GPU")
    cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._cuda.load()
    X, y, true_w, _ = cs.make_data(device)
    glm.reset_launch_counts()
    nuts = cs.phase_main(X, y, true_w, "glm_split", run=(20, 10, (5, 10), None), tag="probe")
    t0 = time.perf_counter()
    guide, res, data, n_a, ms = cs.phase_iaf(X, y, true_w)
    t1 = time.perf_counter()
    n_b = cs.phase_neutra(X, y, true_w, guide, res.params, data, nuts)
    t2 = time.perf_counter()
    del data
    wall_ce = cs.phase_flow_examples(device)
    cs.log(f"[flows] phase 14 alone: {time.perf_counter() - t0:.1f} s (14a {t1 - t0:.1f} s, "
           f"14b {t2 - t1:.1f} s, 14c-e {wall_ce:.1f} s); glm_split launches {n_a} + {n_b}")


if __name__ == "__main__":
    main()
