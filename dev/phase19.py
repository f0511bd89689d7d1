"""Phase 19 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase19 [cpu [rows]]

Run from the root of the repo.  On a machine with a CUDA GPU it builds the
kernels, makes the covtype data at full size and runs phase 19's legs with
their checks on the card, printing each leg's seconds; with ``cpu`` it
rehearses them on the CPU with ``rows`` rows of the data (58,101, a tenth,
by default): the GLM op's plain version then stands for ``glm_split``, so
the checks hold the plain version against itself, which checks the code,
not the card.  Exits non-zero where a leg fails.
"""

import functools
import os
import sys
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
        cs.N = int(argv[1]) if len(argv) > 1 else 58_101
        device = torch.device("cpu")
        cs.MCMC = functools.partial(cs.MCMC, device="cpu")
        for name in ("get_dependencies", "get_model_relations"):
            setattr(cs, name, functools.partial(getattr(cs, name), device="cpu"))
        torch.cuda.synchronize = lambda *a, **k: None
        # the plain version stands for the kernel: count its calls as launches
        counts = cs.glm.launch_counts
        real_plain = cs.glm.plain_value_and_grad

        def plain(w, data):
            counts["glm_split"] += 1
            counts["plain"] -= 1
            return real_plain(w, data)

        cs.glm.glm_value_and_grad = lambda w, data: plain(w, data)
        cs.glm.plain_bernoulli_logits_loglik = functools.partial(
            cs.glm._loglik, value_and_grad=real_plain)
    else:
        device = torch.device("cuda", 0)
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
        cs._cuda.load()
    X, y, _, _ = cs.make_data(device)
    t0 = time.perf_counter()
    walls, launches, try_s = cs.phase_nineteen(X, y)
    cs.log(f"[tail] phase 19 alone: {time.perf_counter() - t0:.1f} s ({walls}, glm_split "
           f"launches {launches}, one init_to_median try {try_s:.3f} s)")


if __name__ == "__main__":
    main(sys.argv[1:])
