"""Host time of one batched potential evaluation of the horseshoe in reverse
and in forward mode, and the calls that forward mode makes into
``torch/_refs`` (PyTorch's Python reference implementations).

    python3 -m dev.forward_profile [cpu|cuda] [chains]

Run from the root of the repo (``cuda`` and 256 chains by default; one thread
on the CPU).  Uses
``chip_smoke.py``'s horseshoe (the data of ``examples/horseshoe_regression.py``
at its defaults), initialised as ``MCMC`` initialises it.  Prints the median
ms of 20 evaluations in each mode on the host's clock (each ending in a
synchronize) and, from ``cProfile`` of one forward-mode evaluation, how many
calls went into ``torch/_refs`` and the share of its time they took.
"""

import cProfile
import pstats
import statistics
import sys
import time

import torch

import chip_smoke
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import FlatLayout, batched_potential


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv):
    device = torch.device(argv[0] if argv else "cuda")
    chains = int(argv[1]) if len(argv) > 1 else 256
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(chip_smoke.smi(), flush=True)
    else:
        torch.set_num_threads(1)  # forward mode is slower with more threads there
    X, y, _ = chip_smoke.horseshoe_data(device)
    info = infer_util.initialize_model(
        torch.Generator(device=device).manual_seed(0), chip_smoke.model_horseshoe,
        num_chains=chains, dynamic_args=True, model_args=(X, y),
    )
    z = info.param_info.z
    layout = FlatLayout({k: v[0] for k, v in z.items()})
    panel = layout.ravel_batch(z)
    pe_fn = info.potential_fn(X, y)
    for forward in (False, True):
        pe_grad = batched_potential(pe_fn, layout, forward_mode=forward)
        pe_grad(panel)
        times = []
        for _ in range(20):
            _sync(device)
            t0 = time.perf_counter()
            pe_grad(panel)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{'forward' if forward else 'reverse'} mode, {chains} chains on {device}: "
              f"{statistics.median(times):.3f} ms per evaluation (median of 20)", flush=True)
    prof = cProfile.Profile()
    prof.enable()
    pe_grad(panel)
    _sync(device)
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = max(ct for (_, _, _, ct, _) in stats.values())
    # a reference implementation is entered through the wrappers of
    # torch/_prims_common, called straight from the model's frames
    calls, seconds = 0, 0.0
    for key, (_, _, _, _, callers) in stats.items():
        if key[0].endswith("_prims_common/wrappers.py") and key[2] == "_fn":
            for caller, (_, nc, _, ct) in callers.items():
                if "/torch/" not in caller[0]:
                    calls += nc
                    seconds += ct
    print(f"one forward-mode evaluation: {calls} ops went through torch/_refs from the "
          f"model's code, {seconds * 1e3:.3f} ms of {total * 1e3:.3f} ms under cProfile "
          f"({seconds / total:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
