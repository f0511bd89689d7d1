"""Phase 23 of ``chip_smoke.py`` alone, in a fresh process.

    python3 -m dev.phase23 [cpu [rows]] [--cards] [--twice]
    python3 -m dev.phase23 --contention
    python3 -m dev.phase23 --idle

Run from the root of the repo.  On a machine with a CUDA GPU it makes the
covtype data at full size and spawns phase 23's ranks as ``chip_smoke.py``
does: two ranks on the one card over gloo, which join and warm up while the
kernels build.  Then it runs phase 4's per-step leg (the reference of 23a)
and phase 23.  ``--cards`` spawns one rank per card instead, each on its own
card over NCCL (a machine with two or more cards); ``--twice`` runs the
phase a second time.  With ``cpu`` it rehearses the phase on the CPU with
``rows`` rows (20,000 by default; about 90 s at 3,000), one thread a
process, the GLM op's plain version standing for ``glm_split``.  23c's
proxy and 23e's, 23f's and 23g's starts are anchored at the generating
coefficients, where the script anchors them at phase 8d's MAP; on the CPU
23e's and 23g's gate is 0.2 in place of the bench's 0.05.  Exits non-zero
where a leg fails.

``--contention`` measures what sharing one card costs, without any
collective: phase 4's per-step leg, warm (each process runs it once first),
alone in one process, then in two processes at once on the same card.

``--idle`` measures what phase 23's ranks cost the phases they wait
through: phases 16 and 18 (small models, host-bound), after two runs that
pay their first-run costs, timed twice over without ranks, twice beside two
ranks warmed up and idle on the card (spawned anew each time), and without
them again.
"""

import functools
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def one_leg(ready, go):
    """Phase 4's per-step leg in this process, once to warm up, then, once
    the file ``go`` is there, again; prints the second run's seconds."""
    cs._cuda.load()
    X, y, _, _ = cs.make_data(torch.device("cuda", 0))
    with tempfile.TemporaryDirectory(prefix="phase23_") as tmp:
        cs.phase_per_step(X, y, os.path.join(tmp, "per_step_warm.pt"))
        open(ready, "w").close()
        while not os.path.exists(go):
            time.sleep(0.01)
        t0 = time.perf_counter()
        cs.phase_per_step(X, y, os.path.join(tmp, "per_step_warm.pt"))
        print(f"LEG_S {time.perf_counter() - t0:.3f}", flush=True)


def contention():
    tmp = tempfile.mkdtemp(prefix="phase23_")
    for n in (1, 2):
        go = os.path.join(tmp, f"go{n}")
        ready = [os.path.join(tmp, f"ready{n}_{i}") for i in range(n)]
        procs = [subprocess.Popen([sys.executable, "-m", "dev.phase23", "--leg", r, go],
                                  stdout=subprocess.PIPE, text=True) for r in ready]
        while not all(map(os.path.exists, ready)):
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.05)
        open(go, "w").close()
        outs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise SystemExit(f"a leg failed:\n{outs}")
        secs = [float(ln.split()[1]) for out in outs for ln in out.splitlines()
                if ln.startswith("LEG_S")]
        cs.log(f"[ranks] phase 4's per-step leg, warm, in {n} process(es) at once on one "
               "card: " + ", ".join(f"{t:.2f} s" for t in secs))


def idle_ranks(X, y, w_chains, world, where, device):
    def timed():
        t0 = time.perf_counter()
        cs.phase_sixteen(device)
        cs.phase_eighteen(device)
        return time.perf_counter() - t0

    timed(), timed()
    walls = []
    for _ in range(2):
        walls.append(("without ranks", timed()))
        ranks = cs.Ranks(X, y, w_chains, world, str(where))
        ranks.warm_up()
        walls += [("beside idle ranks", timed()), ("beside idle ranks", timed())]
        ranks.stop()
        walls.append(("without ranks", timed()))
    cs.log("[ranks] phases 16 and 18: " + ", ".join(f"{w:.2f} s {what}" for what, w in walls))


def main(argv):
    if "--leg" in argv:
        return one_leg(*argv[argv.index("--leg") + 1:][:2])
    if "--contention" in argv:
        return contention()
    cpu = bool(argv) and argv[0] == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: run with `cpu` to rehearse on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, where = cs.RANKS, "cuda:0"
    if cpu:
        rows = [a for a in argv[1:] if not a.startswith("--")]
        cs.N = int(rows[0]) if rows else 20_000
        device = where = torch.device("cpu")
        # one thread a process: the ranks' thread pools would contend for the cores
        torch.set_num_threads(1)
        os.environ["OMP_NUM_THREADS"] = "1"
        cs.MCMC = functools.partial(cs.MCMC, device="cpu")
        # the plain version stands for the kernel: count its calls as launches
        counts = cs.glm.launch_counts
        real_plain = cs.glm.plain_value_and_grad

        def plain(w, data):
            counts["glm_split"] += 1
            counts["plain"] -= 1
            return real_plain(w, data)

        cs.glm.glm_value_and_grad = lambda w, data: plain(w, data)
        # 23e's gate is the bench's on all 581,012 rows; fewer rows give a
        # wider posterior
        cs.ROWS_NUTS = cs.ROWS_NUTS[:4] + (0.2,)
    else:
        device = torch.device("cuda", 0)
        cs.log(f"[device] {cs.smi()}; torch {torch.__version__}")
        if "--cards" in argv:
            world, where = torch.cuda.device_count(), "cards"
            if world < 2:
                raise SystemExit("--cards needs two or more cards")
    X, y, true_w, w_chains = cs.make_data(device)
    if "--idle" in argv:
        cs._cuda.load()
        return idle_ranks(X, y, w_chains, world, where, device)
    ranks = cs.Ranks(X, y, w_chains, world, str(where))
    if not cpu:
        t0 = time.perf_counter()
        cs._cuda.load()
        cs.log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="phase23_") as tmp:
        for turn in range(2 if "--twice" in argv else 1):
            if turn:
                ranks = cs.Ranks(X, y, w_chains, world, str(where))
            cs.log(f"[ranks] waited {ranks.warm_up():.1f} s for the ranks to warm up")
            if not turn:
                t0 = time.perf_counter()
                per_step = cs.phase_per_step(X, y, os.path.join(tmp, "per_step_warm.pt"))
                cs.log(f"[main] per-step leg: {time.perf_counter() - t0:.1f} s")
            wall, _, launches = cs.phase_ranks(ranks, per_step, X, y, w_chains, true_w, true_w)
            cs.log(f"[ranks] phase 23 alone: {wall:.1f} s from the one-process legs to the "
                   f"ranks' end, {ranks.warm_wait_s:.1f} s waiting for the warm-up; launches "
                   f"per rank and in this process {launches}")


if __name__ == "__main__":
    main(sys.argv[1:])
