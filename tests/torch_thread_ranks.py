"""Ranks of a data group as threads of one process, for the tests of
``numpyro_tpu_torch/parallel/data_shard.py`` without a process group
(``test_torch_data_shard.py`` on the CPU, ``test_torch_cuda.py`` on the
card): ``torch.distributed.all_reduce`` over a :class:`ThreadRanks` group,
patched in by :func:`patch_all_reduce`, sums the threads' tensors or takes
their maximum or minimum.  The module imports no JAX.
"""

import threading

import torch
import torch.distributed as tdist

from numpyro_tpu_torch import primitives


class ThreadRanks:
    """The ranks of a data group as threads of this process, for
    ``torch.distributed.all_reduce`` over this group
    (:func:`patch_all_reduce`): one thread runs at a time, in turn, until
    its next collective, where it hands its tensor in and the turn on; the
    last rank's hand-in reduces them all (in rank order); ``calls`` counts
    each rank's collectives.  Each thread has its own handler stack
    (``primitives._PYRO_STACK``, swapped at each turn), so models run on the
    ranks as in processes of their own.  Forward-mode levels are one table
    for the process, so a ``jacfwd`` cannot run across the turns, and a
    CUDA backward pass runs on autograd's thread for the device, so no
    gradient crosses the ranks on the card."""

    def __init__(self, world):
        self.world = world
        self.cond = threading.Condition()
        self.turn, self.failed = 0, None
        self.slots, self.result = [None] * world, None
        self.stacks = [[] for _ in range(world)]
        self.calls = [0] * world
        self.local = threading.local()

    def rank(self):
        rank = getattr(self.local, "rank", None)
        if rank is None:
            # autograd runs a CUDA backward pass on a thread of its own, one
            # for the device, which one rank's waiting collective would hold
            raise RuntimeError("a collective over thread ranks from a thread that is not one "
                               "of them (a backward pass on a CUDA device): thread ranks take "
                               "no gradient across the ranks on the card")
        return rank

    def size(self):
        return self.world

    def _hand_on(self, r):
        self.stacks[r] = list(primitives._PYRO_STACK)
        self.turn = (r + 1) % self.world
        self.cond.notify_all()

    def _wait_turn(self, r):
        if not self.cond.wait_for(lambda: self.turn == r or self.failed, timeout=60):
            raise TimeoutError(f"thread rank {r} waited 60 s for its turn")
        if self.failed:
            raise RuntimeError(f"thread rank {r}: another rank failed") from self.failed
        primitives._PYRO_STACK[:] = self.stacks[r]

    def all_reduce(self, tensor, op):
        r = self.rank()
        self.calls[r] += 1
        with self.cond:
            self.slots[r] = tensor.clone()
            if r == self.world - 1:
                if op == tdist.ReduceOp.SUM:
                    out = self.slots[0].clone()
                    for part in self.slots[1:]:
                        out += part
                else:
                    parts = torch.stack(self.slots)
                    out = parts.amax(0) if op == tdist.ReduceOp.MAX else parts.amin(0)
                self.result = out
            self._hand_on(r)
            self._wait_turn(r)
            tensor.copy_(self.result)

    def run(self, fn):
        """``[fn(rank) for every rank]``, each on its thread."""
        results = [None] * self.world

        def go(r):
            self.local.rank = r
            try:
                with self.cond:
                    self._wait_turn(r)
                results[r] = fn(r)
                with self.cond:
                    self._hand_on(r)
            except BaseException as e:  # noqa: BLE001 - handed to the test's thread
                with self.cond:
                    self.failed = self.failed or e
                    self.cond.notify_all()

        threads = [threading.Thread(target=go, args=(r,), daemon=True) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive(), "a thread rank did not end within 120 s"
        primitives._PYRO_STACK.clear()
        if self.failed is not None:
            raise self.failed
        return results


def patch_all_reduce(monkeypatch, world=2):
    """A :class:`ThreadRanks` group of ``world`` ranks, and
    ``torch.distributed.all_reduce`` over it (through ``monkeypatch``)."""
    group = ThreadRanks(world)
    real = tdist.all_reduce

    def all_reduce(tensor, op=tdist.ReduceOp.SUM, group=None, async_op=False):
        if isinstance(group, ThreadRanks):
            return group.all_reduce(tensor, op)
        return real(tensor, op=op, group=group, async_op=async_op)

    monkeypatch.setattr(tdist, "all_reduce", all_reduce)
    return group
