"""A draw source that hands the port the JAX package's draws, for the
distribution parity tests: one queue of ``(kind, array)`` items, served in
order to the port's ``util.standard_draw`` (``normals``, ``uniforms``, ...)
and ``util.standard_gamma`` (``gammas``)."""

import numpy as np
import torch

KINDS = ("normals", "uniforms", "exponentials", "gumbels", "laplaces", "logistics", "cauchys")


class FedDraws:
    def __init__(self, items=()):
        self.items = list(items)

    def _pop(self, kind, shape):
        assert self.items, f"no draw left for {kind}"
        head, value = self.items.pop(0)
        assert head == kind, (head, kind)
        out = torch.from_numpy(np.array(value, dtype=np.float32, copy=True))
        assert tuple(out.shape) == tuple(shape), (kind, tuple(out.shape), tuple(shape))
        return out

    def gammas(self, alpha):
        return self._pop("gammas", alpha.shape)

    def __getattr__(self, name):
        if name in KINDS:
            return lambda shape, like: self._pop(name, shape)
        raise AttributeError(name)
