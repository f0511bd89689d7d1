"""A draw source that hands the port the JAX package's draws, for the
distribution parity tests: one queue of ``(kind, array)`` items, served in
order to the port's ``util.standard_draw`` (``normals``, ``uniforms``, ...),
``util.standard_gamma`` (``gammas``) and the whole-draw samplers
``util.binomial`` (``binomials``), ``util.poisson`` (``poissons``) and
``util.von_mises_centered`` (``von_mises``); and an exact sampler of the
bivariate von Mises density for the goodness-of-fit tests."""

import math

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

    def binomials(self, count, probs):
        return self._pop("binomials", probs.shape)

    def poissons(self, rate):
        return self._pop("poissons", rate.shape)

    def von_mises(self, concentration):
        return self._pop("von_mises", concentration.shape)

    def __getattr__(self, name):
        if name in KINDS:
            return lambda shape, like: self._pop(name, shape)
        raise AttributeError(name)


def exact_sine_bivariate_draws(params, n, seed):
    """``n`` exact draws of a ``SineBivariateVonMises`` of scalar float
    ``params`` by rejection from the uniform on the torus, under the bound
    ``exp(k1 + k2 + |rho|)`` of its unnormalised density (numpy, float64)."""
    rng = np.random.default_rng(seed)
    k1, k2, rho = (params[k] for k in ("phi_concentration", "psi_concentration", "correlation"))
    out = np.empty((0, 2))
    while len(out) < n:
        x = rng.uniform(-math.pi, math.pi, (4 * n, 2))
        u, v = x[:, 0] - params["phi_loc"], x[:, 1] - params["psi_loc"]
        log_f = k1 * np.cos(u) + k2 * np.cos(v) + rho * np.sin(u) * np.sin(v)
        keep = np.log(rng.uniform(size=4 * n)) < log_f - (k1 + k2 + abs(rho))
        out = np.concatenate([out, x[keep]])
    return out[:n]
