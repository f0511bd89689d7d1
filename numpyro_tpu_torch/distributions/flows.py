"""Normalizing-flow transforms: IAF and BNAF (port of
``numpyro_tpu/distributions/flows.py``).  Both wrap an autoregressive
network; every forward pass also returns the per-coordinate log-Jacobian as
its intermediates, so ``log_prob`` after ``sample_with_intermediates`` never
runs the network again.  The networks' products are ``torch.matmul``, as the
JAX package computes them outside any Pallas kernel."""

from __future__ import annotations

import torch

from numpyro_tpu_torch.distributions.constraints import real_vector
from numpyro_tpu_torch.distributions.transforms import Transform

__all__ = ["BlockNeuralAutoregressiveTransform", "InverseAutoregressiveTransform"]


class _NeuralFlow(Transform):
    """Shared machinery of the network-backed vector flows: equality is the
    identity of the wrapped network plus the hyperparameters."""

    domain = real_vector
    codomain = real_vector
    _aux_fields = ()

    def __call__(self, x):
        y, _ = self.call_with_intermediates(x)
        return y

    def log_abs_det_jacobian(self, x, y, intermediates=None):
        if intermediates is None:
            _, intermediates = self.call_with_intermediates(x)
        return intermediates.sum(-1)

    def _aux(self):
        return tuple(getattr(self, name) for name in self._aux_fields)

    def __eq__(self, other):
        if type(other) is not type(self):
            return False
        mine, theirs = self._aux(), other._aux()
        return mine[0] is theirs[0] and mine[1:] == theirs[1:]

    def __hash__(self):
        return hash((type(self), id(self._aux()[0])))


class InverseAutoregressiveTransform(_NeuralFlow):
    """Inverse autoregressive flow (Kingma et al., arXiv:1606.04934, Eq 10):
    ``y = mu(x) + sigma(x) * x`` with a MADE conditioner returning ``(mu,
    log sigma)``.  The log-scale is clipped to ``[log_scale_min_clip,
    log_scale_max_clip]`` with a straight-through gradient (the value is
    clipped, the gradient is the unclipped one's)."""

    _aux_fields = ("arn", "log_scale_min_clip", "log_scale_max_clip")

    def __init__(self, autoregressive_nn, log_scale_min_clip=-5.0, log_scale_max_clip=3.0):
        self.arn = autoregressive_nn
        self.log_scale_min_clip = log_scale_min_clip
        self.log_scale_max_clip = log_scale_max_clip

    def _shift_and_logscale(self, x):
        shift, raw = self.arn(x)
        clipped = raw.clamp(self.log_scale_min_clip, self.log_scale_max_clip)
        return shift, raw + (clipped - raw).detach()

    def call_with_intermediates(self, x):
        shift, log_scale = self._shift_and_logscale(x)
        return x * torch.exp(log_scale) + shift, log_scale

    def _inverse(self, y):
        # coordinate d of x depends only on x[:d] (under the network's
        # permutation), so D sweeps give the exact inverse
        x = torch.zeros_like(y)
        for _ in range(y.shape[-1]):
            shift, log_scale = self._shift_and_logscale(x)
            x = (y - shift) * torch.exp(-log_scale)
        return x


class BlockNeuralAutoregressiveTransform(_NeuralFlow):
    """Block neural autoregressive flow (De Cao, Titov & Aziz).  It has no
    analytic inverse: use it for guides, not likelihoods."""

    _aux_fields = ("bn_arn",)

    def __init__(self, bn_arn):
        self.bn_arn = bn_arn

    def call_with_intermediates(self, x):
        return self.bn_arn(x)

    def _inverse(self, y):
        raise NotImplementedError("BlockNeuralAutoregressiveTransform has no analytic inverse.")
