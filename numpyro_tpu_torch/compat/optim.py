"""Pyro-style optimizer constructors (port of
``numpyro_tpu/compat/optim.py``): each takes Pyro's dict of keyword
arguments."""

from numpyro_tpu_torch import optim


def Adam(kwargs):
    step_size = kwargs.pop("lr", 1e-3)
    betas = kwargs.pop("betas", (0.9, 0.999))
    eps = kwargs.pop("eps", 1e-8)
    return optim.Adam(step_size=step_size, b1=betas[0], b2=betas[1], eps=eps)


def ClippedAdam(kwargs):
    step_size = kwargs.pop("lr", 1e-3)
    betas = kwargs.pop("betas", (0.9, 0.999))
    eps = kwargs.pop("eps", 1e-8)
    clip_norm = kwargs.pop("clip_norm", 10.0)
    return optim.ClippedAdam(
        step_size=step_size, b1=betas[0], b2=betas[1], eps=eps, clip_norm=clip_norm
    )


def SGD(kwargs):
    step_size = kwargs.pop("lr", 1e-3)
    return optim.SGD(step_size=step_size)
