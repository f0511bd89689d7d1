"""HSGP low-rank GP approximations: model fragments usable inside any
model of the port (port of ``numpyro_tpu/contrib/hsgp/approximation.py``;
Riutort-Mayol et al. 2023).  The sites and plates are the JAX package's:
``beta`` under ``basis``; ``beta_cos`` under ``cos_basis`` and ``beta_sin``,
of size ``m - 1``, under ``sin_basis``.  The basis product ``phi @ (spd *
beta)`` is a plain ``torch.matmul``, as the JAX package computes it outside
Pallas; the spectral densities are made on ``x``'s device.

The fragments take the square root of the spectral density with a gradient
of 0 where the density underflows to 0 in float32, as the exact gradient
there rounds to.  The JAX package's ``jnp.sqrt`` gives NaN there, so its
squared-exponential fragment has a NaN gradient in ``alpha`` and
``length`` once ``length * sqrt_eigenvalue`` passes about 14.4 (at the
example's ``m = 20``, ``ell = 1.5``, from ``length`` about 0.68), and NUTS
turns back from there (ROADMAP.md, Queue 3)."""

from __future__ import annotations

import torch

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.contrib.hsgp.laplacian import (
    _convert_ell,
    _eigenfunctions,
    eigenfunctions_periodic,
    sqrt_eigenvalues,
)
from numpyro_tpu_torch.contrib.hsgp.spectral_densities import (
    _diag_matern,
    _diag_squared_exponential,
    _tensor,
    diag_spectral_density_periodic,
)

__all__ = [
    "hsgp_matern",
    "hsgp_periodic_non_centered",
    "hsgp_squared_exponential",
    "linear_approximation",
]


def _sqrt(spd):
    """``sqrt(spd)`` whose gradient is 0, not NaN, where ``spd`` is 0."""
    positive = spd > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, spd, 1.0)), 0.0)


def _non_centered_approximation(phi, spd, m):
    with npt.plate("basis", m):
        beta = npt.sample("beta", dist.Normal(0.0, 1.0))
    return phi @ (spd * beta)


def _centered_approximation(phi, spd, m):
    with npt.plate("basis", m):
        # the zero is filled on spd's device: no copy of a host number
        beta = npt.sample("beta", dist.Normal(spd.new_zeros(()), spd))
    return phi @ beta


def linear_approximation(phi, spd, m, non_centered=True):
    """phi @ diag(spd) @ beta (Riutort-Mayol et al. Eq. 8)."""
    if non_centered:
        return _non_centered_approximation(phi, spd, m)
    return _centered_approximation(phi, spd, m)


def _basis(x, ell, m):
    """``(phi, sqrt_eig, dim)``: the eigenfunctions at ``x`` and the square
    roots of the eigenvalues they share with the spectral density (the JAX
    package computes these twice, and ``jit`` folds them; here each
    evaluation pays for them, once)."""
    x_ = x.unsqueeze(-1) if x.dim() == 1 else x
    dim = x_.shape[-1]
    ell_ = _convert_ell(ell, dim, x_.device, x_.dtype)
    sqrt_eig = sqrt_eigenvalues(ell_, m, dim)
    return _eigenfunctions(x_, ell_, sqrt_eig), sqrt_eig, dim


def hsgp_squared_exponential(x, alpha, length, ell, m, non_centered=True):
    """HSGP fragment with the squared exponential kernel."""
    phi, sqrt_eig, dim = _basis(x, ell, m)
    spd = _sqrt(_diag_squared_exponential(sqrt_eig, alpha, length, dim))
    return linear_approximation(phi, spd, phi.shape[-1], non_centered)


def hsgp_matern(x, nu, alpha, length, ell, m, non_centered=True):
    """HSGP fragment with the Matérn kernel."""
    phi, sqrt_eig, dim = _basis(x, ell, m)
    spd = _sqrt(_diag_matern(sqrt_eig, nu, alpha, length, dim))
    return linear_approximation(phi, spd, phi.shape[-1], non_centered)


def hsgp_periodic_non_centered(x, alpha, length, w0, m):
    """Periodic-kernel low-rank fragment (non-centered)."""
    q2 = diag_spectral_density_periodic(alpha=alpha, length=_tensor(length, x), m=m)
    cosines, sines = eigenfunctions_periodic(x=x, w0=w0, m=m)
    with npt.plate("cos_basis", m):
        beta_cos = npt.sample("beta_cos", dist.Normal(0, 1))
    with npt.plate("sin_basis", m - 1):
        beta_sin = npt.sample("beta_sin", dist.Normal(0, 1))
    beta_sin = torch.cat((beta_sin.new_zeros(beta_sin.shape[:-1] + (1,)), beta_sin), dim=-1)
    return cosines @ (q2 * beta_cos) + sines @ (q2 * beta_sin)
