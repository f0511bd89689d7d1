"""Kernel spectral densities for HSGP (port of
``numpyro_tpu/contrib/hsgp/spectral_densities.py``).

The JAX package maps a density over the ``(dim, M)`` square roots of the
eigenvalues with ``vmap(..., in_axes=-1)``, stacking the ``M`` results on
axis 0.  The port broadcasts instead: the eigenvalues take the shape
``(M, 1, ..., 1, dim)``, with as many ones as the result of one density
has dims (``alpha``'s, or ``length``'s batch), so the output is laid out as
JAX's, ``(M, *batch)``.  A Python number among the parameters becomes a
tensor by a fill on the device of the eigenvalues.

The periodic density departs from the JAX package's: it computes
``I_j(a) e^{-a}`` in one step, as the exponent of the scaled quadrature
(``distributions.directional.log_scaled_bessel_i_orders``), where the JAX
package divides ``exp(log I_j(a))`` by ``exp(a)``.  Both overflow float32
once ``a = length**-2`` passes about 88 (``length <= 0.1``), where the JAX
package gives NaN and the port the finite coefficients (ROADMAP.md,
Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from numpyro_tpu_torch.contrib.hsgp.laplacian import sqrt_eigenvalues
from numpyro_tpu_torch.distributions.directional import (
    log_bessel_i_orders,
    log_scaled_bessel_i_orders,
)
from numpyro_tpu_torch.distributions.util import broadcast_shape

__all__ = [
    "diag_spectral_density_matern",
    "diag_spectral_density_periodic",
    "diag_spectral_density_squared_exponential",
    "modified_bessel_first_kind",
    "spectral_density_matern",
    "spectral_density_squared_exponential",
]


def _device_of(*params):
    """The device of the first tensor among ``params``, else the CPU."""
    return next((p.device for p in params if isinstance(p, torch.Tensor)), torch.device("cpu"))


def _tensor(param, like):
    """``param``, or a Python number as a 0-dim tensor filled on ``like``'s
    device and in its dtype."""
    if isinstance(param, torch.Tensor):
        return param
    return torch.full((), float(param), device=like.device, dtype=like.dtype)


def align_param(dim, param):
    if not isinstance(param, torch.Tensor):
        param = torch.as_tensor(param, dtype=torch.get_default_dtype())
    return param.expand(broadcast_shape(tuple(param.shape), (dim,)))


def spectral_density_squared_exponential(dim, w, alpha, length):
    """S(w) of the RBF kernel (Rasmussen & Williams §4.2)."""
    length = align_param(dim, _tensor(length, w))
    c = alpha * torch.prod(math.sqrt(2 * math.pi) * length, dim=-1)
    e = torch.exp(-0.5 * torch.sum(w**2 * length**2, dim=-1))
    return c * e


def _gamma(x):
    return math.gamma(x) if not isinstance(x, torch.Tensor) else torch.lgamma(x).exp()


def spectral_density_matern(dim, nu, w, alpha, length):
    """S(w) of the Matérn kernel (Rasmussen & Williams Eq. 4.15)."""
    length = align_param(dim, _tensor(length, w))
    c1 = alpha * (2**dim) * (math.pi ** (dim / 2)) * ((2 * nu) ** nu) * _gamma(nu + dim / 2)
    s = torch.sum(length**2 * w**2, dim=-1)
    c2 = torch.prod(length, dim=-1) * (2 * nu + s) ** (-nu - dim / 2)
    return c1 * c2 / _gamma(nu)


def _over_eigenvalues(density, sqrt_eig, dim, alpha, length, *more):
    """``density(w)`` for every column ``w`` of ``sqrt_eig`` at once,
    ``(M, *batch)``, as JAX's ``vmap(..., in_axes=-1)`` stacks it."""
    alpha, length = _tensor(alpha, sqrt_eig), _tensor(length, sqrt_eig)
    batch_dims = max(alpha.dim(), align_param(dim, length).dim() - 1,
                     *(m.dim() for m in more if isinstance(m, torch.Tensor)))
    w = sqrt_eig.T.reshape((sqrt_eig.shape[1],) + (1,) * batch_dims + (dim,))
    return density(w, alpha, length)


def diag_spectral_density_squared_exponential(alpha, length, ell, m, dim):
    sqrt_eig = sqrt_eigenvalues(ell=ell, m=m, dim=dim, device=_device_of(alpha, length))
    return _diag_squared_exponential(sqrt_eig, alpha, length, dim)


def _diag_squared_exponential(sqrt_eig, alpha, length, dim):
    return _over_eigenvalues(
        lambda w, a, l: spectral_density_squared_exponential(dim=dim, w=w, alpha=a, length=l),
        sqrt_eig, dim, alpha, length)


def diag_spectral_density_matern(nu, alpha, length, ell, m, dim):
    sqrt_eig = sqrt_eigenvalues(ell=ell, m=m, dim=dim, device=_device_of(alpha, length, nu))
    return _diag_matern(sqrt_eig, nu, alpha, length, dim)


def _diag_matern(sqrt_eig, nu, alpha, length, dim):
    return _over_eigenvalues(
        lambda w, a, l: spectral_density_matern(dim=dim, nu=nu, w=w, alpha=a, length=l),
        sqrt_eig, dim, alpha, length, nu)


def _rows(table, orders):
    """Rows ``orders`` (host integers) of ``table``, by views and one stack:
    no index tensor is copied to the device."""
    return torch.stack([table[int(i)] for i in orders])


def modified_bessel_first_kind(v, z):
    """I_v(z) for integer orders ``v`` (host integers) through the Bessel
    quadrature of the directional module
    (``distributions.directional.log_bessel_i_orders``)."""
    v = np.asarray(v)
    z = z if isinstance(z, torch.Tensor) else torch.as_tensor(z, dtype=torch.get_default_dtype())
    if not z.is_floating_point():
        z = z.to(torch.get_default_dtype())
    all_orders = torch.exp(log_bessel_i_orders(int(np.max(v)), z.reshape(-1))).T
    out = _rows(all_orders, v.reshape(-1))
    return out.reshape(broadcast_shape(tuple(v.shape), tuple(z.shape)))


def diag_spectral_density_periodic(alpha, length, m):
    """First ``m`` coefficients of the periodic-kernel low-rank expansion
    (Riutort-Mayol et al., Appendix B): ``c_j alpha^2 I_j(a) e^{-a}`` with
    ``a = length**-2``, ``c_0 = 1`` and ``c_j = 2`` after, the scaled Bessel
    value in one step (this module's docstring)."""
    a = _tensor(length, torch.empty((), device=_device_of(alpha, length))) ** (-2)
    scaled = torch.exp(log_scaled_bessel_i_orders(m - 1, a.reshape(-1))).T
    scaled = scaled.reshape(broadcast_shape((m,), tuple(a.shape)))
    j = torch.arange(m, device=a.device)
    c = torch.where(j > 0, 2.0, 1.0).to(a.dtype)
    return (c * alpha**2) * scaled
