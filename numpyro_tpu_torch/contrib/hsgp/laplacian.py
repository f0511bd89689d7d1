"""Dirichlet-Laplacian eigenpairs on a box, the basis of the HSGP low-rank
approximation (Solin & Särkkä 2020; port of
``numpyro_tpu/contrib/hsgp/laplacian.py``).

Every constant is made on the device of the input it goes with, by a fill
or an ``arange`` there, never copied from the host: ``ell`` and the
eigenindices on ``x``'s device (or ``device``, where a function takes no
tensor), and the periodic basis multiplies ``w0 x`` by ``arange(m)`` where
the JAX package multiplies by ``diag(arange(m))``, with the same float32
numbers (the products it adds are exact zeros).
"""

from __future__ import annotations

import math

import torch

__all__ = ["eigenfunctions", "eigenfunctions_periodic", "eigenindices", "sqrt_eigenvalues"]


def _convert_ell(ell, dim, device=None, dtype=torch.float32):
    """``ell`` as a ``(dim, 1)`` tensor: a number repeated, a list of
    ``dim`` numbers, or a tensor of that shape."""
    if isinstance(ell, (float, int)):
        return torch.full((dim, 1), float(ell), device=device, dtype=dtype)
    if isinstance(ell, list):
        if len(ell) != dim:
            raise ValueError("The length of ell must be equal to the dimension of the space.")
        return torch.stack([torch.full((1,), float(v), device=device, dtype=dtype) for v in ell])
    ell = torch.as_tensor(ell, device=device)
    if tuple(ell.shape) != (dim, 1):
        raise ValueError("ell must be a scalar or a list of length `dim`.")
    return ell


def eigenindices(m, dim, *, device=None):
    """Indices of the first ``prod(m)`` D-dimensional Laplacian eigenvalues
    (Riutort-Mayol et al. 2023, Eq. 10), ``(dim, prod(m))`` int64."""
    if isinstance(m, int):
        m = [m] * dim
    elif len(m) != dim:
        raise ValueError("The length of m must be equal to the dimension of the space.")
    if dim == 1:
        return torch.arange(1, m[0] + 1, device=device).reshape(1, -1)
    grids = torch.meshgrid(*[torch.arange(1, m_ + 1, device=device) for m_ in m], indexing="ij")
    return torch.stack(grids, dim=-1).reshape(-1, dim).T


def sqrt_eigenvalues(ell, m, dim, *, device=None):
    """Square roots of the eigenvalues of -Δ on [-L, L]^D (Solin & Särkkä
    Eq. 56), ``(dim, prod(m))``, on ``device`` (or ``ell``'s, where it is a
    tensor)."""
    if device is None and isinstance(ell, torch.Tensor):
        device = ell.device
    ell_ = _convert_ell(ell, dim, device)
    S = eigenindices(m, dim, device=ell_.device)
    return S.to(ell_.dtype) * math.pi / 2 / ell_


def eigenfunctions(x, ell, m):
    """The eigenfunctions at ``x`` (``(..., n, dim)``, or ``(n,)`` taken as
    ``(n, 1)``), ``(..., n, prod(m))``."""
    x_ = x.unsqueeze(-1) if x.dim() == 1 else x
    ell_ = _convert_ell(ell, x_.shape[-1], x_.device, x_.dtype)
    return _eigenfunctions(x_, ell_, sqrt_eigenvalues(ell_, m, x_.shape[-1]))


def _eigenfunctions(x_, ell_, sqrt_eig):
    """:func:`eigenfunctions` at ``x_`` ``(..., n, dim)`` from ``ell`` as a
    ``(dim, 1)`` tensor and the square roots of the eigenvalues, which an
    HSGP fragment computes once for its basis and its spectral density."""
    lead = (1,) * (x_.dim() - 1)
    a = ell_.reshape(lead + tuple(ell_.shape))
    b = sqrt_eig.reshape(lead + tuple(sqrt_eig.shape))
    return torch.prod(torch.sqrt(1 / a) * torch.sin(b * (x_.unsqueeze(-1) + a)), dim=-2)


def eigenfunctions_periodic(x, w0, m):
    """The cosine and sine bases of the periodic-kernel approximation at
    ``x`` (1D only), ``(n, m)`` each."""
    if x.dim() > 1:
        raise ValueError("Multidimensional inputs are not supported by the periodic kernel.")
    mw0x = (w0 * x.unsqueeze(-1)) * torch.arange(m, device=x.device, dtype=x.dtype)
    return torch.cos(mw0x), torch.sin(mw0x)
