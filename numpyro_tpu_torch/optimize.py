"""BFGS minimization, the counterpart of ``jax.scipy.optimize.minimize(...,
method="BFGS")`` for ``optim.Minimize`` (``AutoLaplaceApproximation``'s fit).

The algorithm is JAX's (``jax/_src/scipy/optimize/bfgs.py`` and
``line_search.py``): Nocedal and Wright's Algorithm 6.1 from the identity as
the first inverse Hessian, the zoom line search of their Algorithm 3.5-3.6
with the strong Wolfe constants ``c1 = 1e-4`` and ``c2 = 0.9``, at most
``line_search_maxiter = 10`` line-search steps and 30 zoom steps,
``gtol = 1e-5`` on the inf-norm of the gradient and ``maxiter = 200 D``.

It is a host loop.  The vectors (the point, the gradient, the direction and
the inverse Hessian) stay on their device; the scalars of the line search
are numpy numbers of the point's dtype, so that its branches are the same as
JAX's.  Each evaluation of the objective reads its value, its slope along
the direction and the inf-norm of its gradient to the host in one sync, and
each iteration reads one more (the slope at its start).  JAX runs the same
loops as ``lax.while_loop``s on the device.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

__all__ = ["OptimizeResults", "minimize", "minimize_bfgs"]

OptimizeResults = namedtuple(
    "OptimizeResults",
    ["x", "success", "status", "fun", "jac", "hess_inv", "nfev", "njev", "nit"],
)
BFGSResults = namedtuple(
    "BFGSResults",
    ["converged", "failed", "k", "nfev", "ngev", "nhev", "x_k", "f_k", "g_k", "H_k",
     "old_old_fval", "status", "line_search_status"],
)
_LineSearchResults = namedtuple(
    "_LineSearchResults", ["failed", "nit", "nfev", "ngev", "k", "a_k", "f_k", "g_k", "status"]
)


class _Objective:
    """``fun`` and its gradient at ``x`` by ``torch.func.grad_and_value``;
    ``along(t)`` evaluates at ``xk + t pk`` and reads ``(phi, dphi,
    |g|_inf)`` to the host in one sync."""

    def __init__(self, fun, dtype):
        self.vg = torch.func.grad_and_value(fun)
        self.np = np.dtype(str(dtype).replace("torch.", ""))

    def scalar(self, v):
        return self.np.type(v)

    def at(self, x):
        g, f = self.vg(x)
        f_h, g_inf, g_two = torch.stack(
            [f.detach().to(x.dtype), g.abs().max(), torch.linalg.vector_norm(g)]
        ).tolist()
        return self.scalar(f_h), g, self.scalar(g_inf), self.scalar(g_two)

    def along(self, xk, pk, t):
        g, f = self.vg(xk + float(t) * pk)
        phi, dphi, g_inf = torch.stack([f.detach().to(pk.dtype), g @ pk, g.abs().max()]).tolist()
        return self.scalar(phi), self.scalar(dphi), (g, self.scalar(g_inf))


def _cubicmin(s, a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc**2, -(db**2)], [-(dc**3), db**3]], dtype=s.np)
    d2 = np.array([fb - fa - C * db, fc - fa - C * dc], dtype=s.np)
    A, B = (d1 @ d2) / denom
    radical = B * B - s.scalar(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (s.scalar(3.0) * A)


def _quadmin(s, a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (s.scalar(2.0) * B)


def _zoom(s, along, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi, g_0):
    """Nocedal and Wright's Algorithm 3.6 as JAX writes it: cubic, then
    quadratic, then bisection; returns ``(failed, a_star, phi_star,
    dphi_star, g_star, nfev)``."""
    threshold = s.scalar(1e-5 if s.np.itemsize < 8 else 1e-10)
    delta1, delta2 = s.scalar(0.2), s.scalar(0.1)
    done = failed = False
    j = nfev = 0
    a_rec = (a_lo + a_hi) / s.scalar(2.0)
    phi_rec = (phi_lo + phi_hi) / s.scalar(2.0)
    a_star, phi_star, dphi_star, g_star = s.scalar(1.0), phi_lo, dphi_lo, g_0
    while not done and not failed:
        dalpha = a_hi - a_lo
        a, b = min(a_hi, a_lo), max(a_hi, a_lo)
        cchk, qchk = delta1 * dalpha, delta2 * dalpha
        failed = failed or bool(dalpha <= threshold)
        a_j_cubic = _cubicmin(s, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec)
        use_cubic = j > 0 and a + cchk < a_j_cubic < b - cchk
        a_j_quad = _quadmin(s, a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = not use_cubic and a + qchk < a_j_quad < b - qchk
        if use_cubic:
            a_j = a_j_cubic
        elif use_quad:
            a_j = a_j_quad
        else:
            a_j = (a_lo + a_hi) / s.scalar(2.0)
        phi_j, dphi_j, g_j = along(a_j)
        nfev += 1
        hi_to_j = wolfe_one(a_j, phi_j) or phi_j >= phi_lo
        star_to_j = wolfe_two(dphi_j) and not hi_to_j
        hi_to_lo = dphi_j * (a_hi - a_lo) >= 0 and not hi_to_j and not star_to_j
        lo_to_j = not hi_to_j and not star_to_j
        if hi_to_j:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = a_j, phi_j, dphi_j, a_hi, phi_hi
        if star_to_j:
            done = True
            a_star, phi_star, dphi_star, g_star = a_j, phi_j, dphi_j, g_j
        if hi_to_lo:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = a_lo, phi_lo, dphi_lo, a_hi, phi_hi
        elif lo_to_j:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return failed, a_star, phi_star, dphi_star, g_star, nfev


def _line_search(s, xk, pk, old_fval, old_old_fval, gfk, c1=1e-4, c2=0.9, maxiter=20):
    """Nocedal and Wright's Algorithm 3.5 (strong Wolfe conditions) as JAX
    writes it, from the value ``old_fval`` and gradient ``gfk = (g,
    |g|_inf)`` at ``xk``."""
    c1, c2 = s.scalar(c1), s.scalar(c2)
    phi_0 = old_fval
    dphi_0 = s.scalar((gfk[0] @ pk).item())
    candidate = s.scalar(2.02) * (phi_0 - old_old_fval) / dphi_0
    start_value = s.scalar(1.0) if candidate > 1 else candidate

    def along(t):
        return s.along(xk, pk, t)

    def wolfe_one(a_i, phi_i):
        return bool(phi_i > phi_0 + c1 * a_i * dphi_0)

    def wolfe_two(dphi_i):
        return bool(abs(dphi_i) <= -c2 * dphi_0)

    done = failed = False
    i, nfev = 1, 0
    a_i1, phi_i1, dphi_i1 = s.scalar(0.0), phi_0, dphi_0
    a_star, phi_star, g_star = s.scalar(0.0), phi_0, gfk
    while not done and i <= maxiter and not failed:
        a_i = start_value if i == 1 else a_i1 * s.scalar(2.0)
        phi_i, dphi_i, g_i = along(a_i)
        nfev += 1
        star_to_zoom1 = wolfe_one(a_i, phi_i) or (bool(phi_i >= phi_i1) and i > 1)
        star_to_i = wolfe_two(dphi_i) and not star_to_zoom1
        star_to_zoom2 = bool(dphi_i >= 0) and not star_to_zoom1 and not star_to_i
        if star_to_zoom1:
            zoom = _zoom(s, along, wolfe_one, wolfe_two, a_i1, phi_i1, dphi_i1, a_i, phi_i,
                         dphi_i, gfk)
        elif star_to_zoom2:
            zoom = _zoom(s, along, wolfe_one, wolfe_two, a_i, phi_i, dphi_i, a_i1, phi_i1,
                         dphi_i1, gfk)
        if star_to_zoom1 or star_to_zoom2:
            z_failed, a_star, phi_star, _, g_star, z_nfev = zoom
            nfev += z_nfev
            done, failed = True, failed or z_failed
        elif star_to_i:
            done = True
            a_star, phi_star, g_star = a_i, phi_i, g_i
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    status = 1 if failed else (3 if i > maxiter else 0)
    # a floor on the step size below 64 bits, as JAX has
    if s.np.itemsize < 8 and abs(a_star) < 1e-8:
        a_star = np.sign(a_star) * s.scalar(1e-8)
    return _LineSearchResults(failed or not done, i - 1, nfev, nfev, i, a_star, phi_star, g_star,
                              status)


def minimize_bfgs(fun, x0, maxiter=None, gtol=1e-5, line_search_maxiter=10):
    """BFGS from ``x0`` (a 1-d tensor) on ``fun`` (a tensor to a 0-d
    tensor); returns ``BFGSResults`` with ``f_k`` a 0-d tensor on ``x0``'s
    device.  It ends where the inf-norm of the gradient is below ``gtol``
    (JAX's default norm)."""
    if maxiter is None:
        maxiter = x0.numel() * 200
    s = _Objective(fun, x0.dtype)
    with np.errstate(all="ignore"):
        return _bfgs(s, x0, maxiter, gtol, line_search_maxiter)


def _bfgs(s, x0, maxiter, gtol, line_search_maxiter):
    d = x0.shape[0]
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    f_k, g, g_inf, g_two = s.at(x0)
    g_k = (g, g_inf)
    converged = bool(g_inf < gtol)
    failed = False
    k, nfev, ls_status = 0, 1, 0
    x_k, H_k = x0, eye
    old_old_fval = f_k + g_two / s.scalar(2.0)
    while not converged and not failed and k < maxiter:
        p_k = -(H_k @ g_k[0])
        ls = _line_search(s, x_k, p_k, f_k, old_old_fval, g_k, maxiter=line_search_maxiter)
        nfev += ls.nfev
        failed, ls_status = ls.failed, ls.status
        s_k = float(ls.a_k) * p_k
        y_k = ls.g_k[0] - g_k[0]
        rho_k = 1.0 / (y_k @ s_k)
        w = eye - rho_k * (s_k[:, None] * y_k[None, :])
        H_kp1 = w @ H_k @ w.T + rho_k * (s_k[:, None] * s_k[None, :])
        H_k = torch.where(torch.isfinite(rho_k), H_kp1, H_k)
        converged = bool(ls.g_k[1] < gtol)
        k += 1
        x_k = x_k + s_k
        old_old_fval, f_k, g_k = f_k, ls.f_k, ls.g_k
    if converged:
        status = 0
    elif k == maxiter:
        status = 1
    elif failed:
        status = 2 + ls_status
    else:
        status = -1
    f = torch.tensor(f_k, dtype=x0.dtype, device=x0.device)
    return BFGSResults(converged, failed, k, nfev, nfev, 0, x_k, f, g_k[0], H_k, old_old_fval,
                       status, ls_status)


def minimize(fun, x0, args=(), *, method, tol=None, options=None):
    """``fun(x, *args)`` minimized from ``x0`` (1-d) by ``method="BFGS"``,
    the only method; ``options`` go to :func:`minimize_bfgs`, and ``tol``
    is ignored, as JAX ignores it."""
    if method.lower() != "bfgs":
        raise NotImplementedError(f"minimize method {method!r} is not ported; use 'BFGS'")
    if not isinstance(args, tuple):
        raise TypeError(f"args argument to minimize must be a tuple, got {args}")
    res = minimize_bfgs(lambda x: fun(x, *args), x0, **(options or {}))
    return OptimizeResults(
        x=res.x_k, success=res.converged and not res.failed, status=res.status, fun=res.f_k,
        jac=res.g_k, hess_inv=res.H_k, nfev=res.nfev, njev=res.ngev, nit=res.k,
    )
