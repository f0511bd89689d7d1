"""The worst relative error of the gamma draw's derivative in the port.

    python3 -m dev.gamma_derivative_accuracy

Run from the root of the repo (CPU only, about a minute).  Prints the worst
relative error of ``distributions.util._gamma_draw_derivative`` (1) against
a Richardson-extrapolated central difference of scipy's float64
``gammaincinv`` (as ``tests/test_torch_gamma_grad.py::_reference``) over 80
shapes from 0.05 to 1e5 and the shapes 20 and 49.9, at 120 quantiles each
from 1e-10 to 1 - 1e-10, and (2) against mpmath's derivative of the
regularized incomplete gamma function (50 digits) at x / a from 0.01 to 20
for shapes from 0.3 to 1e4; then (3) the count of tensor operations one
call makes on 4,096 draws (views not counted), each a launch on the card.
"""

import os
import sys

import mpmath as mp
import numpy as np
import torch
from scipy import special

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from numpyro_tpu_torch.distributions.util import _gamma_draw_derivative  # noqa: E402

VIEWS = {"aten.view", "aten.expand", "aten.unsqueeze", "aten.slice", "aten.select", "aten.t",
         "aten.transpose", "aten.split", "aten.split_with_sizes", "aten.alias",
         "aten._unsafe_view", "aten.detach", "aten.as_strided"}


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += str(func.overloadpacket) not in VIEWS
        return func(*args, **(kwargs or {}))


def reference(a, x, rel=1e-5):
    lower, upper = special.gammainc(a, x), special.gammaincc(a, x)
    above = lower > 0.5

    def inverse(s):
        return np.where(above, special.gammainccinv(s, upper), special.gammaincinv(s, lower))

    h = rel * a
    d1 = (inverse(a + h) - inverse(a - h)) / (2 * h)
    d2 = (inverse(a + 2 * h) - inverse(a - 2 * h)) / (4 * h)
    return (4 * d1 - d2) / 3


def mpmath_reference(a, x):
    a, x = mp.mpf(a), mp.mpf(x)
    if x > a:
        dq = mp.diff(lambda b: mp.gammainc(b, x, mp.inf, regularized=True), a)
    else:
        dq = -mp.diff(lambda b: mp.gammainc(b, 0, x, regularized=True), a)
    return float(dq / mp.exp((a - 1) * mp.log(x) - x - mp.loggamma(a)))


def main():
    shapes = np.concatenate([np.geomspace(0.05, 1e5, 80), [20.0, 49.9]])
    q = np.concatenate([np.geomspace(1e-10, 0.5, 60), 1 - np.geomspace(1e-10, 0.5, 60)])
    worst = (0.0, None)
    for a in shapes:
        x = special.gammaincinv(a, q)
        ref = reference(np.full_like(x, a), x)
        got = _gamma_draw_derivative(torch.full(x.shape, a, dtype=torch.float64),
                                     torch.from_numpy(x)).numpy()
        ok = np.isfinite(ref)
        err = np.abs(got[ok] / ref[ok] - 1)
        if err.max() > worst[0]:
            worst = (err.max(), (a, x[ok][err.argmax()]))
    print(f"against scipy: worst {worst[0]:.3g} at a = {worst[1][0]:.4g}, x = {worst[1][1]:.4g}")
    mp.mp.dps = 50
    worst = (0.0, None)
    for a in (0.3, 3.0, 20.0, 49.0, 50.0, 100.0, 1e3, 1e4):
        for lam in (0.01, 0.1, 0.29, 0.31, 0.5, 2.0, 2.3, 2.4, 3.0, 5.0, 20.0):
            got = _gamma_draw_derivative(torch.tensor([a], dtype=torch.float64),
                                         torch.tensor([lam * a], dtype=torch.float64)).item()
            err = abs(got / mpmath_reference(a, lam * a) - 1)
            if err > worst[0]:
                worst = (err, (a, lam))
    print(f"against mpmath: worst {worst[0]:.3g} at a = {worst[1][0]:.4g}, x / a = {worst[1][1]}")
    a = torch.rand(4096, generator=torch.Generator().manual_seed(0)) * 50 + 0.1
    x = torch._standard_gamma(a, generator=torch.Generator().manual_seed(1))
    with OpCount() as ops:
        _gamma_draw_derivative(a, x)
    print(f"tensor operations in one call: {ops.count}")


if __name__ == "__main__":
    main()
