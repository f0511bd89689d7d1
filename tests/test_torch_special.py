"""The special functions that the port writes itself (``betainc``,
``betaincinv``, ``gammainc`` with its derivative in the shape, and
``gammaincinv``, in ``numpyro_tpu_torch/distributions/util.py``) against
scipy in float64 and the JAX package, over a from 0.1 to 100 and x at the
edges of the unit interval, in float32 and float64, with the derivatives
the JAX package gives and a raise for those it does not.

Tolerances: against scipy in float64, 1e-12 relative for float64 inputs and
1e-6 for float32 inputs (the port computes in float64 and rounds once);
against the JAX package in float32, as each test states.
"""

import numpy as np
import pytest
import scipy.special as sp
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import betainc as jbetainc
from jax.scipy.special import gammainc as jgammainc

from numpyro_tpu.distributions import util as jutil
from numpyro_tpu_torch.distributions.util import betainc, betaincinv, gammainc, gammaincinv

torch.set_num_threads(1)

AB = np.array([0.1, 0.5, 1.0, 3.0, 10.0, 100.0])
X = np.array([0.0, 1e-6, 1e-3, 0.1, 0.3, 0.5, 0.7, 0.97, 1.0 - 1e-6, 1.0])


def _grid(dtype):
    a, b, x = np.meshgrid(AB, AB, X, indexing="ij")
    return a.astype(dtype), b.astype(dtype), x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_betainc_matches_scipy(dtype):
    a, b, x = _grid(dtype)
    got = betainc(*(torch.from_numpy(v) for v in (a, b, x)))
    assert got.dtype == torch.from_numpy(x).dtype
    want = sp.betainc(a.astype(np.float64), b.astype(np.float64), x.astype(np.float64))
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-300 if rtol < 1e-9 else 1e-30)
    # the edges are exact
    assert (got[..., 0] == 0).all() and (got[..., -1] == 1).all()


def test_betainc_matches_jax_in_float32():
    """JAX's float32 betainc is within 1e-4 relative of scipy above 1e-30
    (its own error; the port's is 1e-6)."""
    a, b, x = _grid(np.float32)
    got = betainc(*(torch.from_numpy(v) for v in (a, b, x))).numpy()
    want = np.asarray(jbetainc(a, b, x))
    ok = want > 1e-30
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-7)


def test_betainc_outside_its_domain_is_nan():
    got = betainc(torch.tensor([2.0, -1.0, 2.0]), torch.tensor([3.0, 3.0, 3.0]),
                  torch.tensor([1.5, 0.5, -0.1]))
    assert torch.isnan(got).all()


def test_betainc_derivative_in_x_is_the_density_and_a_b_raise():
    a, b = np.float32(2.5), np.float32(0.7)
    x = np.array([1e-3, 0.2, 0.6, 0.99], np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    betainc(torch.tensor(a), torch.tensor(b), xt).sum().backward()
    want = jax.vmap(jax.grad(lambda v: jbetainc(a, b, v)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5)
    # functorch's grad too, under vmap
    g = torch.func.vmap(torch.func.grad(lambda v: betainc(torch.tensor(a), torch.tensor(b), v)))(
        torch.from_numpy(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5)
    for argnum in (0, 1):
        with pytest.raises(ValueError, match="a and b"):
            jax.grad(jbetainc, argnums=argnum)(a, b, 0.4)
        args = [torch.tensor(a), torch.tensor(b), torch.tensor(0.4)]
        args[argnum].requires_grad_()
        with pytest.raises(ValueError, match="a and b"):
            betainc(*args).backward()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gammainc_matches_scipy_and_jax(dtype):
    a = np.array([0.1, 0.5, 1.0, 3.0, 10.0, 100.0], dtype)[:, None]
    x = np.array([0.0, 1e-6, 1e-2, 0.5, 2.0, 9.0, 50.0, 120.0], dtype)[None, :]
    got = gammainc(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, sp.gammainc(a.astype(np.float64), x.astype(np.float64)),
                               rtol=1e-10 if dtype == np.float64 else 1e-6, atol=1e-30)
    if dtype == np.float32:
        # JAX's float32 gammainc is 1e-5 relative off scipy
        np.testing.assert_allclose(got, np.asarray(jgammainc(a, x)), rtol=3e-5, atol=1e-7)


def test_gammainc_derivatives_match_jax():
    """In x to 1e-5; in a to 2e-5: the port's derivative in a is exact to
    float64 rounding (within 5e-8 of a float64 difference quotient here),
    and JAX's float32 one drifts by 1e-5 at a = 50."""
    a = np.array([0.3, 1.0, 2.0, 5.0, 50.0], np.float32)
    x = np.array([0.01, 0.4, 2.5, 5.0, 60.0], np.float32)
    at, xt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(x).requires_grad_()
    gammainc(at, xt).sum().backward()
    ga, gx = jax.vmap(jax.grad(jgammainc, argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), rtol=2e-5)


def test_inverses_match_jax_and_refuse_a_derivative():
    """Bisection on both sides: the port's f64 betainc against JAX's f32 one
    moves the last halvings, so 1e-5 relative (2e-6 absolute)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.3, 20.0, 12).astype(np.float32)
    b = rng.uniform(0.3, 20.0, 12).astype(np.float32)
    y = rng.uniform(1e-3, 1.0 - 1e-3, 12).astype(np.float32)
    got = betaincinv(*(torch.from_numpy(v) for v in (a, b, y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jutil.betaincinv(a, b, y)), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(sp.betainc(a, b, got.numpy().astype(np.float64)), y, rtol=1e-4)
    got = gammaincinv(torch.from_numpy(a), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(jutil.gammaincinv(a, y)), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(sp.gammainc(a, got.numpy().astype(np.float64)), y, rtol=1e-4)
    # the JAX package's bisection gives a silent zero derivative; the port raises
    assert float(jax.grad(lambda v: jutil.gammaincinv(2.0, v))(0.3)) == 0.0
    for fn, args in ((betaincinv, (2.0, 3.0)), (gammaincinv, (2.0,))):
        q = torch.tensor(0.3, requires_grad=True)
        with pytest.raises(NotImplementedError, match="no derivative"):
            fn(*(torch.tensor(v) for v in args), q).backward()
