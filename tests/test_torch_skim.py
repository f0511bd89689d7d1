"""The SKIM sparse regression of ``examples/sparse_regression.py`` (phase
15a of ``chip_smoke.py``) in the port against the JAX package, on the
example's data at full size (N = 100, P = 20, S = 3, seed 0): the NUTS
potential and its gradient at 8 chains, a chain at a point where the
kernel is not positive definite (a non-finite energy there, where the port
used to raise, and finite energies in the other chains), and the singleton
statistics of the post-processing.

Tolerances: the potential to rtol 1e-5 and its gradient to rtol 1e-3,
atol 1e-3: the potential is a sum of 100 log-densities through a float32
Cholesky factor of a 100 x 100 kernel, and its gradient goes through the
factor's derivative, which both packages compute in another order; the
singleton means and variances to rtol 1e-3 (float32 solves)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from numpyro_tpu.infer.util import potential_energy as jpotential_energy
from numpyro_tpu_torch.infer.util import potential_energy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
import sparse_regression as jskim  # noqa: E402
from chip_smoke import SKIM_HYPERS, skim_data, skim_model, skim_singleton_stats  # noqa: E402

torch.set_num_threads(1)

C = 8
SITES = {"sigma": (), "eta1": (), "msq": (), "xisq": (), "lambda": (20,)}


def _points(seed=0):
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal((C,) + shape)).astype(np.float32)
            for k, shape in SITES.items()}


def _energies(points):
    X, Y, _ = skim_data()
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    tX, tY = torch.from_numpy(X), torch.from_numpy(Y)

    def pe_j(p):
        return jpotential_energy(jskim.model, (jX, jY, SKIM_HYPERS), {}, p)

    def pe_t(p):
        return potential_energy(skim_model, (tX, tY, SKIM_HYPERS), {}, p)

    jv, jg = jax.vmap(jax.value_and_grad(pe_j))({k: jnp.asarray(v) for k, v in points.items()})
    tg, tv = torch.func.vmap(torch.func.grad_and_value(pe_t))(
        {k: torch.from_numpy(v) for k, v in points.items()})
    return (np.asarray(jv), {k: np.asarray(v) for k, v in jg.items()}), (
        tv.numpy(), {k: v.numpy() for k, v in tg.items()})


def test_potential_and_gradient_match_jax_at_8_chains():
    (jv, jg), (tv, tg) = _energies(_points())
    assert np.isfinite(jv).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for k in SITES:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-3, atol=1e-3, err_msg=k)


def test_a_chain_at_a_non_positive_definite_kernel_gets_a_nan_energy():
    """At ``eta1 = e^4``, ``msq = e^-4`` (the other sites at 0 in
    unconstrained space) the kernel's entries reach 1e8 and float32 loses its
    positive definiteness.  The JAX package gives NaN there (a divergent
    transition); so does the port, in that chain only."""
    points = _points()
    for k in SITES:
        points[k][3] = 0.0
    points["eta1"][3], points["msq"][3] = 4.0, -4.0
    (jv, jg), (tv, tg) = _energies(points)
    assert np.isnan(jv[3]) and np.isnan(tv[3])
    keep = np.arange(C) != 3
    assert np.isfinite(tv[keep]).all()
    np.testing.assert_allclose(tv[keep], jv[keep], rtol=1e-5)
    # the gradient is NaN there too, in every coordinate, as JAX's is
    for k in SITES:
        assert np.isnan(tg[k][3]).all() and np.isnan(jg[k][3]).all(), k
        np.testing.assert_allclose(tg[k][keep], jg[k][keep], rtol=1e-3, atol=1e-3)


def test_singleton_stats_match_the_example():
    X, Y, _ = skim_data()
    points = _points(1)
    draws = {k: np.exp(v) for k, v in points.items()}
    mu_j, var_j = jax.vmap(lambda s: jskim.singleton_stats(jnp.asarray(X), jnp.asarray(Y),
                                                           SKIM_HYPERS["c"], s))(
        {k: jnp.asarray(v) for k, v in draws.items()})
    mu_t, var_t = skim_singleton_stats(torch.from_numpy(X), torch.from_numpy(Y),
                                       SKIM_HYPERS["c"],
                                       {k: torch.from_numpy(v) for k, v in draws.items()})
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-3, atol=1e-5)


def test_data_is_the_example_s():
    X, Y, W = skim_data()
    jX, jY, jW = jskim.get_data(100, 20, 3)
    np.testing.assert_allclose(X, np.asarray(jX), rtol=1e-6)
    np.testing.assert_allclose(Y, np.asarray(jY), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(W, np.asarray(jW), rtol=1e-6)
