"""The port's ``contrib.hsgp`` against the JAX package's, on the same numpy
inputs (float32; rtol 1e-6 and atol 1e-6 for the basis, rtol 1e-5 for the
spectral densities and 2e-5 for the Bessel values, and rtol 1e-5, atol 1e-5
of the largest gradient entry for the potentials).

- Every function of ``laplacian`` and ``spectral_densities`` at ``dim`` 1
  and 2, with ``m`` an int and a list, ``ell`` a float and a list, and
  ``alpha`` and ``length`` scalars or batched; the errors they raise.
- The three fragments' traces (sites, plates, shapes) and their potentials
  at 8 points under ``vmap`` over the chains, and ``examples/hsgp_example.py``'s
  model (``chip_smoke.hsgp_model``) at 16 points.
- Two departures, each shown beside the JAX package's value
  (ROADMAP.md, Queue 3): the periodic density at ``length`` 0.1 and 0.05,
  where the JAX package gives NaN and the port ``I_j(a) e^{-a}`` within
  1e-5 of scipy's float64 ``ive``; and the squared-exponential fragment's
  gradient where its density underflows, NaN in the JAX package and in the
  port within 1e-4 of the port's own float64 gradient.
"""

import math
import os
import sys

import numpy as np
import pytest
import scipy.special
import torch

import jax
import jax.numpy as jnp

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.contrib import hsgp as jhsgp
from numpyro_tpu.contrib.hsgp import laplacian as jlap
from numpyro_tpu.contrib.hsgp import spectral_densities as jsd
from numpyro_tpu.infer import util as jutil

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib import hsgp
from numpyro_tpu_torch.contrib.hsgp import laplacian as lap
from numpyro_tpu_torch.contrib.hsgp import spectral_densities as sd
from numpyro_tpu_torch.infer import util

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from examples.hsgp_example import model as jax_example  # noqa: E402

torch.set_num_threads(1)

CASES = [(1, 6, 1.3), (1, [6], [1.3]), (2, 4, 1.2), (2, [3, 5], [1.1, 1.6])]
CENTRED_M = 8


def _close(got, want, rtol=1e-6, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _x(dim, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    shape = lead + ((7,) if dim == 1 and not lead else (7, dim))
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("dim, m, ell", CASES)
def test_laplacian_matches_jax(dim, m, ell):
    assert np.array_equal(lap.eigenindices(m, dim).numpy(), np.asarray(jlap.eigenindices(m, dim)))
    _close(lap.sqrt_eigenvalues(ell, m, dim), jlap.sqrt_eigenvalues(ell, m, dim))
    leads = [()] if dim == 1 else [(), (3,)]
    for lead in leads:
        x = _x(dim, lead)
        got = lap.eigenfunctions(torch.from_numpy(x), ell, m)
        want = jlap.eigenfunctions(jnp.asarray(x), ell, m)
        assert tuple(got.shape) == want.shape
        _close(got, want, msg=f"eigenfunctions {lead}")


def test_eigenindices_of_three_dims_match_jax():
    assert np.array_equal(lap.eigenindices([2, 2, 3], 3).numpy(),
                          np.asarray(jlap.eigenindices([2, 2, 3], 3)))


@pytest.mark.parametrize("w0", [math.pi, 2 * math.pi / 3.0])
def test_periodic_eigenfunctions_match_jax(w0):
    x = np.random.default_rng(1).uniform(0, 4, 9).astype(np.float32)
    got = lap.eigenfunctions_periodic(torch.from_numpy(x), w0, 5)
    want = jlap.eigenfunctions_periodic(jnp.asarray(x), w0, 5)
    for g, w in zip(got, want):
        _close(g, w)


def test_errors_match_jax():
    for mod in (lap, jlap):
        with pytest.raises(ValueError, match="length of ell"):
            mod.sqrt_eigenvalues([1.0, 2.0], 3, 1)
        with pytest.raises(ValueError, match="length of m"):
            mod.eigenindices([2, 3], 1)
    with pytest.raises(ValueError, match="scalar or a list"):
        lap.sqrt_eigenvalues(torch.ones(3), 3, 2)
    with pytest.raises(ValueError, match="scalar or a list"):
        jlap.sqrt_eigenvalues(jnp.ones(3), 3, 2)
    with pytest.raises(ValueError, match="Multidimensional"):
        lap.eigenfunctions_periodic(torch.zeros(4, 2), 1.0, 3)
    with pytest.raises(ValueError, match="Multidimensional"):
        jlap.eigenfunctions_periodic(jnp.zeros((4, 2)), 1.0, 3)


def _params(dim, batched):
    if not batched:
        return 1.3, 0.4
    length = np.float32([0.4, 0.3]) if dim == 1 else np.float32([[0.4, 0.2], [0.3, 0.5]])
    return np.float32([1.3, 0.5]), length


def _pair(v):
    if isinstance(v, float):
        return v, v
    return torch.from_numpy(v), jnp.asarray(v)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dim, m, ell", CASES)
def test_diag_spectral_densities_match_jax(dim, m, ell, batched):
    (a_t, a_j), (l_t, l_j) = (_pair(v) for v in _params(dim, batched))
    got = sd.diag_spectral_density_squared_exponential(a_t, l_t, ell, m, dim)
    want = jsd.diag_spectral_density_squared_exponential(a_j, l_j, ell, m, dim)
    assert tuple(got.shape) == want.shape
    _close(got, want, rtol=1e-5, atol=0, msg="squared exponential")
    for nu in (0.5, 1.5, 2.5):
        got = sd.diag_spectral_density_matern(nu, a_t, l_t, ell, m, dim)
        want = jsd.diag_spectral_density_matern(nu, a_j, l_j, ell, m, dim)
        assert tuple(got.shape) == want.shape
        _close(got, want, rtol=1e-5, atol=0, msg=f"matern {nu}")


@pytest.mark.parametrize("dim", [1, 2])
def test_spectral_densities_at_given_frequencies_match_jax(dim):
    w = np.random.default_rng(2).uniform(0, 3, (dim,)).astype(np.float32)
    for length in (0.7, np.float32([0.7, 0.4])[:dim]):
        (l_t, l_j) = _pair(length)
        _close(sd.align_param(dim, l_t), jsd.align_param(dim, l_j))
        _close(sd.spectral_density_squared_exponential(dim, torch.from_numpy(w), 1.2, l_t),
               jsd.spectral_density_squared_exponential(dim, jnp.asarray(w), 1.2, l_j),
               rtol=1e-5, atol=0)
        _close(sd.spectral_density_matern(dim, 1.5, torch.from_numpy(w), 1.2, l_t),
               jsd.spectral_density_matern(dim, 1.5, jnp.asarray(w), 1.2, l_j), rtol=1e-5, atol=0)
    # a tensor nu takes the gamma function through lgamma
    nu = np.float32(2.5)
    _close(sd.spectral_density_matern(dim, torch.tensor(nu), torch.from_numpy(w), 1.2, 0.7),
           jsd.spectral_density_matern(dim, jnp.asarray(nu), jnp.asarray(w), 1.2, 0.7),
           rtol=1e-5, atol=0)


@pytest.mark.parametrize("z", [0.7, np.float32([0.3, 2.0, 11.0])])
def test_modified_bessel_first_kind_matches_jax(z):
    v = np.arange(4) if np.ndim(z) == 0 else np.array([2])
    z_t, z_j = (torch.tensor(z), jnp.asarray(z)) if np.ndim(z) else (z, z)
    got = sd.modified_bessel_first_kind(v, z_t)
    want = jsd.modified_bessel_first_kind(v, z_j)
    assert tuple(got.shape) == want.shape
    _close(got, want, rtol=2e-5, atol=0)


@pytest.mark.parametrize("length", [2.0, 0.5, 0.2, 0.12])
def test_periodic_density_matches_jax_where_jax_is_finite(length):
    """rtol 1e-5 beside an atol of 1e-6 of the largest coefficient: at a long
    length the high orders are tiny, and the quadrature's float32 sums
    cancel there in both packages."""
    got = sd.diag_spectral_density_periodic(1.2, torch.tensor(length), 6)
    want = np.asarray(jsd.diag_spectral_density_periodic(1.2, jnp.float32(length), 6))
    assert np.isfinite(want).all()
    _close(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("length", [0.1, 0.05])
def test_periodic_density_at_a_short_length_departs_from_jax(length):
    """``exp(log I_j(a) - a)`` in one step, where the JAX package's
    ``exp(log I_j(a)) / exp(a)`` overflows float32 (``a = length**-2``)."""
    want = np.asarray(jsd.diag_spectral_density_periodic(1.2, jnp.float32(length), 6))
    assert np.isnan(want).all()
    got = sd.diag_spectral_density_periodic(1.2, torch.tensor(length), 6).numpy()
    a = np.float32(length) ** -2.0
    exact = np.array([(1.0 if j == 0 else 2.0) * 1.44 * scipy.special.ive(j, float(a))
                      for j in range(6)])
    assert np.isfinite(got).all()
    _close(got, exact, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the fragments inside models


def _jax_fragment_model(fragment):
    def model(x, y=None):
        amp = numpyro_tpu.sample("amp", jdist.HalfNormal(1.0))
        length = numpyro_tpu.sample("length", jdist.LogNormal(-1.0, 1.0))
        noise = numpyro_tpu.sample("noise", jdist.HalfNormal(0.5))
        f = fragment(x, amp, length)
        with numpyro_tpu.plate("N", x.shape[0]):
            numpyro_tpu.sample("y", jdist.Normal(f, noise), obs=y)

    return model


JAX_FRAGMENTS = {
    "matern 1.5": _jax_fragment_model(lambda x, a, l: jhsgp.hsgp_matern(
        x, nu=1.5, alpha=a, length=l, ell=cs.HSGP_ELL, m=cs.HSGP_M)),
    "matern 2.5": _jax_fragment_model(lambda x, a, l: jhsgp.hsgp_matern(
        x, nu=2.5, alpha=a, length=l, ell=cs.HSGP_ELL, m=cs.HSGP_M)),
    "periodic": _jax_fragment_model(lambda x, a, l: jhsgp.hsgp_periodic_non_centered(
        x, alpha=a, length=l, w0=cs.PERIODIC_W0, m=cs.PERIODIC_M)),
    # the centred form at a basis of 8, where no prior scale of beta is tiny
    "centred": _jax_fragment_model(lambda x, a, l: jhsgp.hsgp_squared_exponential(
        x, alpha=a, length=l, ell=cs.HSGP_ELL, m=CENTRED_M, non_centered=False)),
}
FRAGMENTS = dict(cs.FRAGMENTS, centred=cs._fragment_model(
    lambda x, a, l: hsgp.hsgp_squared_exponential(x, alpha=a, length=l, ell=cs.HSGP_ELL,
                                                  m=CENTRED_M, non_centered=False)))


def _data(dtype=np.float32):
    x, y = cs.hsgp_data()
    return x.astype(dtype), y.astype(dtype)


def _frames(site):
    return [(f.name, f.size) for f in site["cond_indep_stack"]]


@pytest.mark.parametrize("name", list(JAX_FRAGMENTS))
def test_fragment_traces_match_jax(name):
    x, y = _data()
    params = {"amp": np.float32(0.8), "length": np.float32(0.3), "noise": np.float32(0.2)}
    jtr = jhandlers.trace(jhandlers.substitute(jhandlers.seed(JAX_FRAGMENTS[name], 0),
                                               data=params)).get_trace(jnp.asarray(x),
                                                                       jnp.asarray(y))
    ttr = handlers.trace(handlers.substitute(handlers.seed(FRAGMENTS[name], 0), data={
        k: torch.tensor(v) for k, v in params.items()})).get_trace(torch.from_numpy(x),
                                                                    torch.from_numpy(y))
    assert list(jtr) == list(ttr)
    for k in jtr:
        assert jtr[k]["type"] == ttr[k]["type"], k
        if jtr[k]["type"] == "sample":
            assert _frames(jtr[k]) == _frames(ttr[k]), k
            assert np.shape(jtr[k]["value"]) == tuple(np.shape(ttr[k]["value"])), k
            assert jtr[k]["is_observed"] == ttr[k]["is_observed"], k
        elif jtr[k]["type"] == "plate":
            assert jtr[k]["args"][0] == ttr[k]["args"][0], k


def _potentials(model_t, model_j, z, dtype=np.float32):
    x, y = _data(dtype)
    info = util.initialize_model(torch.Generator().manual_seed(0), model_t,
                                 num_chains=next(iter(z.values())).shape[0],
                                 model_args=(torch.from_numpy(x), torch.from_numpy(y)))
    tpe, tg = util.batched_value_and_grad(info.potential_fn)(
        {k: torch.from_numpy(v.astype(dtype)) for k, v in z.items()})
    if model_j is None:
        return (tpe.numpy(), {k: v.numpy() for k, v in tg.items()}), None
    jargs = (jnp.asarray(x), jnp.asarray(y))
    jpe, jg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: jutil.potential_energy(model_j, jargs, {}, p))))(
        {k: jnp.asarray(v) for k, v in z.items()})
    return (tpe.numpy(), {k: v.numpy() for k, v in tg.items()}), (
        np.asarray(jpe), {k: np.asarray(v) for k, v in jg.items()})


def _points(n, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    z = {k: rng.normal(0.0, scale, (n,)).astype(np.float32) for k in ("amp", "noise")}
    z["length"] = rng.normal(-1.2, 0.3, (n,)).astype(np.float32)
    return z


def _close_grad(tg, jg, rows=slice(None)):
    assert set(tg) == set(jg)
    for k in jg:
        g = jg[k][rows]
        _close(tg[k][rows], g, rtol=1e-5, atol=1e-5 * np.abs(g).max(), msg=k)


@pytest.mark.parametrize("name", list(JAX_FRAGMENTS))
def test_fragment_potentials_match_jax_under_vmap(name):
    z = _points(8, 3)
    size = {"periodic": cs.PERIODIC_M, "centred": CENTRED_M}.get(name, cs.HSGP_M)
    z["beta_cos" if name == "periodic" else "beta"] = np.random.default_rng(4).normal(
        0, 1, (8, size)).astype(np.float32)
    if name == "periodic":
        z["beta_sin"] = np.random.default_rng(5).normal(
            0, 1, (8, cs.PERIODIC_M - 1)).astype(np.float32)
    (tpe, tg), (jpe, jg) = _potentials(FRAGMENTS[name], JAX_FRAGMENTS[name], z)
    assert np.isfinite(jpe).all()
    _close(tpe, jpe, rtol=1e-5, atol=0)
    _close_grad(tg, jg)


@pytest.fixture(scope="module")
def example_points():
    """16 points of ``hsgp_example.py``'s model, the last four with
    ``length`` past the squared-exponential density's underflow (0.68 at
    m = 20, ell = 1.5)."""
    z = _points(16, 6)
    z["length"][-4:] = np.log(np.float32([0.8, 1.2, 2.0, 3.5]))
    z["beta"] = np.random.default_rng(7).normal(0, 1, (16, cs.HSGP_M)).astype(np.float32)
    return z


def test_hsgp_example_potential_matches_jax(example_points):
    (tpe, tg), (jpe, jg) = _potentials(cs.hsgp_model, jax_example, example_points)
    _close(tpe, jpe, rtol=1e-5, atol=0)
    _close_grad(tg, jg, rows=slice(0, 12))


def test_squared_exponential_gradient_where_the_density_underflows_departs_from_jax(
        example_points):
    """Where the density underflows to 0 in float32, JAX's ``jnp.sqrt`` gives
    a NaN gradient in ``amp`` and ``length``; the port's is finite and
    within 1e-4 of its own float64 gradient, where nothing underflows."""
    (tpe, tg), (jpe, jg) = _potentials(cs.hsgp_model, jax_example, example_points)
    assert np.isnan(jg["length"][12:]).all() and np.isnan(jg["amp"][12:]).all()
    assert np.isfinite(jg["length"][:12]).all()
    (pe64, g64), _ = _potentials(cs.hsgp_model, None, example_points, dtype=np.float64)
    for k in tg:
        assert np.isfinite(tg[k]).all(), k
        _close(tg[k], g64[k], rtol=1e-4, atol=1e-4 * np.abs(g64[k]).max(), msg=k)
    _close(tpe, pe64, rtol=1e-5, atol=0)
