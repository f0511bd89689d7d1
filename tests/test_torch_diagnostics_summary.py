"""The summary of the port's ``diagnostics`` against the JAX package's on the
same numpy draws: ``hpdi``, ``summary`` (keys and values to 1e-5 relative,
with an atol of 1e-6 of the site's scale for values near zero),
``print_summary`` and ``MCMC.print_summary`` (the same printed text)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from numpyro_tpu import diagnostics as jdiag
from numpyro_tpu.infer import MCMC as JMCMC, NUTS as JNUTS
from numpyro_tpu_torch import diagnostics
from numpyro_tpu_torch.infer import MCMC, NUTS

torch.set_num_threads(1)


def draws(chains, n, event=(), seed=0):
    """Correlated draws, chains shifted apart a little, in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((chains, n) + event).cumsum(1) * 0.3
    x += rng.standard_normal((chains, 1) + event) * 0.5 + 2.0
    return x.astype(np.float32)


def printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue()


@pytest.mark.parametrize("shape", [(200,), (50, 3), (40, 2, 3)])
@pytest.mark.parametrize("prob", [0.9, 0.5])
def test_hpdi_matches_jax(shape, prob):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for axis in range(len(shape)):
        got = diagnostics.hpdi(torch.from_numpy(x), prob=prob, axis=axis)
        np.testing.assert_array_equal(got.numpy(), jdiag.hpdi(x, prob=prob, axis=axis))


@pytest.mark.parametrize("chains,n", [(1, 100), (2, 3), (4, 100)])
def test_summary_matches_jax(chains, n):
    """Scalar and vector sites, 1, 2 and 4 chains, and fewer than 4 draws."""
    x = {"a": draws(chains, n, (3,)), "b": draws(chains, n, (), seed=1)}
    want = jdiag.summary(x)
    got = diagnostics.summary({k: torch.from_numpy(v) for k, v in x.items()})
    assert list(got) == list(want)
    for site in want:
        assert list(got[site]) == list(want[site])
        scale = np.abs(x[site]).max()
        for key, value in want[site].items():
            assert isinstance(got[site][key], np.ndarray)
            assert got[site][key].shape == np.shape(value), (site, key)
            # R-hat is NaN under 4 draws in both
            np.testing.assert_allclose(got[site][key], value, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=f"{site} {key}")
    if n < 4:
        assert np.isnan(got["a"]["r_hat"]).all()


def test_summary_without_chains_and_of_a_list():
    x = draws(1, 100, (3,))[0]
    want = jdiag.summary({"x": x}, prob=0.8, group_by_chain=False)
    got = diagnostics.summary({"x": torch.from_numpy(x)}, prob=0.8, group_by_chain=False)
    assert list(got["x"]) == list(want["x"]) == [
        "mean", "std", "median", "10.0%", "90.0%", "n_eff", "r_hat"]
    for key in want["x"]:
        np.testing.assert_allclose(got["x"][key], want["x"][key], rtol=1e-5, atol=1e-6)
    listed = diagnostics.summary([torch.from_numpy(draws(2, 3))])
    assert list(listed) == ["Param:0"]


@pytest.mark.parametrize("chains,n", [(2, 3), (4, 100)])
def test_print_summary_prints_the_jax_text(chains, n):
    x = {"mu": draws(chains, n), "theta": draws(chains, n, (3,), seed=2),
         "a_long_site_name": draws(chains, n, (3,), seed=3).reshape(chains, n, 3, 1)}
    want = printed(jdiag.print_summary, x)
    got = printed(diagnostics.print_summary, {k: torch.from_numpy(v) for k, v in x.items()})
    assert got == want
    flat = {k: v[0] for k, v in x.items()}
    assert printed(diagnostics.print_summary, {k: torch.from_numpy(v) for k, v in flat.items()},
                   group_by_chain=False) == printed(jdiag.print_summary, flat,
                                                     group_by_chain=False)


def test_mcmc_print_summary_prints_the_jax_text_on_the_same_draws():
    """Both packages' MCMC objects hold the same draws and divergences: the two
    tables and divergence lines must be the same text.  ``_``-prefixed sites
    are left out, deterministic ones (here ``theta``) are in."""
    z = {"mu": draws(2, 3), "theta": draws(2, 3, (3,), seed=2),
         "theta_decentered": draws(2, 3, (3,), seed=3), "_hidden": draws(2, 3, seed=4)}
    div = np.zeros((2, 3), bool)
    div[0, :3] = True
    jm = JMCMC(JNUTS(lambda: None), num_warmup=1, num_samples=3, num_chains=2,
               progress_bar=False)
    jm._states = {"z": z, "diverging": div}
    jm._states_flat = {"z": {k: v.reshape((-1,) + v.shape[2:]) for k, v in z.items()},
                       "diverging": div.reshape(-1)}
    tm = MCMC(NUTS(lambda: None), num_warmup=1, num_samples=3, num_chains=2, device="cpu")
    tz = {k: torch.from_numpy(v) for k, v in z.items()}
    tm._states = {"z": tz, "diverging": torch.from_numpy(div)}
    tm._states_flat = {"z": {k: v.reshape((-1,) + v.shape[2:]) for k, v in tz.items()},
                       "diverging": torch.from_numpy(div.reshape(-1))}
    want = printed(jm.print_summary, exclude_deterministic=False)
    got = printed(tm.print_summary, exclude_deterministic=False)
    assert "_hidden" not in got and "theta[2]" in got and "Number of divergences: 3" in got
    assert got == want
