"""``numpyro_tpu_torch.compat``, the pyro-api generic interface, against the
JAX package's ``numpyro_tpu.compat``: the counterparts of the JAX package's
``tests/test_compat.py`` (the pyroapi registration skips where ``pyroapi``
is not installed, as there), ``examples/minipyro.py`` through both packages
(its ``Delta`` guide draws nothing, so ``loc_q`` after each of the 400 steps
agrees to rtol 1e-5), ``ops.randn`` after ``set_rng_seed`` (equal), and the
compat ``SVI`` on the card by default.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import chip_smoke as cs
from numpyro_tpu.compat import distributions as jdist
from numpyro_tpu.compat import infer as jinfer
from numpyro_tpu.compat import ops as jops
from numpyro_tpu.compat import optim as joptim
from numpyro_tpu.compat import pyro as jpyro
import numpyro_tpu.util as jutil
from numpyro_tpu_torch.compat import distributions as dist
from numpyro_tpu_torch.compat import handlers, infer, ops, optim, pyro
from numpyro_tpu_torch.compat.util import UnsupportedAPIWarning
from numpyro_tpu_torch.util import set_rng_seed

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings(
    "ignore::numpyro_tpu_torch.compat.util.UnsupportedAPIWarning"
)


def test_ops_torch_conventions():
    assert ops.ones(2, 3).shape == (2, 3)
    assert ops.ones((2, 3)).shape == (2, 3)
    assert ops.zeros(4).shape == (4,)
    for fn, jfn in ((ops.ones, jops.ones), (ops.zeros, jops.zeros)):
        np.testing.assert_array_equal(fn(2, 3).numpy(), np.asarray(jfn(2, 3)))
    np.testing.assert_allclose(ops.tensor([1.0, 2.0]).numpy(), np.asarray(jops.tensor([1.0, 2.0])))
    assert ops.tensor(np.array([1.0, 2.0])).dtype == torch.float32  # as jnp.array without x64
    assert ops.tensor(np.array([1.0]), dtype=torch.float64).dtype == torch.float64
    for module in (ops, jops):
        with pytest.raises(ValueError):
            module.ones()
        with pytest.raises(ValueError):
            module.zeros(2.5)
    # the rest of torch's namespace stands where the JAX package has jax.numpy's
    assert ops.exp(ops.zeros(2)).tolist() == [1.0, 1.0]


def test_randn_draws_numpy_s_global_generator_as_jax_does():
    set_rng_seed(0)
    got = ops.randn(2, 3)
    jutil.set_rng_seed(0)
    want = jops.randn(2, 3)
    assert got.shape == (2, 3) and got.dtype == torch.get_default_dtype()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, dtype=np.float32))


def test_sample_and_trace():
    def model():
        return pyro.sample("x", dist.Normal(0.0, 1.0))

    with handlers.seed(rng_seed=0):
        x = model()
    assert x.shape == ()

    tr = handlers.trace(handlers.seed(model, 0)).get_trace()
    assert tr["x"]["type"] == "sample"


def test_plate_ok():
    def model():
        with pyro.plate("N", 10):
            return pyro.sample("x", dist.Normal(0.0, 1.0))

    with handlers.seed(rng_seed=0):
        x = model()
    assert x.shape == (10,)


def test_param_store_warns():
    with pytest.warns(UnsupportedAPIWarning):
        store = pyro.get_param_store()
    assert isinstance(store, dict)
    store["kept"] = torch.ones(())
    assert pyro.param("kept") is store["kept"]
    with pytest.raises(NotImplementedError):
        pyro.param("missing", constraint=dist.constraints.positive)
    pyro.clear_param_store()
    assert pyro.param("kept") is None


@pytest.mark.parametrize("elbo_cls", [infer.Trace_ELBO, infer.JitTrace_ELBO])
def test_svi_pyro_style(elbo_cls):
    data = 1.0 + 0.1 * np.random.RandomState(0).randn(50)

    def model(data):
        mu = pyro.sample("mu", dist.Normal(0.0, 10.0))
        with pyro.plate("N", len(data)):
            pyro.sample("obs", dist.Normal(mu, 0.1), obs=ops.tensor(data))

    def guide(data):
        loc = pyro.param("loc", ops.tensor(0.0))
        pyro.sample("mu", dist.Normal(loc, 0.05))

    svi = infer.SVI(model, guide, optim.Adam({"lr": 0.05}), elbo_cls(), device="cpu")
    with pytest.raises(ValueError, match="rng_key"):
        svi.step(data)
    losses = [svi.step(data, rng_key=0 if i == 0 else None) for i in range(200)]
    assert float(losses[-1]) < float(losses[0])
    assert abs(float(svi.get_params()["loc"]) - 1.0) < 0.1
    assert torch.isfinite(svi.evaluate_loss(data))


def test_evaluate_loss_works_where_the_jax_compat_raises():
    """The JAX package's compat ``SVI.get_params()`` takes no state, so its
    ``evaluate_loss`` (``SVI.evaluate`` calls ``get_params(state)``) raises
    ``TypeError``; the port's takes an optional state and gives the loss."""
    data = np.array([0.5, 1.5])

    def model(data, pyro, dist, tensor):
        mu = pyro.sample("mu", dist.Normal(0.0, 1.0))
        with pyro.plate("N", 2):
            pyro.sample("obs", dist.Normal(mu, 1.0), obs=tensor(data))

    def guide(data, pyro, dist, tensor):
        pyro.sample("mu", dist.Delta(pyro.param("loc", tensor(0.25))))

    args = (data, jpyro, jdist, jnp.asarray)
    jsvi = jinfer.SVI(model, guide, joptim.SGD({"lr": 0.1}), jinfer.Trace_ELBO())
    jsvi.step(*args, rng_key=random.PRNGKey(0))
    with pytest.raises(TypeError):
        jsvi.evaluate_loss(*args)
    svi = infer.SVI(model, guide, optim.SGD({"lr": 0.1}), infer.Trace_ELBO(), device="cpu")
    targs = (data, pyro, dist, ops.tensor)
    svi.step(*targs, rng_key=0)
    loc = float(svi.get_params()["loc"])
    want = -(np.log(1 / np.sqrt(2 * np.pi)) * 3 - 0.5 * (loc ** 2 + ((data - loc) ** 2).sum()))
    np.testing.assert_allclose(svi.evaluate_loss(*targs).item(), want, rtol=1e-6)
    np.testing.assert_allclose(loc, float(jsvi.get_params()["loc"]), rtol=1e-6)


def test_mcmc_pyro_style(capsys):
    def model(data):
        mu = pyro.sample("mu", dist.Normal(0.0, 10.0))
        with pyro.plate("N", len(data)):
            pyro.sample("obs", dist.Normal(mu, 1.0), obs=data)

    data = 2.0 + np.random.RandomState(1).randn(100)
    kernel = infer.NUTS(model)
    mcmc = infer.MCMC(kernel, num_samples=300, warmup_steps=300, disable_progbar=True,
                      device="cpu")
    mcmc.run(0, ops.tensor(data))
    mu = mcmc.get_samples()["mu"].numpy()
    assert mu.shape == (300,)
    assert abs(mu.mean() - data.mean()) < 0.3
    mcmc.summary()
    assert "mu" in capsys.readouterr().out
    with pytest.raises(ValueError, match="subsetting"):
        mcmc.get_samples(num_samples=10)


def test_hmc_full_mass_alias():
    k = infer.HMC(model=lambda: pyro.sample("x", dist.Normal(0, 1)), full_mass=True,
                  jit_compile=True)
    assert k._dense_mass is True
    jk = jinfer.HMC(model=lambda: jpyro.sample("x", jdist.Normal(0, 1)), full_mass=True)
    assert jk._dense_mass is True
    assert infer.NUTS(model=lambda: None, trajectory_length=1.0)._dense_mass is False


def test_pyroapi_registration():
    pytest.importorskip("pyroapi")
    from pyroapi import pyro_backend

    with pyro_backend("numpyro_tpu_torch"):
        import pyroapi as api

        with handlers.seed(rng_seed=0):
            x = api.pyro.sample("x", api.distributions.Normal(0.0, 1.0))
        assert x.shape == ()


def _jax_minipyro_trajectory(steps):
    """``examples/minipyro.py``'s model and guide through the JAX package's
    compat (the example's ``main``, step by step); ``loc_q`` after each step."""
    data = jnp.asarray(cs.minipyro_data())

    def model(data):
        loc = jpyro.sample("loc", jdist.Normal(0.0, 1.0))
        with jpyro.plate("N", data.shape[0]):
            jpyro.sample("obs", jdist.Normal(loc, 1.0), obs=data)

    def guide(data):
        loc_q = jpyro.param("loc_q", jnp.asarray(0.0))
        jpyro.sample("loc", jdist.Delta(loc_q))

    svi = jinfer.SVI(model, guide, joptim.Adam({"lr": 0.05}), jinfer.Trace_ELBO())
    svi.update = jax.jit(svi.update)
    locs = []
    for i in range(steps):
        svi.step(data, rng_key=random.PRNGKey(0) if i == 0 else None)
        locs.append(float(svi.get_params()["loc_q"]))
    return np.array(locs), float(data.mean())


def test_minipyro_trajectory_matches_jax():
    steps = 400  # the example's own length
    want, mean = _jax_minipyro_trajectory(steps)
    _, got, data = cs.minipyro_trajectory(torch.device("cpu"), steps=steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the example's gate, and the smoke run's shorter length holds it too
    assert abs(got[-1].item() - data.mean().item()) < cs.MINIPYRO_GATE
    assert abs(got[cs.MINIPYRO_STEPS - 1].item() - mean) < cs.MINIPYRO_GATE


def test_compat_svi_runs_on_the_card_by_default(monkeypatch):
    """Runs everywhere: the default device is the card, and without one the
    first step raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svi = infer.SVI(cs.minipyro_model, cs.minipyro_guide, optim.Adam({"lr": 0.05}),
                    infer.Trace_ELBO())
    assert svi.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svi.step(torch.zeros(3), rng_key=0)
    mcmc = infer.MCMC(infer.NUTS(cs.minipyro_model), num_samples=2)
    assert mcmc._mcmc.device == torch.device("cuda")
