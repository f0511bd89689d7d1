"""``examples/stein_bnn.py`` in the port against the JAX package, at the
example's widths: 60 points, a hidden layer of 8, 8 Stein particles, 2
ELBO draws, ``AutoNormal``, ``Adagrad(0.5)``, ``RBFKernel()``.

- The model's log density at the same latents (rtol 1e-5).
- Three ``SteinVI`` steps from JAX's initial particles on JAX's guide
  draws: each step's loss (rtol 1e-5) and the particles after the three
  (rtol 1e-4, atol 1e-5: three Adagrad(0.5) steps carry each step's
  float32 rounding on).
- ``MixtureGuidePredictive`` at the particles after those steps on JAX's
  assignments and guide draws: the latents (rtol 1e-5) and the mean
  function under each draw; the predicted ``y``, drawn on the port's
  generator, held to its law.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu.contrib.einstein as jein
import numpyro_tpu.optim as joptim
from examples.stein_bnn import model as jmodel
from numpyro_tpu.infer.autoguide import AutoNormal as JAutoNormal
from numpyro_tpu.infer.util import log_density as jlog_density
import numpyro_tpu_torch.contrib.einstein as ein
import numpyro_tpu_torch.optim as optim
from numpyro_tpu_torch.infer.autoguide import AutoNormal
from numpyro_tpu_torch.infer.util import log_density
from test_torch_einstein import cs, guide_noise, port_state, step_noise, table_draws, to_torch

torch.set_num_threads(1)

NUM_DATA, HIDDEN, PARTICLES, ELBO_DRAWS, STEPS = 60, 8, 8, 2, 3
# the example's model and data as phase 21b of chip_smoke.py runs them


tmodel = cs.stein_bnn_model
X, Y = cs.stein_bnn_data()
JARGS, TARGS = (jnp.asarray(X), jnp.asarray(Y)), (torch.tensor(X), torch.tensor(Y))


def test_model_log_density_matches_jax():
    rng = np.random.default_rng(0)
    latents = {"w1": rng.standard_normal((1, HIDDEN)), "b1": rng.standard_normal(HIDDEN),
               "w2": rng.standard_normal(HIDDEN), "prec": np.array(3.0)}
    latents = {k: np.asarray(v, np.float32) for k, v in latents.items()}
    want, _ = jlog_density(jmodel, JARGS, {}, {k: jnp.asarray(v) for k, v in latents.items()})
    got, _ = log_density(tmodel, TARGS, {}, to_torch(latents))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.fixture(scope="module")
def three_steps():
    """Both packages' SteinVI from JAX's initial particles through three
    steps on JAX's draws; the JAX objects, states and losses."""
    js = jein.SteinVI(jmodel, JAutoNormal(jmodel), joptim.Adagrad(0.5), jein.RBFKernel(),
                      num_stein_particles=PARTICLES, num_elbo_particles=ELBO_DRAWS)
    ts = ein.SteinVI(tmodel, AutoNormal(tmodel), optim.Adagrad(0.5), ein.RBFKernel(),
                     num_stein_particles=PARTICLES, num_elbo_particles=ELBO_DRAWS, device="cpu")
    jstate = js.init(random.PRNGKey(0), *JARGS)
    ts.init(0, *TARGS)
    tstate = port_state(ts, js.optim.get_params(jstate.optim_state))
    jupdate = jax.jit(js.update)
    jlosses, tlosses = [], []
    for _ in range(STEPS):
        noise = step_noise(js, jstate, JARGS)
        tstate, tl = ts.update(tstate._replace(rng_key=table_draws(noise)), *TARGS)
        jstate, jl = jupdate(jstate, *JARGS)
        jlosses.append(float(jl))
        tlosses.append(tl.item())
    return js, ts, jstate, tstate, jlosses, tlosses


def test_three_steps_match_jax_on_jax_draws(three_steps):
    js, ts, jstate, tstate, jlosses, tlosses = three_steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    jp, tp = js.get_params(jstate), ts.get_params(tstate)
    assert set(tp) == {f"auto_{s}_{p}" for s in ("w1", "b1", "w2", "prec")
                       for p in ("loc", "scale")}
    for k in jp:
        assert tp[k].shape[0] == PARTICLES
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_mixture_predictive_matches_jax_on_jax_draws(three_steps):
    js, ts, jstate, _, _, _ = three_steps
    params = js.get_params(jstate)
    num = 50
    sites = ["w1", "b1", "w2", "prec", "y"]
    key = random.PRNGKey(1)
    want = jein.MixtureGuidePredictive(jmodel, js.guide, params, set(params), num_samples=num,
                                       return_sites=sites)(key, JARGS[0])
    guide_key, assign_key, _ = random.split(key, 3)
    assigns = random.randint(assign_key, (num,), minval=0, maxval=PARTICLES)
    draws = [guide_noise(js.guide, {k: v[a] for k, v in params.items()}, k, (JARGS[0],))
             for k, a in zip(random.split(guide_key, num), assigns)]
    noise = [np.stack([d[s] for d in draws]) for s in range(len(draws[0]))]
    got = ein.MixtureGuidePredictive(tmodel, ts.guide, to_torch(params), set(params),
                                     num_samples=num, return_sites=sites, device="cpu")(
        table_draws(noise, ints=[np.asarray(assigns)]), TARGS[0])
    np.testing.assert_array_equal(got["mixture_assignments"].numpy(), np.asarray(assigns))
    for k in ("w1", "b1", "w2", "prec"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    mean = torch.tanh(TARGS[0] @ got["w1"] + got["b1"][:, None]) @ got["w2"][:, :, None]
    z = ((got["y"] - mean[..., 0]) * got["prec"].sqrt()[:, None]).numpy()
    assert got["y"].shape == (num, NUM_DATA)
    assert abs(z.mean()) < 0.1 and abs(z.std() - 1) < 0.06
