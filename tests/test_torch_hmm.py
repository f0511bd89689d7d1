"""The HMM of ``examples/hmm_enum.py`` (BASELINE config 5) in the port
(``chip_smoke.hmm_model`` and ``hmm_scan_model``) against the example's own
models in the JAX package: ``Dirichlet`` and ``StickBreakingTransform``; the
enumerated potential and its gradient of both forms (the ``markov`` loop and
``scan``) at 8 unconstrained points; ``TraceEnum_ELBO`` under ``AutoNormal``
on JAX's own draws; NUTS through the fused run, the per-step API and a
short whole run compared by moments; ``Predictive(infer_discrete=True)``.

Tolerances: ``log_prob``, transforms and Jacobians to ``rtol=1e-6``;
potentials and losses to ``rtol=1e-5``, gradients to ``atol=1e-5 max|g|``
(float32 sums in another order); whole runs within 4 Monte-Carlo standard
errors of each mean and std (``chip_smoke.mc_moments``, from each run's
ESS).
"""

import importlib.util
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu.contrib.enum as jenum
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
from numpyro_tpu.distributions import transforms as jtransforms
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.contrib.enum as tenum
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions import constraints, transforms
from numpyro_tpu_torch.infer import MCMC, NUTS, Predictive, TraceEnum_ELBO, util

from test_torch_svi import _both_svis, _guide_seeds, fed_noise, jax_noise

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import hmm_data, hmm_model, hmm_scan_model, mc_moments  # noqa: E402

# the example's own models, loaded from its file (the examples are no package)
_spec = importlib.util.spec_from_file_location("hmm_enum", ROOT / "examples" / "hmm_enum.py")
hmm_enum = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(hmm_enum)

torch.set_num_threads(1)
RTOL = 1e-5

MODELS = {"markov": (hmm_enum.model, hmm_model), "scan": (hmm_enum.scan_model, hmm_scan_model)}


# ---------------------------------------------------------------------------
# Dirichlet and the stick-breaking transform

def test_dirichlet_matches_jax():
    rng = np.random.default_rng(0)
    conc = np.exp(rng.standard_normal((3, 4))).astype(np.float32)
    x = rng.dirichlet(np.ones(4), (5, 3)).astype(np.float32)
    t, j = dist.Dirichlet(torch.from_numpy(conc)), jdist.Dirichlet(jnp.asarray(conc))
    assert t.batch_shape == j.batch_shape == (3,) and t.event_shape == j.event_shape == (4,)
    assert t.support is constraints.simplex and not t.support.is_discrete
    np.testing.assert_allclose(t.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(j.log_prob(jnp.asarray(x))), rtol=1e-6)
    for moment in ("mean", "variance"):
        np.testing.assert_allclose(getattr(t, moment).numpy(), np.asarray(getattr(j, moment)),
                                   rtol=1e-6)
    draws = t.sample(torch.Generator().manual_seed(0), (20000,))
    assert draws.shape == (20000, 3, 4)
    assert bool(constraints.simplex(draws).all())
    np.testing.assert_allclose(draws.mean(0).numpy(), np.asarray(j.mean), atol=0.01)
    with pytest.raises(ValueError):
        dist.Dirichlet(torch.tensor(1.0))


def test_stick_breaking_transform_matches_jax():
    rng = np.random.default_rng(1)
    u = (3 * rng.standard_normal((6, 4))).astype(np.float32)
    u[0] = 0.0  # the uniform point
    u[1] = [30.0, -30.0, 5.0, -5.0]
    t, j = transforms.StickBreakingTransform(), jtransforms.StickBreakingTransform()
    y_t, y_j = t(torch.from_numpy(u)), j(jnp.asarray(u))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(y_t[0].numpy(), np.full(5, 0.2), rtol=1e-6)
    np.testing.assert_allclose(t.log_abs_det_jacobian(torch.from_numpy(u), y_t).numpy(),
                               np.asarray(j.log_abs_det_jacobian(jnp.asarray(u), y_j)),
                               rtol=1e-6)
    # the inverse's last stick is 1 minus a float32 cumsum, which the two
    # packages sum in their own orders: both are held to the JAX package's
    # inverse in float64 (the port is off it by 1.3e-6 at most here, JAX's
    # float32 inverse by 3.0e-6)
    y = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    with jax.enable_x64():
        want = np.asarray(j.inv(jnp.asarray(y, jnp.float64)))
    np.testing.assert_allclose(t.inv(torch.from_numpy(y)).numpy(), want, rtol=1e-6)
    assert t.forward_shape((2, 4)) == (2, 5) and t.inverse_shape((2, 5)) == (2, 4)
    assert isinstance(dist.biject_to(constraints.simplex), transforms.StickBreakingTransform)


# ---------------------------------------------------------------------------
# the enumerated potential of both forms

@pytest.mark.parametrize("form", ["markov", "scan"])
def test_hmm_potential_and_gradient_match_jax(form):
    """At 8 unconstrained points of ``trans`` (2 x 1) and ``sigma``: the
    port's potential from ``initialize_model``, JAX's as its
    ``initialize_model`` builds it (the model under ``enum`` at dim -1)."""
    ys, _ = hmm_data(12)
    wrapped = jenum.enum(jenum.config_enumerate(MODELS[form][0]), first_available_dim=-1)
    jvg = jax.jit(jax.value_and_grad(
        lambda p: jutil.potential_energy(wrapped, (jnp.asarray(ys),), {}, p, enum=True)))
    tinfo = util.initialize_model(torch.Generator().manual_seed(0), MODELS[form][1],
                                  model_args=(torch.from_numpy(ys),))
    rng = np.random.default_rng(2)
    for _ in range(8):
        u = {"trans": (1.5 * rng.standard_normal((2, 1))).astype(np.float32),
             "sigma": np.float32(rng.standard_normal() - 0.5)}
        jpe, jg = jvg({k: jnp.asarray(v) for k, v in u.items()})
        tg, tpe = torch.func.grad_and_value(tinfo.potential_fn)(
            {k: torch.as_tensor(v) for k, v in u.items()})
        np.testing.assert_allclose(tpe.item(), float(jpe), rtol=RTOL)
        for k in u:
            g = np.asarray(jg[k])
            np.testing.assert_allclose(tg[k].numpy(), g, rtol=RTOL,
                                       atol=RTOL * np.abs(g).max(), err_msg=k)


# ---------------------------------------------------------------------------
# TraceEnum_ELBO under AutoNormal

@pytest.mark.parametrize("form", ["markov", "scan"])
def test_trace_enum_elbo_loss_and_gradient_match_jax(form, monkeypatch):
    """One loss and its gradient at the same unconstrained ``AutoNormal``
    params, on JAX's own draws handed to the port (``test_torch_svi``'s
    helpers).  ``max_plate_nesting=0`` in both: the default probe of the
    model would draw its latents and take noise meant for the guide."""
    ys, _ = hmm_data(6)
    jmodel, tmodel = MODELS[form][0], MODELS[form][1]
    jargs, targs = (jnp.asarray(ys),), (torch.from_numpy(ys),)
    jloss, tloss = jinfer.TraceEnum_ELBO(max_plate_nesting=0), TraceEnum_ELBO(max_plate_nesting=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the autoguides warn at each discrete site
        jguide, jsvi, tguide, tsvi, u = _both_svis("AutoNormal", jloss, tloss, jmodel, tmodel,
                                                  jargs, targs)
    key = random.PRNGKey(3)
    params = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    noise = jax_noise(jguide, "AutoNormal", params, _guide_seeds(key, 1, False), jargs)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda uu: jloss.loss(key, jsvi.constrain_fn(uu), jmodel, jguide, *jargs)))(
        {k: jnp.asarray(v) for k, v in u.items()})

    def fn(ut):
        return tloss.loss(torch.Generator().manual_seed(0), tsvi.constrain_fn(ut), tmodel,
                          tguide, *targs)

    with fed_noise(monkeypatch, [torch.tensor(t[0]) for t in noise]):
        tgrad, tval = torch.func.grad_and_value(fn)({k: torch.tensor(v) for k, v in u.items()})
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    assert set(tgrad) == set(jgrad)
    for k in jgrad:
        g = np.asarray(jgrad[k])
        np.testing.assert_allclose(tgrad[k].numpy(), g, rtol=RTOL, atol=RTOL * np.abs(g).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# NUTS

def _hmm_with_stay(ys):
    """The markov form with a deterministic site."""
    trans = npt.sample("trans", dist.Dirichlet(torch.ones(2, 2)).to_event(1))
    npt.deterministic("stay", trans[0, 0] + trans[1, 1])
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    locs = torch.tensor([-1.0, 1.0])
    z = 0
    for t in tenum.markov(range(ys.shape[0])):
        z = npt.sample(f"z_{t}", dist.Categorical(trans[z]))
        npt.sample(f"y_{t}", dist.Normal(locs[z], sigma), obs=ys[t])


def test_enumerated_model_through_the_per_step_api_and_postprocessing():
    """``NUTS.init``/``sample`` on the enumerated model, the per-step loop of
    one chain, and a deterministic site replayed through the enumerated
    model: the samples hold the continuous sites (and the deterministic
    one), never the discrete ones."""
    ys, _ = hmm_data(10)
    args = (torch.from_numpy(ys),)
    kernel = NUTS(_hmm_with_stay, max_tree_depth=3)
    state = kernel.init(torch.Generator().manual_seed(0), 5, model_args=args, num_chains=3)
    state = kernel.sample(state, args, {})
    assert set(state.z) == {"trans", "sigma"} and state.z["trans"].shape == (3, 2, 1)
    assert torch.isfinite(state.potential_energy).all()
    m = MCMC(NUTS(_hmm_with_stay, max_tree_depth=3),
             num_warmup=5, num_samples=4, num_chains=1, device="cpu")
    m.run(1, *args)
    z = m.get_samples()
    assert set(z) == {"trans", "sigma", "stay"} and z["trans"].shape == (4, 2, 2)
    torch.testing.assert_close(z["stay"], z["trans"][:, 0, 0] + z["trans"][:, 1, 1])
    fused = MCMC(NUTS(hmm_scan_model, max_tree_depth=3), num_warmup=5, num_samples=4,
                 num_chains=4, device="cpu")
    fused.run(2, *args)
    assert set(fused.get_samples()) == {"trans", "sigma"}


def _moments_agree(got, want):
    g, w = mc_moments(got), mc_moments(want)
    for m in ("mean", "std"):
        gap = np.abs(np.subtract(g[m], w[m]))
        bound = 4 * np.hypot(g["se_" + m], w["se_" + m])
        assert np.all(gap < bound), (m, gap, bound)


def test_short_hmm_run_matches_jax():
    """The scan form at T = 20, 4 chains, 100 + 80 at depths (3, 3): the
    posterior means and stds of trans and sigma within 4 Monte-Carlo
    standard errors of the JAX package's run."""
    ys, _ = hmm_data(20)
    jm = jinfer.MCMC(jinfer.NUTS(hmm_enum.scan_model, max_tree_depth=(3, 3)), num_warmup=100,
                     num_samples=80, num_chains=4, chain_method="vectorized",
                     progress_bar=False)
    jm.run(random.PRNGKey(0), jnp.asarray(ys))
    tm = MCMC(NUTS(hmm_scan_model, max_tree_depth=(3, 3)), num_warmup=100,
              num_samples=80, num_chains=4, device="cpu")
    tm.run(0, torch.from_numpy(ys))
    jz, tz = jm.get_samples(group_by_chain=True), tm.get_samples(group_by_chain=True)
    assert tz["trans"].shape == (4, 80, 2, 2) and torch.isfinite(tz["sigma"]).all()
    for k in ("trans", "sigma"):
        _moments_agree(tz[k].numpy(), np.asarray(jz[k]))


# ---------------------------------------------------------------------------
# decoding

def test_predictive_infer_discrete_decodes_as_jax():
    """``Predictive(infer_discrete=True)`` of the markov form at the
    generating parameters: every ``z_t`` drawn per sample, and the most
    frequent state at each step the same in both packages (and the
    generating one)."""
    ys, zs = hmm_data(8)
    n = 200
    trans = np.broadcast_to(np.array([[0.85, 0.15], [0.25, 0.75]], np.float32), (n, 2, 2))
    sigma = np.full((n,), 0.3, np.float32)
    tpred = Predictive(hmm_model, {"trans": torch.from_numpy(trans.copy()),
                                                  "sigma": torch.from_numpy(sigma)},
                       infer_discrete=True, parallel=True, device="cpu")(0, torch.from_numpy(ys))
    jpred = jax.jit(jinfer.Predictive(hmm_enum.model, {"trans": jnp.asarray(trans),
                                                               "sigma": jnp.asarray(sigma)},
                                      infer_discrete=True))(random.PRNGKey(0), jnp.asarray(ys))
    assert {k: tuple(v.shape) for k, v in tpred.items()} == {
        k: tuple(np.shape(v)) for k, v in jpred.items()}
    t_mode = np.stack([(tpred[f"z_{t}"].float().mean() > 0.5).item() for t in range(8)])
    j_mode = np.stack([np.asarray(jpred[f"z_{t}"]).mean() > 0.5 for t in range(8)])
    np.testing.assert_array_equal(t_mode, j_mode)
    np.testing.assert_array_equal(t_mode.astype(int), zs)
