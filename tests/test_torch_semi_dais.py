"""``AutoSemiDAIS`` in the port against the JAX package's, on the model of
``tests/infer/test_autoguide_extra.py::test_auto_semi_dais`` (N = 16 data,
subsample 8, a Gamma(5, 5) precision per datum, a global Normal mean under
``AutoNormal``, K = 3): the ELBO loss and every parameter's gradient at the
same params on JAX's draws with the subsample indices pinned, with and
without ``use_global_dais_params`` and a ``local_guide``; the per-datum
parameters' gradients in the rows that were not drawn; ``sample_posterior``;
the errors; a GLM factor in the local density; and the JAX test's own
criterion on a run that fits the CPU lane.

JAX's draws reach the port through ``test_torch_svi``'s ``torch.randn``
queue, in the order the port draws: the global ``theta``'s noise, then the
locals' start (``z_0``'s noise, or the local guide's), then the ``(S, D, K)``
momentum.  Tolerances: the loss to rtol 1e-5, the gradients to rtol 1e-4 and
atol 1e-5 (float32 sums in another order and the second derivatives of K
annealing steps), as for ``AutoDAIS``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu import infer as jinfer
from numpyro_tpu import optim as joptim
from numpyro_tpu.infer import autoguide as jautoguide
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers, nn, optim
from numpyro_tpu_torch.infer import SVI, Trace_ELBO, autoguide
from numpyro_tpu_torch.ops import glm

from test_torch_dais import _jax_value_and_grad, _svis
from test_torch_flow_guides import assert_trees_close
from test_torch_svi import _guide_seeds, fed_noise
from numpyro_tpu_torch.util import tree_leaves, tree_unflatten

torch.set_num_threads(1)

LOSS_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-4, 1e-5
N, S = 16, 8
DATA = (1.5 + 0.5 * np.random.default_rng(0).standard_normal(N)).astype(np.float32)
IDX = np.array([3, 0, 7, 12, 9, 1, 14, 5])
DRAWN = np.isin(np.arange(N), IDX)
RECORD = []  # the JAX local guide's draws, read back for the port


def global_j():
    return numpyro_tpu.sample("theta", jdist.Normal(0.0, 3.0))


def local_j(theta):
    with numpyro_tpu.plate("data", N, subsample_size=S):
        tau = numpyro_tpu.sample("tau", jdist.Gamma(5.0, 5.0))
        batch = numpyro_tpu.subsample(jnp.asarray(DATA), event_dim=0)
        numpyro_tpu.sample("obs", jdist.Normal(theta, 1 / jnp.sqrt(tau)), obs=batch)


def model_j():
    return local_j(global_j())


def local_guide_j(theta):
    with numpyro_tpu.plate("data", N, subsample_size=S):
        q = numpyro_tpu.param("q_loc", jnp.zeros(N), event_dim=0)
        RECORD.append(numpyro_tpu.sample("tau", jdist.LogNormal(q, 0.3)))


def global_t():
    return npt.sample("theta", dist.Normal(0.0, 3.0))


def local_t(theta):
    with npt.plate("data", N, subsample_size=S):
        tau = npt.sample("tau", dist.Gamma(5.0, 5.0))
        batch = npt.subsample(torch.from_numpy(DATA), event_dim=0)
        npt.sample("obs", dist.Normal(theta, 1 / torch.sqrt(tau)), obs=batch)


def model_t():
    return local_t(global_t())


def local_guide_t(theta):
    with npt.plate("data", N, subsample_size=S):
        q = npt.param("q_loc", torch.zeros(N), event_dim=0)
        npt.sample("tau", dist.LogNormal(q, 0.3))


def _pinned_j(fn):
    return jhandlers.substitute(fn, data={"data": jnp.asarray(IDX)})


def _pinned_t(fn):
    return handlers.substitute(fn, data={"data": torch.from_numpy(IDX)})


def _guides(use_global, with_local_guide):
    kw = dict(K=3, use_global_dais_params=use_global)
    jguide = jautoguide.AutoSemiDAIS(model_j, local_j, jautoguide.AutoNormal(global_j),
                                     local_guide_j if with_local_guide else None, **kw)
    tguide = autoguide.AutoSemiDAIS(model_t, local_t, autoguide.AutoNormal(global_t),
                                    local_guide_t if with_local_guide else None, **kw)
    return jguide, tguide


def _semi_noise(jguide, params, seed, with_local_guide):
    """The standard-normal draws of one JAX guide run, in the port's order."""
    RECORD.clear()
    tr = jhandlers.trace(jhandlers.substitute(jhandlers.seed(_pinned_j(jguide), seed),
                                              data=params)).get_trace()
    theta = (tr["theta"]["value"] - params["auto_theta_loc"]) / params["auto_theta_scale"]
    mass = params["auto_mass_matrix"]
    mass = mass[IDX] if mass.ndim == 2 else mass
    # the momentum's Normal(0, mass[..., None]) is expanded from (S, D, 1) to
    # (S, D, K): both packages draw the grown axis first, (K, S, D, 1)
    momentum = jnp.moveaxis(tr["auto_momentum"]["value"] / mass[..., None], -1, 0)[..., None]
    if with_local_guide:
        # the first record is the draw; the later ones are the annealing's
        # evaluations of the local guide's density at substituted values
        start = (jnp.log(RECORD[0]) - params["q_loc"][IDX]) / 0.3
    else:
        start = (tr["auto_z_0"]["value"] - params["auto_z_0_loc"][IDX]) / \
            params["auto_z_0_scale"][IDX]
    return [torch.tensor(np.asarray(v, dtype=np.float32)) for v in (theta, start, momentum)]


def _torch_value_and_grad(tsvi, tmodel, tguide, u, noise, monkeypatch):
    """The port's loss and gradient at ``u``, its draws taken from ``noise``."""
    ut = nn.params_from_numpy(u, "cpu")

    def fn(leaves):
        params = tsvi.constrain_fn(tree_unflatten(ut, leaves))
        return Trace_ELBO().loss(torch.Generator().manual_seed(0), params, tmodel, tguide)

    with fed_noise(monkeypatch, noise):
        grad, val = torch.func.grad_and_value(fn)(tree_leaves(ut))
    return val.item(), tree_unflatten(ut, grad)


@pytest.mark.parametrize("with_local_guide", [False, True], ids=["no_local_guide", "local_guide"])
@pytest.mark.parametrize("use_global", [False, True], ids=["per_datum", "global_params"])
def test_loss_and_gradient_match_jax(use_global, with_local_guide, monkeypatch):
    jguide, tguide = _guides(use_global, with_local_guide)
    jsvi, tsvi, u = _svis(_pinned_j(jguide), _pinned_t(tguide), _pinned_j(model_j),
                          _pinned_t(model_t), (), (), 1)
    key = random.PRNGKey(3)
    params = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    noise = _semi_noise(jguide, params, _guide_seeds(key, 1, False)[0], with_local_guide)
    jval, jgrad = _jax_value_and_grad(jsvi, jinfer.Trace_ELBO(), _pinned_j(model_j),
                                      _pinned_j(jguide), (), key, u)
    tval, tgrad = _torch_value_and_grad(tsvi, _pinned_t(model_t), _pinned_t(tguide), u, noise,
                                        monkeypatch)
    np.testing.assert_allclose(tval, float(jval), rtol=LOSS_RTOL)
    assert_trees_close(tgrad, jgrad, G_RTOL, G_ATOL)
    if not use_global:
        # the per-datum params read the drawn rows only: the others get an
        # exact 0, in both packages
        for name in ("auto_eta0", "auto_gamma", "auto_beta_increments", "auto_mass_matrix"):
            assert (tgrad[name][~DRAWN] == 0).all() and (np.asarray(jgrad[name])[~DRAWN] == 0).all()
            assert (tgrad[name][DRAWN] != 0).any(), name


def test_sample_posterior_shapes_match_jax():
    jguide, tguide = _guides(False, False)
    jsvi, tsvi, u = _svis(jguide, tguide, model_j, model_t, (), (), 1)
    jparams = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    tparams = tsvi.constrain_fn(nn.params_from_numpy(u, "cpu"))
    with jhandlers.substitute(data={"data": jnp.arange(S)}):
        want = jguide.sample_posterior(random.PRNGKey(2), jparams)
    with handlers.substitute(data={"data": torch.arange(S)}):
        got = tguide.sample_posterior(torch.Generator().manual_seed(2), tparams)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(np.shape(v)) for k, v in want.items()} == {"theta": (), "tau": (S,)}
    many = tguide.sample_posterior(torch.Generator().manual_seed(3), tparams,
                                   sample_shape=(4, 5))
    assert many["theta"].shape == (4, 5) and many["tau"].shape == (4, 5, S)
    assert (many["tau"] > 0).all() and len(torch.unique(many["theta"])) == 20


def test_errors_match_jax():
    def no_locals_j():
        with numpyro_tpu.plate("data", N, subsample_size=S):
            numpyro_tpu.sample("obs", jdist.Normal(0.0, 1.0),
                               obs=numpyro_tpu.subsample(jnp.asarray(DATA), event_dim=0))
        numpyro_tpu.sample("theta", jdist.Normal(0.0, 1.0))

    def no_locals_t():
        with npt.plate("data", N, subsample_size=S):
            npt.sample("obs", dist.Normal(0.0, 1.0),
                       obs=npt.subsample(torch.from_numpy(DATA), event_dim=0))
        npt.sample("theta", dist.Normal(0.0, 1.0))

    def two_plates_j():
        with numpyro_tpu.plate("a", N, subsample_size=S):
            numpyro_tpu.sample("x", jdist.Normal(0.0, 1.0))
        with numpyro_tpu.plate("b", N, subsample_size=S):
            numpyro_tpu.sample("y", jdist.Normal(0.0, 1.0))

    def two_plates_t():
        with npt.plate("a", N, subsample_size=S):
            npt.sample("x", dist.Normal(0.0, 1.0))
        with npt.plate("b", N, subsample_size=S):
            npt.sample("y", dist.Normal(0.0, 1.0))

    for jm, tm, err, match in ((no_locals_j, no_locals_t, RuntimeError, "No local latent"),
                               (two_plates_j, two_plates_t, ValueError, "exactly one")):
        with pytest.raises(err, match=match):
            jinfer.SVI(jm, jautoguide.AutoSemiDAIS(jm, jm), joptim.Adam(0.01),
                       jinfer.Trace_ELBO()).init(random.PRNGKey(0))
        with pytest.raises(err, match=match):
            SVI(tm, autoguide.AutoSemiDAIS(tm, tm), optim.Adam(0.01), Trace_ELBO(),
                device="cpu").init(0)
    with pytest.raises(ValueError, match="K must satisfy"):
        autoguide.AutoSemiDAIS(model_t, local_t, K=0)


def test_glm_factor_in_the_local_density_raises_at_the_first_step():
    """The annealing differentiates the local model's gradient inside the
    ELBO's; the GLM op has no second derivative, so the first step raises
    (SVI.init, which takes no second derivative, passes)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, 3)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)

    def glm_local(theta):
        with npt.plate("data", N, subsample_size=S):
            w = npt.sample("w", dist.Normal(theta, 1.0).expand((3,)).to_event(1))
        data = glm.prepare_glm_data(torch.from_numpy(X[:1]), torch.from_numpy(y[:1]),
                                    dtype=torch.float32)
        npt.factor("lik", glm.bernoulli_logits_loglik(w.sum(0), data))

    def glm_model():
        return glm_local(global_t())

    guide = autoguide.AutoSemiDAIS(glm_model, glm_local, autoguide.AutoNormal(global_t), K=2)
    svi = SVI(glm_model, guide, optim.Adam(0.01), Trace_ELBO(), device="cpu")
    state = svi.init(0)
    with pytest.raises(NotImplementedError, match="no second derivative"):
        svi.update(state)


def test_semi_dais_converges_by_the_jax_test_criterion():
    """``tests/infer/test_autoguide_extra.py::test_auto_semi_dais``'s
    criterion at 300 steps (the JAX test takes 700 and is ``slow``): finite
    losses, the last 50 below the first 3 on average."""
    guide = autoguide.AutoSemiDAIS(model_t, local_t, autoguide.AutoNormal(global_t), K=3)
    res = SVI(model_t, guide, optim.Adam(5e-3), Trace_ELBO(), device="cpu").run(1, 300)
    losses = res.losses.numpy()
    assert np.isfinite(losses[-50:]).all()
    assert losses[-50:].mean() < losses[:3].mean()
    with handlers.substitute(data={"data": torch.arange(S)}):
        s = guide.sample_posterior(torch.Generator().manual_seed(2), res.params)
    assert s["tau"].shape == (S,) and torch.isfinite(s["theta"])
