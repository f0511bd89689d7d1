"""The flow guides and ``NeuTraReparam`` in the port against the JAX
package's: the ELBO loss and every parameter's gradient of ``AutoIAFNormal``
and ``AutoBNAFNormal`` at JAX's initialised parameters and on JAX's base
draws; the reparameterised model's potential and gradient under
``NeuTraReparam`` at the same latent and parameters; ``transform_sample``;
and whole runs.

JAX's base draws are found from the key its seed handler gives the packed
latent's site (the trace keeps it), and handed to the port, whose
``torch.randn`` is replaced for the call (``test_torch_svi``'s queue).  JAX's
``AutoContinuous`` leaves ``log q`` of the packed latent out of its guide's
density (ROADMAP.md, Queue 3): the JAX reference adds it back, computed by
the JAX package's own transform at the same draws.

Tolerances: losses to ``rtol=1e-5`` and gradients to ``rtol=1e-4,
atol=1e-5`` (float32 sums over the particles and the network's layers in
another order); through the GLM op, where JAX sums the log-likelihood in
float32 with a padding error near 1e-5 relative at N = 2,000 and the port in
float64 (ROADMAP.md, Queue 3), ``rtol=1e-4`` on values and ``rtol=1e-3,
atol=1e-3`` on gradients, as ``tests/test_torch_glm.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu import infer as jinfer
from numpyro_tpu import optim as joptim
from numpyro_tpu.infer import autoguide as jautoguide
from numpyro_tpu.infer.reparam import NeuTraReparam as JNeuTraReparam
from numpyro_tpu.infer.util import potential_energy as jpotential_energy
from numpyro_tpu.ops import glm as jglm
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers, nn, optim
from numpyro_tpu_torch.infer import MCMC, NUTS, SVI, Trace_ELBO, autoguide
from numpyro_tpu_torch.infer.reparam import NeuTraReparam
from numpyro_tpu_torch.infer.util import potential_energy
from numpyro_tpu_torch.ops import glm
from numpyro_tpu_torch.util import tree_leaves, tree_unflatten

from test_torch_svi import _fake_randn, _guide_seeds, fed_noise, fed_particles

torch.set_num_threads(1)

LOSS_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-4, 1e-5
GLM_RTOL, GLM_G_RTOL, GLM_G_ATOL = 1e-4, 1e-3, 1e-3
POST_MEAN = 2 * 2 / 2.25  # posterior mean of x0 + x1 given y = 2


def sum_model_j(y):
    x = numpyro_tpu.sample("x", jdist.Normal(jnp.zeros(2), 1.0).to_event(1))
    numpyro_tpu.sample("y", jdist.Normal(x.sum(), 0.5), obs=y)


def sum_model_t(y):
    x = npt.sample("x", dist.Normal(torch.zeros(2), 1.0).to_event(1))
    npt.sample("y", dist.Normal(x.sum(), 0.5), obs=y)


def glm_data(n=2000, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, d - 1)), np.ones((n, 1))], 1).astype(np.float32)
    w = (0.5 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w))).astype(np.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=jnp.float32)
    td = glm.from_numpy_glm_data(np.asarray(jd.x_t), np.asarray(jd.y_row), jd.n, jd.d,
                                 torch.float32)
    return jd, td


def glm_model_j(data):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(data.d), 1.0).to_event(1))
    numpyro_tpu.factor("lik", jglm.bernoulli_logits_loglik(w, data))


def glm_model_t(data):
    w = npt.sample("w", dist.Normal(torch.zeros(data.d), 1.0).to_event(1))
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


def funnel_j():
    y = numpyro_tpu.sample("y", jdist.Normal(0.0, 3.0))
    numpyro_tpu.sample("x", jdist.Normal(0.0, jnp.exp(y / 2)))


def funnel_t():
    y = npt.sample("y", dist.Normal(0.0, 3.0))
    npt.sample("x", dist.Normal(0.0, torch.exp(y / 2)))


GUIDES = {
    "iaf": (lambda m: jautoguide.AutoIAFNormal(m, num_flows=2, hidden_dims=[8, 8]),
            lambda m: autoguide.AutoIAFNormal(m, num_flows=2, hidden_dims=[8, 8])),
    "iaf_skip": (lambda m: jautoguide.AutoIAFNormal(m, skip_connections=True),
                 lambda m: autoguide.AutoIAFNormal(m, skip_connections=True)),
    "bnaf": (lambda m: jautoguide.AutoBNAFNormal(m, num_flows=2, hidden_factors=[4, 4]),
             lambda m: autoguide.AutoBNAFNormal(m, num_flows=2, hidden_factors=[4, 4])),
}


# ---------------------------------------------------------------------------
# helpers


def assert_trees_close(got, want, rtol, atol, path="params"):
    """A port tree (tensors) against a JAX tree (arrays) of the same layout;
    dicts are matched by key (JAX orders them by key)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], rtol, atol, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_close(g, w, rtol, atol, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=path)


def both_svis(pair, jmodel, tmodel, jargs, targs, num_particles):
    """Both guides set up by their SVI's ``init``; JAX's initialised
    unconstrained params (a tree of numpy arrays)."""
    jguide, tguide = pair[0](jmodel), pair[1](tmodel)
    jsvi = jinfer.SVI(jmodel, jguide, joptim.Adam(0.01), jinfer.Trace_ELBO(num_particles))
    jstate = jsvi.init(random.PRNGKey(0), *jargs)
    tsvi = SVI(tmodel, tguide, optim.Adam(0.01), Trace_ELBO(num_particles), device="cpu")
    tstate = tsvi.init(0, *targs)
    u = jax.tree.map(np.asarray, jsvi.optim.get_params(jstate[0]))
    ut = tsvi.optim.get_params(tstate.optim_state)
    assert_trees_close(_shapes(ut), _shapes_j(u), 0, 0)
    return jguide, jsvi, tguide, tsvi, u


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return None if tree is None else torch.tensor(tree.shape, dtype=torch.float32)


def _shapes_j(tree):
    if isinstance(tree, dict):
        return {k: _shapes_j(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes_j(v) for v in tree]
    return None if tree is None else np.asarray(np.shape(tree), np.float32)


def base_draws(jguide, params, seeds, args):
    """JAX's standard-normal base draws of the packed latent, one row per
    guide seed, checked against the latent its trace recorded."""
    rows = []
    transform = jguide.get_transform(params)
    for seed in seeds:
        tr = jhandlers.trace(
            jhandlers.substitute(jhandlers.seed(jguide, seed), data=params)).get_trace(*args)
        site = tr["_auto_latent"]
        z = random.normal(site["kwargs"]["rng_key"], (jguide.latent_dim,))
        np.testing.assert_allclose(np.asarray(transform(z)), np.asarray(site["value"]),
                                   rtol=1e-6, atol=1e-6)
        rows.append(np.asarray(z))
    return np.stack(rows)


def jax_value_and_grad(jguide, jsvi, jloss, jmodel, jargs, key, draws, u):
    def fn(u):
        params = jsvi.constrain_fn(u)
        loss = jloss.loss(key, params, jmodel, jguide, *jargs)
        # log q of the packed latent, which JAX's guide leaves out
        z = jnp.asarray(draws)
        transform = jguide.get_transform(params)
        log_q = (jguide.get_base_dist().log_prob(z)
                 - transform.log_abs_det_jacobian(z, transform(z)))
        return loss + jnp.mean(log_q)

    val, grad = jax.jit(jax.value_and_grad(fn))(jax.tree.map(jnp.asarray, u))
    return float(val), grad


def torch_value_and_grad(tsvi, tloss, tmodel, tguide, targs, u, tables, monkeypatch):
    """The port's loss and gradient at ``u`` with ``tables`` (one ``(P,
    ...)`` array per draw of a particle, in the port's draw order) as its
    standard-normal draws."""
    ut = nn.params_from_numpy(u, "cpu")

    def fn(leaves):
        params = tsvi.constrain_fn(tree_unflatten(ut, leaves))
        return tloss.loss(torch.Generator().manual_seed(0), params, tmodel, tguide, *targs)

    leaves = tree_leaves(ut)
    if tloss.num_particles == 1:
        with fed_noise(monkeypatch, [torch.from_numpy(t[0]) for t in tables]):
            grad, val = torch.func.grad_and_value(fn)(leaves)
    else:
        tloss.vectorize_particles = fed_particles([torch.from_numpy(t) for t in tables])
        with monkeypatch.context() as m:
            m.setattr(torch, "randn", _fake_randn)
            grad, val = torch.func.grad_and_value(fn)(leaves)
    return val.item(), tree_unflatten(ut, grad)


def check_elbo(pair, jmodel, tmodel, jargs, targs, num_particles, monkeypatch, tols):
    jguide, jsvi, tguide, tsvi, u = both_svis(pair, jmodel, tmodel, jargs, targs, num_particles)
    key = random.PRNGKey(3)
    params = jsvi.constrain_fn(jax.tree.map(jnp.asarray, u))
    seeds = _guide_seeds(key, num_particles, num_particles > 1)
    draws = base_draws(jguide, params, seeds, jargs)
    jval, jgrad = jax_value_and_grad(jguide, jsvi, jinfer.Trace_ELBO(num_particles), jmodel,
                                     jargs, key, draws, u)
    tval, tgrad = torch_value_and_grad(tsvi, Trace_ELBO(num_particles), tmodel, tguide, targs,
                                       u, [draws], monkeypatch)
    loss_rtol, g_rtol, g_atol = tols
    np.testing.assert_allclose(tval, jval, rtol=loss_rtol)
    assert_trees_close(tgrad, jgrad, g_rtol, g_atol)
    return jguide, jsvi, tguide, tsvi, u, draws


# ---------------------------------------------------------------------------
# the flow guides' ELBO


@pytest.mark.parametrize("name", list(GUIDES))
@pytest.mark.parametrize("num_particles", [1, 3])
def test_flow_guide_loss_and_gradient_match_jax(name, num_particles, monkeypatch):
    check_elbo(GUIDES[name], sum_model_j, sum_model_t, (2.0,), (torch.tensor(2.0),),
               num_particles, monkeypatch, (LOSS_RTOL, G_RTOL, G_ATOL))


@pytest.mark.parametrize("name", ["iaf", "bnaf"])
def test_flow_guide_on_the_glm_model_matches_jax_in_one_evaluation(name, monkeypatch):
    """Four particles through the GLM op's vmap rule: one plain evaluation
    for all of them in the loss (and three in ``SVI.init``'s traces)."""
    jd, td = glm_data()
    glm.reset_launch_counts()
    check_elbo(GUIDES[name], glm_model_j, glm_model_t, (jd,), (td,), 4, monkeypatch,
               (GLM_RTOL, GLM_G_RTOL, GLM_G_ATOL))
    assert glm.launch_counts["plain"] == 3 + 1


@pytest.mark.parametrize("name", ["iaf", "bnaf"])
def test_get_transform_and_sample_posterior_match_jax(name, monkeypatch):
    jguide, jsvi, tguide, tsvi, u = both_svis(GUIDES[name], sum_model_j, sum_model_t, (2.0,),
                                              (torch.tensor(2.0),), 1)
    jparams = jsvi.constrain_fn(jax.tree.map(jnp.asarray, u))
    tparams = tsvi.constrain_fn(nn.params_from_numpy(u, "cpu"))
    z = np.random.default_rng(5).standard_normal((7, 2)).astype(np.float32)
    jt, tt = jguide.get_transform(jparams), tguide.get_transform(tparams)
    want = jt(jnp.asarray(z))
    np.testing.assert_allclose(tt(torch.from_numpy(z)).numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tt.log_abs_det_jacobian(torch.from_numpy(z), tt(torch.from_numpy(z))).numpy(),
        np.asarray(jt.log_abs_det_jacobian(jnp.asarray(z), want)), rtol=1e-5, atol=1e-6)
    # the posterior's density from the flow's own intermediates (BNAF has
    # no inverse)
    post = tguide.get_posterior(tparams)
    assert post.event_shape == (2,)
    x, inter = tt.call_with_intermediates(torch.from_numpy(z))
    np.testing.assert_allclose(
        post.log_prob(x, [[torch.from_numpy(z), inter]]).detach().numpy(),
        np.asarray(jguide.get_base_dist().log_prob(jnp.asarray(z))
                   - jt.log_abs_det_jacobian(jnp.asarray(z), want)), rtol=1e-5, atol=1e-5)
    # sample_posterior pushes the (fed) base draws through the flow
    with fed_noise(monkeypatch, [torch.from_numpy(z)]):
        got = tguide.sample_posterior(torch.Generator().manual_seed(0), tparams,
                                      sample_shape=(7,))
    np.testing.assert_allclose(got["x"].detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(NotImplementedError):
        tguide.median(tparams)


@pytest.mark.parametrize("cls", ["AutoIAFNormal", "AutoBNAFNormal"])
def test_one_latent_dimension_raises_as_in_jax(cls):
    def jmodel():
        numpyro_tpu.sample("x", jdist.Normal(0.0, 1.0))

    def tmodel():
        npt.sample("x", dist.Normal(0.0, 1.0))

    with pytest.raises(ValueError, match="latent dim = 1"):
        jinfer.SVI(jmodel, getattr(jautoguide, cls)(jmodel), joptim.Adam(0.01),
                   jinfer.Trace_ELBO()).init(random.PRNGKey(0))
    with pytest.raises(ValueError, match="latent dim = 1"):
        SVI(tmodel, getattr(autoguide, cls)(tmodel), optim.Adam(0.01), Trace_ELBO(),
            device="cpu").init(0)


def test_flow_networks_are_made_once():
    """The guide makes each flow's network (and its masks) once; later calls
    bind new params to the same network."""
    guide = autoguide.AutoIAFNormal(sum_model_t, num_flows=2)
    svi = SVI(sum_model_t, guide, optim.Adam(0.01), Trace_ELBO(), device="cpu")
    state = svi.init(0, torch.tensor(2.0))
    nets = dict(guide._networks)
    svi.update(state, torch.tensor(2.0))
    assert guide._networks == nets and len(nets) == 2


@pytest.mark.parametrize("make", [
    lambda m: autoguide.AutoIAFNormal(m, num_flows=2),
    lambda m: autoguide.AutoBNAFNormal(m),
], ids=["iaf", "bnaf"])
def test_flow_guides_converge(make):
    """``tests/infer/test_autoguide_extra.py``'s check on the port."""
    guide = make(sum_model_t)
    res = SVI(sum_model_t, guide, optim.Adam(0.01), Trace_ELBO(num_particles=4),
              device="cpu").run(0, 800, torch.tensor(2.0))
    assert torch.isfinite(res.losses[-50:]).all()
    s = guide.sample_posterior(torch.Generator().manual_seed(1), res.params, sample_shape=(500,))
    assert abs(s["x"].sum(-1).mean().item() - POST_MEAN) < 0.3


@pytest.mark.parametrize("seed", [0, 1, 2, 8])
def test_iaf_losses_stay_finite_on_the_glm_model(seed):
    """``chip_smoke.py`` 14a's configuration (3 flows of hidden widths
    [D, D], 4 particles, 300 steps of ``Adam(0.01)``) at a small size: every
    loss is finite, however far the first draws' logits reach, and the fit
    heads towards the generating coefficients."""
    jd, td = glm_data(d=6)
    guide = autoguide.AutoIAFNormal(glm_model_t, num_flows=3, hidden_dims=[6, 6])
    res = SVI(glm_model_t, guide, optim.Adam(0.01), Trace_ELBO(num_particles=4),
              device="cpu").run(seed, 300, td)
    assert torch.isfinite(res.losses).all()
    assert res.losses[-50:].mean() < res.losses[:50].mean()


# ---------------------------------------------------------------------------
# NeuTraReparam


def _fitted_pair(pair, jmodel, tmodel, jargs, targs, seed=11):
    """Both guides at the same params: JAX's init, moved by a seeded step."""
    jguide, jsvi, tguide, tsvi, u = both_svis(pair, jmodel, tmodel, jargs, targs, 1)
    rng = np.random.default_rng(seed)
    u = jax.tree.map(lambda v: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32), u)
    jparams = jsvi.constrain_fn(jax.tree.map(jnp.asarray, u))
    tparams = tsvi.constrain_fn(nn.params_from_numpy(u, "cpu"))
    return jguide, tguide, jparams, tparams


NEUTRA_GUIDES = {
    "diag": (jautoguide.AutoDiagonalNormal, autoguide.AutoDiagonalNormal),
    "iaf": GUIDES["iaf"],
}


@pytest.mark.parametrize("name", list(NEUTRA_GUIDES))
def test_neutra_potential_and_gradient_match_jax_on_the_funnel(name):
    jguide, tguide, jparams, tparams = _fitted_pair(NEUTRA_GUIDES[name], funnel_j, funnel_t,
                                                    (), ())
    jn, tn = JNeuTraReparam(jguide, jparams), NeuTraReparam(tguide, tparams)
    jm, tm = jn.reparam(funnel_j), tn.reparam(funnel_t)
    z = np.random.default_rng(2).standard_normal((4, 2)).astype(np.float32)

    def jpe(z):
        return jpotential_energy(jm, (), {}, {"y_shared_latent": z})

    def tpe(z):
        return potential_energy(tm, (), {}, {"y_shared_latent": z})

    jg, jv = jax.vmap(jax.grad(jpe))(jnp.asarray(z)), jax.vmap(jpe)(jnp.asarray(z))
    tg, tv = torch.func.vmap(torch.func.grad_and_value(tpe))(torch.from_numpy(z))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), rtol=G_RTOL, atol=G_ATOL)
    # the reparameterised trace: a shared latent, deterministic sites, factors
    tr = handlers.trace(handlers.seed(tm, 0)).get_trace()
    jtr = jhandlers.trace(jhandlers.seed(jm, 0)).get_trace()
    assert [(k, s["type"]) for k, s in tr.items()] == [(k, s["type"]) for k, s in jtr.items()]
    # transform_sample
    want = jn.transform_sample(jnp.asarray(z))
    got = tn.transform_sample(torch.from_numpy(z))
    assert set(got) == set(want) == {"x", "y"}
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6)


def test_neutra_on_the_glm_model_matches_jax_in_one_evaluation():
    """Eight chains' potential and gradient through the IAF and the GLM
    op: one plain evaluation for all of them."""
    jd, td = glm_data()
    jguide, tguide, jparams, tparams = _fitted_pair(GUIDES["iaf"], glm_model_j, glm_model_t,
                                                    (jd,), (td,))
    jm = JNeuTraReparam(jguide, jparams).reparam(glm_model_j)
    tm = NeuTraReparam(tguide, tparams).reparam(glm_model_t)
    z = np.random.default_rng(3).standard_normal((8, 5)).astype(np.float32)

    def jpe(z):
        return jpotential_energy(jm, (jd,), {}, {"w_shared_latent": z})

    def tpe(z):
        return potential_energy(tm, (td,), {}, {"w_shared_latent": z})

    jg, jv = jax.vmap(jax.grad(jpe))(jnp.asarray(z)), jax.vmap(jpe)(jnp.asarray(z))
    glm.reset_launch_counts()
    tg, tv = torch.func.vmap(torch.func.grad_and_value(tpe))(torch.from_numpy(z))
    assert glm.launch_counts["plain"] == 1
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=GLM_RTOL)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), rtol=GLM_G_RTOL,
                               atol=GLM_G_ATOL)


def test_neutra_leaves_no_stale_sites():
    """A run cut short after its first site (here by an exception) leaves a
    pending slice behind; the next run draws afresh and scores as a fresh
    reparameterizer does, whether it goes through ``reparam`` or through the
    handler directly."""
    jguide, tguide, _, tparams = _fitted_pair(NEUTRA_GUIDES["iaf"], funnel_j, funnel_t, (), ())
    neutra = NeuTraReparam(tguide, tparams)

    def cut_short():
        npt.sample("y", dist.Normal(0.0, 3.0))
        raise RuntimeError("cut")

    with pytest.raises(RuntimeError, match="cut"):
        handlers.seed(handlers.reparam(cut_short, config=neutra._reparam_config), 0)()
    assert set(neutra._pending_sites) == {"x"}
    z = {"y_shared_latent": torch.tensor([0.3, -0.2])}
    plain = handlers.reparam(funnel_t, config=neutra._reparam_config)
    got = potential_energy(plain, (), {}, z)
    fresh = NeuTraReparam(tguide, tparams)
    want = potential_energy(fresh.reparam(funnel_t), (), {}, z)
    assert torch.equal(got, want) and not fresh._pending_sites
    with pytest.raises(RuntimeError, match="cut"):
        handlers.seed(neutra.reparam(cut_short), 0)()
    assert set(neutra._pending_sites) == {"x"}
    assert torch.equal(potential_energy(neutra.reparam(funnel_t), (), {}, z), want)


def test_neutra_refuses_a_guide_without_a_transform():
    guide = autoguide.AutoDAIS(funnel_t)
    SVI(funnel_t, guide, optim.Adam(0.01), Trace_ELBO(), device="cpu").init(0)
    with pytest.raises(ValueError, match="only supports AutoContinuous"):
        NeuTraReparam(guide, {})


def test_neutra_nuts_run_on_the_funnel():
    """``tests/infer/test_reparam.py``'s run on the port: fit, then NUTS in
    the base space; ``transform_sample`` gives both sites back."""
    guide = autoguide.AutoDiagonalNormal(funnel_t)
    res = SVI(funnel_t, guide, optim.Adam(1e-2), Trace_ELBO(), device="cpu").run(0, 800)
    neutra = NeuTraReparam(guide, res.params)
    mcmc = MCMC(NUTS(neutra.reparam(funnel_t), max_tree_depth=5), num_warmup=100,
                num_samples=100, num_chains=4,
                device="cpu")
    mcmc.run(3)
    s = mcmc.get_samples()
    shared = [k for k in s if k.endswith("_shared_latent")]
    assert shared == ["y_shared_latent"]
    z = neutra.transform_sample(s[shared[0]])
    assert set(z) >= {"x", "y"} and z["y"].shape == (400,)
    assert abs(z["y"].mean().item()) < 1.0
    np.testing.assert_allclose(z["y"].numpy(), s["y"].numpy(), rtol=1e-5, atol=1e-5)
