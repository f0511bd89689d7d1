"""8-schools in the port against the JAX package: ``handlers.reparam`` with
``LocScaleReparam``, ``TransformReparam`` and ``ExplicitReparam`` (the
potential and its gradient at the same unconstrained points, rtol 1e-5 in
f32), deterministic sites through ``constrain_fn`` and through ``MCMC``'s
postprocessing on the fused and the per-step path, and
``LocScaleReparam(centered=None)`` under ``SVI`` with ``AutoNormal`` on
JAX's draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.distributions import transforms as jtransforms
from numpyro_tpu.infer import reparam as jreparam
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions import transforms
from numpyro_tpu_torch.infer import HMCECS, MCMC, NUTS, reparam
from numpyro_tpu_torch.infer import util

from test_torch_sv import mc_agree
from test_torch_svi import _check_loss_and_grad

torch.set_num_threads(1)

# examples/eight_schools.py:13-15
Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32)
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], np.float32)
J_ARGS = (jnp.asarray(Y), jnp.asarray(SIGMA))
T_ARGS = (torch.from_numpy(Y), torch.from_numpy(SIGMA))
RTOL = 1e-5


def jax_model(y, sigma, transformed=False):
    mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, 5.0))
    tau = numpyro_tpu.sample("tau", jdist.HalfCauchy(5.0))
    with numpyro_tpu.plate("J", 8):
        if transformed:
            prior = jdist.TransformedDistribution(
                jdist.Normal(0.0, 1.0), jtransforms.AffineTransform(mu, tau))
        else:
            prior = jdist.Normal(mu, tau)
        theta = numpyro_tpu.sample("theta", prior)
        numpyro_tpu.sample("obs", jdist.Normal(theta, sigma), obs=y)


def torch_model(y, sigma, transformed=False):
    mu = npt.sample("mu", dist.Normal(0.0, 5.0))
    tau = npt.sample("tau", dist.HalfCauchy(5.0))
    with npt.plate("J", 8):
        if transformed:
            prior = dist.TransformedDistribution(
                dist.Normal(0.0, 1.0), transforms.AffineTransform(mu, tau))
        else:
            prior = dist.Normal(mu, tau)
        theta = npt.sample("theta", prior)
        npt.sample("obs", dist.Normal(theta, sigma), obs=y)


# form -> (transformed prior?, the reparameterizers of both packages by site)
FORMS = {
    "centred": (False, lambda r: {}),
    "loc_scale_0": (False, lambda r: {"theta": r.LocScaleReparam(0)}),
    "loc_scale_0.3": (False, lambda r: {"theta": r.LocScaleReparam(0.3)}),
    "transform": (True, lambda r: {"theta": r.TransformReparam()}),
    "explicit_affine": (False, lambda r: {"theta": r.ExplicitReparam(
        (jtransforms if r is jreparam else transforms).AffineTransform(1.0, 10.0))}),
    "explicit_exp": (False, lambda r: {"tau": r.ExplicitReparam(
        (jtransforms if r is jreparam else transforms).ExpTransform())}),
}


def models(form):
    transformed, config = FORMS[form]

    def jm(y, sigma):
        return jax_model(y, sigma, transformed)

    def tm(y, sigma):
        return torch_model(y, sigma, transformed)

    return (jhandlers.reparam(jm, config=config(jreparam)),
            handlers.reparam(tm, config=config(reparam)))


def latent_shapes(jmodel):
    tr = jhandlers.trace(jhandlers.seed(jmodel, random.PRNGKey(0))).get_trace(*J_ARGS)
    return {k: s["value"].shape for k, s in tr.items()
            if s["type"] == "sample" and not s["is_observed"]}


@pytest.mark.parametrize("form", list(FORMS))
def test_potential_and_gradient_match_jax(form):
    jmodel, tmodel = models(form)
    shapes = latent_shapes(jmodel)
    assert ("theta" in shapes) == (form in ("centred", "explicit_exp"))
    rng = np.random.default_rng(3)
    for _ in range(3):
        u = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jpe, jg = jax.value_and_grad(
            lambda p: jutil.potential_energy(jmodel, J_ARGS, {}, p))(
            {k: jnp.asarray(v) for k, v in u.items()})
        tg, tpe = torch.func.grad_and_value(
            lambda p: util.potential_energy(tmodel, T_ARGS, {}, p))(
            {k: torch.from_numpy(v) for k, v in u.items()})
        np.testing.assert_allclose(tpe.item(), float(jpe), rtol=RTOL)
        assert set(tg) == set(jg)
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=RTOL,
                                       atol=RTOL * np.abs(np.asarray(jg[k])).max(), err_msg=k)


@pytest.mark.parametrize("form", ["loc_scale_0", "loc_scale_0.3", "transform",
                                  "explicit_affine"])
def test_constrain_fn_returns_jax_deterministic_sites(form):
    jmodel, tmodel = models(form)
    shapes = latent_shapes(jmodel)
    keys = random.split(random.PRNGKey(5), len(shapes))
    # 16 of JAX's draws in unconstrained space
    u = {k: random.normal(key, (16,) + s) for key, (k, s) in zip(keys, sorted(shapes.items()))}
    want = jax.vmap(lambda p: jutil.constrain_fn(jmodel, J_ARGS, {}, p,
                                                 return_deterministic=True))(u)
    tu = util.samples_from_numpy(u)
    got = [util.constrain_fn(tmodel, T_ARGS, {}, {k: v[i] for k, v in tu.items()},
                             return_deterministic=True) for i in range(16)]
    assert set(got[0]) == set(want) and "theta" in want
    for k in want:
        np.testing.assert_allclose(torch.stack([g[k] for g in got]).numpy(), want[k],
                                   rtol=RTOL, atol=1e-5, err_msg=k)
    # without return_deterministic only the given sites come back
    assert set(util.constrain_fn(tmodel, T_ARGS, {}, {k: v[0] for k, v in tu.items()})) == \
        set(shapes)


def test_unconstrain_fn_inverts_constrain_fn_as_in_jax():
    jmodel, tmodel = models("loc_scale_0")
    c = {"mu": np.float32(1.5), "tau": np.float32(2.5),
         "theta_decentered": np.linspace(-1, 1, 8).astype(np.float32)}
    want = jutil.unconstrain_fn(jmodel, J_ARGS, {}, {k: jnp.asarray(v) for k, v in c.items()})
    got = util.unconstrain_fn(tmodel, T_ARGS, {}, util.samples_from_numpy(c))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL, err_msg=k)
    back = util.constrain_fn(tmodel, T_ARGS, {}, got)
    for k in c:
        np.testing.assert_allclose(back[k].numpy(), c[k], rtol=RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("per_step", [False, True])
def test_mcmc_replays_deterministic_sites_on_both_paths(per_step):
    """``theta`` comes back as a deterministic site shaped ``(C, n, 8)`` on
    the fused path and the per-step path (a field the fused run does not
    bank), and equals JAX's ``constrain_fn`` of the same draws."""
    jmodel, tmodel = models("loc_scale_0")
    mcmc = MCMC(NUTS(tmodel, max_tree_depth=4), num_warmup=20, num_samples=6, num_chains=3,
                device="cpu")
    mcmc.run(0, *T_ARGS, extra_fields=("potential_energy",) if per_step else ())
    assert ("init_traces" in mcmc.last_run_stats) != per_step
    z = mcmc.get_samples(group_by_chain=True)
    assert set(z) == {"mu", "tau", "theta_decentered", "theta"}
    assert z["theta"].shape == (3, 6, 8)
    flat = mcmc.get_samples()
    u = util.unconstrain_fn(tmodel, T_ARGS, {}, {k: v[0] for k, v in flat.items()
                                                if k != "theta"})
    assert set(u) == {"mu", "tau", "theta_decentered"}
    latent = {k: np.asarray(v) for k, v in flat.items() if k != "theta"}
    ju = jax.vmap(lambda p: jutil.unconstrain_fn(jmodel, J_ARGS, {}, p))(latent)
    want = jax.vmap(lambda p: jutil.constrain_fn(jmodel, J_ARGS, {}, p,
                                                 return_deterministic=True))(ju)
    np.testing.assert_allclose(flat["theta"].numpy(), want["theta"], rtol=RTOL, atol=1e-5)


def test_hmcecs_postprocess_replays_deterministic_sites():
    """A subsampled model with a deterministic site: ``HMCECS``'s
    postprocessing replays it draw by draw."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((200, 2)).astype(np.float32))
    yb = torch.from_numpy((rng.random(200) < 0.5).astype(np.float32))

    def model(x, y):
        w = npt.sample("w", dist.Normal(torch.zeros(2), 1.0).to_event(1))
        npt.deterministic("w_norm", (w * w).sum().sqrt())
        with npt.plate("N", x.shape[0], subsample_size=50):
            xs = npt.subsample(x, event_dim=1)
            ys = npt.subsample(y, event_dim=0)
            npt.sample("obs", dist.Bernoulli(logits=xs @ w), obs=ys)

    kernel = HMCECS(NUTS(model, max_tree_depth=3), num_blocks=5)
    mcmc = MCMC(kernel, num_warmup=5, num_samples=4, num_chains=2, device="cpu")
    mcmc.run(0, x, yb)
    z = mcmc.get_samples(group_by_chain=True)
    assert set(z) == {"w", "w_norm"} and z["w_norm"].shape == (2, 4)
    torch.testing.assert_close(z["w_norm"], z["w"].norm(dim=-1), rtol=1e-6, atol=1e-6)


def test_reparam_consumes_the_site_into_a_deterministic_record():
    _, tmodel = models("loc_scale_0")
    tr = handlers.trace(handlers.seed(tmodel, 0)).get_trace(*T_ARGS)
    assert tr["theta"]["type"] == "deterministic"
    assert set(tr["theta"]) == {"type", "name", "value", "cond_indep_stack"}
    assert tr["theta_decentered"]["type"] == "sample"
    # a reparameterizer that keeps the site (centered=1) leaves it a sample site
    kept = handlers.reparam(torch_model, config={"theta": reparam.LocScaleReparam(1)})
    assert handlers.trace(handlers.seed(kept, 0)).get_trace(*T_ARGS)["theta"]["type"] == "sample"
    by_fn = handlers.reparam(torch_model, config=lambda msg: reparam.LocScaleReparam(0)
                             if msg["name"] == "theta" else None)
    assert "theta_decentered" in handlers.trace(handlers.seed(by_fn, 0)).get_trace(*T_ARGS)


def test_unported_reparameterizers_and_observed_sites_raise():
    # ProjectedNormalReparam and CircularReparam are ported
    # (tests/test_torch_circular_reparam.py holds their potentials against
    # JAX's): each is made as the JAX package's is and rewrites its site
    for cls, fn, site in ((reparam.ProjectedNormalReparam,
                           dist.ProjectedNormal(torch.tensor([2.0, 0.0, 0.0])), "d_normal"),
                          (reparam.CircularReparam, dist.VonMises(0.5, 3.0), "d_unwrapped")):
        model = handlers.reparam(lambda: npt.sample("d", fn), config={"d": cls()})
        tr = handlers.trace(handlers.seed(handlers.substitute(
            model, data={site: torch.ones(fn.event_shape)}), 0)).get_trace()
        assert tr["d"]["type"] == "deterministic" and site in tr
    # NeuTraReparam is ported (tests/test_torch_flow_guides.py); like the JAX
    # package's, it refuses a guide that has no transport
    for module in (reparam, jreparam):
        with pytest.raises(AttributeError):
            module.NeuTraReparam(object(), {})
    observed = handlers.reparam(torch_model, config={"obs": reparam.LocScaleReparam(0)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        handlers.trace(handlers.seed(observed, 0)).get_trace(*T_ARGS)
    # the JAX package fails an assertion there (ROADMAP.md, Queue 3)
    jobserved = jhandlers.reparam(jax_model, config={"obs": jreparam.LocScaleReparam(0)})
    with pytest.raises(AssertionError):
        jhandlers.trace(jhandlers.seed(jobserved, random.PRNGKey(0))).get_trace(*J_ARGS)
    positive = handlers.reparam(torch_model, config={"tau": reparam.LocScaleReparam(0)})
    with pytest.raises(ValueError, match="real-valued"):
        handlers.trace(handlers.seed(positive, 0)).get_trace(*T_ARGS)


def test_learned_centering_under_svi_matches_jax(monkeypatch):
    """``LocScaleReparam(centered=None)`` adds a ``theta_centered`` param in
    the unit interval: the loss and its gradient (with respect to the
    guide's params and ``theta_centered``) match JAX's on JAX's draws."""
    jmodel = jhandlers.reparam(jax_model, config={"theta": jreparam.LocScaleReparam()})
    tmodel = handlers.reparam(torch_model, config={"theta": reparam.LocScaleReparam()})
    _check_loss_and_grad("AutoNormal", "Trace_ELBO", 1, jmodel, tmodel, J_ARGS, T_ARGS,
                         monkeypatch, (2e-5, 1e-4, 1e-4))


def test_short_non_centred_run_matches_jax():
    """4 chains, 60 + 50, ``target_accept_prob=0.9``: posterior means of
    ``mu``, ``tau`` and the deterministic ``theta`` against the JAX
    package's run by Monte-Carlo error."""
    jmodel, tmodel = models("loc_scale_0")
    jm = jinfer.MCMC(jinfer.NUTS(jmodel, target_accept_prob=0.9), num_warmup=60,
                     num_samples=50, num_chains=4, progress_bar=False)
    jm.run(random.PRNGKey(0), *J_ARGS)
    tm = MCMC(NUTS(tmodel, target_accept_prob=0.9), num_warmup=60, num_samples=50,
              num_chains=4, device="cpu")
    tm.run(0, *T_ARGS)
    jz, tz = jm.get_samples(group_by_chain=True), tm.get_samples(group_by_chain=True)
    assert tz["theta"].shape == (4, 50, 8)
    for k in ("mu", "tau", "theta"):
        mc_agree(tz[k].numpy(), jz[k])
