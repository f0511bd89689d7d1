"""SVI in the port against the JAX package: one ``Trace_ELBO``,
``TraceMeanField_ELBO`` and ``RenyiELBO`` loss and its gradient for each
ported guide, at the same params and on the same noise; a whole
deterministic run of ``AutoDelta``; the ``SVI`` driver's API.

The noise: JAX's draws are recovered from its own guide trace at the keys its
ELBO derives (``(value - loc) / scale``, or through the Cholesky factor) and
handed to the port, whose ``torch.randn`` is replaced for the call by a
function that returns them in draw order.  Under ``vmap`` over particles the
draws are indexed by the (batched) particle index, through a callable
``vectorize_particles``.

JAX's ``AutoContinuous`` samples its packed latent from
``posterior.mask(False)``, which leaves ``log q`` out of the guide's density
(ROADMAP.md, Queue 3); for the packed guides the JAX reference below adds
that term back, computed by the JAX package itself.

Tolerances: losses to ``rtol=2e-5`` (float32 sums of a few hundred terms in
another order), gradients to ``rtol=1e-4, atol=1e-4``; through the GLM op
in f32 mode, where the port sums the log-likelihood in float64 and JAX in
float32, ``rtol=1e-4`` on the loss and ``rtol=1e-3, atol=1e-3`` on the
gradients (``tests/test_torch_glm.py``).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random
from jax.scipy.linalg import solve_triangular

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
import numpyro_tpu.infer.autoguide as jautoguide
import numpyro_tpu.optim as joptim
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.ops import glm as jglm
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
import numpyro_tpu_torch.infer.autoguide as autoguide
import numpyro_tpu_torch.optim as optim
from numpyro_tpu_torch import handlers, infer
from numpyro_tpu_torch.infer import SVI, RenyiELBO, Trace_ELBO, TraceMeanField_ELBO
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)

LOSS_RTOL, G_RTOL, G_ATOL = 2e-5, 1e-4, 1e-4
GLM_LOSS_RTOL, GLM_G_RTOL, GLM_G_ATOL = 1e-4, 1e-3, 1e-3
GUIDES = ["AutoNormal", "AutoDelta", "AutoDiagonalNormal", "AutoMultivariateNormal"]


# ---------------------------------------------------------------------------
# models: the horseshoe of examples/horseshoe_regression.py at a small size,
# and a logistic regression through the fused GLM op
# ---------------------------------------------------------------------------


def horseshoe_data(n=30, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    beta = np.zeros(d)
    beta[:2] = rng.randn(2) * 2.0
    y = X @ beta + 0.5 * rng.randn(n)
    return X.astype(np.float32), y.astype(np.float32)


def jax_horseshoe(X, y):
    d = X.shape[1]
    tau = numpyro_tpu.sample("tau", jdist.HalfCauchy(0.1))
    with numpyro_tpu.plate("D", d):
        lam = numpyro_tpu.sample("lambda", jdist.HalfCauchy(1.0))
    sigma = numpyro_tpu.sample("sigma", jdist.HalfNormal(1.0))
    with numpyro_tpu.plate("D2", d):
        beta = numpyro_tpu.sample("beta", jdist.Normal(0.0, tau * lam))
    with numpyro_tpu.plate("N", X.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(X @ beta, sigma), obs=y)


def torch_horseshoe(X, y):
    d = X.shape[1]
    tau = npt.sample("tau", dist.HalfCauchy(0.1))
    with npt.plate("D", d):
        lam = npt.sample("lambda", dist.HalfCauchy(1.0))
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    with npt.plate("D2", d):
        beta = npt.sample("beta", dist.Normal(0.0, tau * lam))
    with npt.plate("N", X.shape[0]):
        npt.sample("y", dist.Normal(X @ beta, sigma), obs=y)


def logreg_data(n=32_000, d=6, seed=0):
    """N a little below a multiple of 32,768, so that JAX's plain path keeps
    its padding error under 1e-5 (ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, d - 1)), np.ones((n, 1))], 1).astype(np.float32)
    w = (0.5 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w))).astype(np.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=jnp.float32)
    td = glm.from_numpy_glm_data(np.asarray(jd.x_t), np.asarray(jd.y_row), jd.n, jd.d,
                                 torch.float32)
    return jd, td, w


def jax_logreg(data):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(data.d), 1.0).to_event(1))
    numpyro_tpu.factor("lik", jglm.bernoulli_logits_loglik(w, data))


def torch_logreg(data):
    w = npt.sample("w", dist.Normal(torch.zeros(data.d), 1.0).to_event(1))
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


# ---------------------------------------------------------------------------
# noise handed from JAX to the port
# ---------------------------------------------------------------------------

_QUEUE = []


def _fake_randn(*size, generator=None, device=None, dtype=None, **kw):
    shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
    x = _QUEUE.pop(0)
    assert tuple(x.shape) == tuple(shape), (x.shape, shape)
    return x


@contextlib.contextmanager
def fed_noise(monkeypatch, draws):
    """The port's ``torch.randn`` returns ``draws`` in order."""
    _QUEUE[:] = list(draws)
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", _fake_randn)
        yield
    assert not _QUEUE, "the port drew less than it was handed"


def fed_particles(tables):
    """A ``vectorize_particles`` callable: ``vmap`` over particles whose i-th
    particle draws ``table[i]`` of each table, in order."""

    def particle_fn(one):
        def body(i):
            _QUEUE[:] = [t[i] for t in tables]
            return one(i)

        return lambda particles: torch.func.vmap(body, randomness="different")(particles)

    return particle_fn


def _guide_seeds(key, num_particles, per_particle_keys):
    """The keys with which JAX's ELBO seeds the guide of each particle."""
    if not per_particle_keys:
        return [random.split(key)[1]]
    return [random.split(k)[1] for k in random.split(key, num_particles)]


def jax_noise(jguide, name, params, seeds, args):
    """Standard-normal draws of JAX's guide at ``seeds``, in the port's draw
    order: one ``(P, ...)`` table per draw."""
    per_seed = []
    for seed in seeds:
        tr = jhandlers.trace(
            jhandlers.substitute(jhandlers.seed(jguide, seed), data=params)
        ).get_trace(*args)
        if name == "AutoNormal":
            eps = []
            for site_name, site in tr.items():
                if site["type"] != "sample" or site["is_observed"]:
                    continue
                u = site["intermediates"][0][0] if site["intermediates"] else site["value"]
                loc = params[f"auto_{site_name}_loc"]
                scale = params[f"auto_{site_name}_scale"]
                eps.append((u - loc) / scale)
        elif name == "AutoDiagonalNormal":
            latent = tr["_auto_latent"]["value"]
            eps = [(latent - params["auto_loc"]) / params["auto_scale"]]
        elif name == "AutoMultivariateNormal":
            latent = tr["_auto_latent"]["value"]
            eps = [solve_triangular(params["auto_scale_tril"], latent - params["auto_loc"],
                                    lower=True)]
        else:
            eps = []
        per_seed.append([np.asarray(e) for e in eps])
    return [np.stack(col) for col in zip(*per_seed)]


def _missing_log_q(jguide, name, params, noise):
    """log q of the packed latent at each particle's draw, which JAX's
    ``AutoContinuous`` leaves out of its guide's density."""
    if name not in ("AutoDiagonalNormal", "AutoMultivariateNormal"):
        return 0.0
    (eps,) = noise
    latent = jguide.get_transform(params)(jnp.asarray(eps))
    return jguide.get_posterior(params).log_prob(latent)


# ---------------------------------------------------------------------------
# one loss and its gradient in both packages
# ---------------------------------------------------------------------------


def _both_svis(name, jloss, tloss, jmodel, tmodel, jargs, targs):
    jguide = getattr(jautoguide, name)(jmodel)
    jsvi = jinfer.SVI(jmodel, jguide, joptim.Adam(0.01), jloss)
    jstate = jsvi.init(random.PRNGKey(0), *jargs)
    tguide = getattr(autoguide, name)(tmodel)
    tsvi = SVI(tmodel, tguide, optim.Adam(0.01), tloss, device="cpu")
    tstate = tsvi.init(0, *targs)
    uj = jsvi.optim.get_params(jstate[0])
    ut = tsvi.optim.get_params(tstate.optim_state)
    assert {k: tuple(np.shape(v)) for k, v in uj.items()} == {
        k: tuple(v.shape) for k, v in ut.items()}
    # the same unconstrained params in both: JAX's init, moved by a seeded step
    rng = np.random.default_rng(7)
    u = {k: (np.asarray(v) + 0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
         for k, v in uj.items()}
    return jguide, jsvi, tguide, tsvi, u


def _jax_value_and_grad(name, kind, jloss, jguide, jsvi, jmodel, jargs, key, noise, u):
    num_particles = jloss.num_particles

    def fn(u):
        params = jsvi.constrain_fn(u)
        if kind == "RenyiELBO":
            keys = random.split(key, num_particles)
            log_w = jax.vmap(
                lambda k: jloss._log_weight(k, params, jmodel, jguide, jargs, {})
            )(keys)
            log_w = log_w - _missing_log_q(jguide, name, params, noise)
            tempered = (1.0 - jloss.alpha) * log_w
            log_mean = jax.scipy.special.logsumexp(tempered) - jnp.log(num_particles)
            weights = jnp.exp(tempered - log_mean)
            bound = log_mean / (1.0 - jloss.alpha)
            inner = jnp.dot(jax.lax.stop_gradient(weights), log_w) / num_particles
            return -(jax.lax.stop_gradient(bound - inner) + inner)
        loss = jloss.loss(key, params, jmodel, jguide, *jargs)
        return loss + jnp.mean(_missing_log_q(jguide, name, params, noise))

    val, grad = jax.value_and_grad(fn)({k: jnp.asarray(v) for k, v in u.items()})
    return float(val), {k: np.asarray(v) for k, v in grad.items()}


def _torch_value_and_grad(tloss, tsvi, tmodel, tguide, targs, u, noise, monkeypatch):
    def fn(ut):
        return tloss.loss(torch.Generator().manual_seed(0), tsvi.constrain_fn(ut), tmodel,
                          tguide, *targs)

    ut = {k: torch.tensor(v) for k, v in u.items()}
    if tloss.num_particles == 1 and not isinstance(tloss, RenyiELBO):
        with fed_noise(monkeypatch, [torch.tensor(t[0]) for t in noise]):
            grad, val = torch.func.grad_and_value(fn)(ut)
    else:
        tloss.vectorize_particles = fed_particles([torch.tensor(t) for t in noise])
        with monkeypatch.context() as m:
            m.setattr(torch, "randn", _fake_randn)
            grad, val = torch.func.grad_and_value(fn)(ut)
    return val.item(), {k: v.numpy() for k, v in grad.items()}


def _elbos(kind, num_particles):
    if kind == "Trace_ELBO":
        return jinfer.Trace_ELBO(num_particles=num_particles), Trace_ELBO(num_particles)
    if kind == "TraceMeanField_ELBO":
        return (jinfer.TraceMeanField_ELBO(num_particles=num_particles),
                TraceMeanField_ELBO(num_particles))
    return jinfer.RenyiELBO(alpha=0.5, num_particles=num_particles), RenyiELBO(0.5, num_particles)


def _check_loss_and_grad(name, kind, num_particles, jmodel, tmodel, jargs, targs, monkeypatch,
                         tols):
    jloss, tloss = _elbos(kind, num_particles)
    jguide, jsvi, tguide, tsvi, u = _both_svis(name, jloss, tloss, jmodel, tmodel, jargs, targs)
    key = random.PRNGKey(3)
    params = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    seeds = _guide_seeds(key, num_particles, num_particles > 1 or kind == "RenyiELBO")
    noise = jax_noise(jguide, name, params, seeds, jargs)
    jval, jgrad = _jax_value_and_grad(name, kind, jloss, jguide, jsvi, jmodel, jargs, key,
                                      noise, u)
    tval, tgrad = _torch_value_and_grad(tloss, tsvi, tmodel, tguide, targs, u, noise,
                                        monkeypatch)
    loss_rtol, g_rtol, g_atol = tols
    np.testing.assert_allclose(tval, jval, rtol=loss_rtol)
    assert set(tgrad) == set(jgrad)
    for k in jgrad:
        np.testing.assert_allclose(tgrad[k], jgrad[k], rtol=g_rtol, atol=g_atol, err_msg=k)


@pytest.mark.parametrize("name", GUIDES)
@pytest.mark.parametrize("kind,num_particles", [
    ("Trace_ELBO", 1), ("Trace_ELBO", 3), ("TraceMeanField_ELBO", 1), ("RenyiELBO", 3),
])
def test_loss_and_gradient_match_jax_on_the_horseshoe(name, kind, num_particles, monkeypatch):
    X, y = horseshoe_data()
    _check_loss_and_grad(
        name, kind, num_particles, jax_horseshoe, torch_horseshoe,
        (jnp.asarray(X), jnp.asarray(y)), (torch.tensor(X), torch.tensor(y)), monkeypatch,
        (LOSS_RTOL, G_RTOL, G_ATOL),
    )


@pytest.mark.parametrize("name", ["AutoNormal", "AutoDiagonalNormal", "AutoMultivariateNormal"])
def test_eight_particles_through_the_glm_op_match_jax(name, monkeypatch):
    """All eight particles reach the GLM op's vmap rule in one evaluation,
    and the gradient goes back through the op's saved gradient with a
    cotangent of -1/8 per particle."""
    jd, td, _ = logreg_data()
    glm.reset_launch_counts()
    _check_loss_and_grad(
        name, "Trace_ELBO", 8, jax_logreg, torch_logreg, (jd,), (td,), monkeypatch,
        (GLM_LOSS_RTOL, GLM_G_RTOL, GLM_G_ATOL),
    )
    # SVI.init's traces, then ONE plain evaluation for the eight particles
    init_calls = glm.launch_counts["plain"] - 1
    assert init_calls == 3


def test_glm_op_cotangent_of_a_particle_mean_matches_jax():
    jd, td, _ = logreg_data(n=30_000, d=5)
    W = (0.3 * np.random.default_rng(1).standard_normal((8, 5))).astype(np.float32)
    g_j = jax.grad(lambda W: -jnp.mean(jax.vmap(lambda w: jglm.bernoulli_logits_loglik(w, jd))(W)))(
        jnp.asarray(W))
    g_t = torch.func.grad(
        lambda W: -torch.func.vmap(lambda w: glm.bernoulli_logits_loglik(w, td))(W).mean()
    )(torch.tensor(W))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=GLM_G_RTOL, atol=GLM_G_ATOL)


def test_plain_op_matches_the_kernel_op_on_the_cpu():
    _, td, _ = logreg_data(n=30_000, d=5)
    W = torch.tensor(0.3 * np.random.default_rng(2).standard_normal((4, 5)), dtype=torch.float32)

    def loss(fn):
        return torch.func.grad_and_value(
            lambda W: -torch.func.vmap(lambda w: fn(w, td))(W).mean())(W)

    for a, b in zip(loss(glm.bernoulli_logits_loglik), loss(glm.plain_bernoulli_logits_loglik)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# a whole deterministic run
# ---------------------------------------------------------------------------


def test_autodelta_200_steps_match_jax():
    """Full-batch Trace_ELBO with AutoDelta draws nothing: from the same
    init_params both packages take the same 200 Adam steps (rtol 1e-4)."""
    jd, td, _ = logreg_data()
    w0 = (0.1 * np.random.default_rng(3).standard_normal(jd.d)).astype(np.float32)
    jsvi = jinfer.SVI(jax_logreg, jautoguide.AutoDelta(jax_logreg), joptim.Adam(0.01),
                      jinfer.Trace_ELBO())
    jres = jsvi.run(random.PRNGKey(0), 200, jd, init_params={"auto_w_loc": jnp.asarray(w0)})
    tsvi = SVI(torch_logreg, autoguide.AutoDelta(torch_logreg), optim.Adam(0.01), Trace_ELBO(),
               device="cpu")
    tres = tsvi.run(0, 200, td, init_params={"auto_w_loc": torch.tensor(w0)})
    assert tres.losses.shape == (200,)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-4)
    np.testing.assert_allclose(tres.params["auto_w_loc"].numpy(),
                               np.asarray(jres.params["auto_w_loc"]), rtol=1e-4, atol=1e-6)


def test_autonormal_reaches_jax_optimum_on_a_conjugate_model():
    """A statistical run on the port's own generator: the Normal-Normal
    model's posterior is N(m, s), which AutoNormal holds exactly; both
    packages must land near it and near each other (Monte Carlo noise of
    2,000 one-particle steps at a decaying step size)."""
    rng = np.random.default_rng(4)
    x = (1.5 + rng.standard_normal(40)).astype(np.float32)

    def jmodel(x):
        mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, 1.0))
        with numpyro_tpu.plate("N", x.shape[0]):
            numpyro_tpu.sample("x", jdist.Normal(mu, 1.0), obs=x)

    def tmodel(x):
        mu = npt.sample("mu", dist.Normal(0.0, 1.0))
        with npt.plate("N", x.shape[0]):
            npt.sample("x", dist.Normal(mu, 1.0), obs=x)

    n = x.shape[0]
    m, s = x.sum() / (n + 1), (1.0 / (n + 1)) ** 0.5
    schedule = lambda i: 0.05 / (1.0 + i / 200.0)  # noqa: E731
    jres = jinfer.SVI(jmodel, jautoguide.AutoNormal(jmodel), joptim.Adam(schedule),
                      jinfer.Trace_ELBO()).run(random.PRNGKey(1), 2000, jnp.asarray(x))
    tres = SVI(tmodel, autoguide.AutoNormal(tmodel), optim.Adam(schedule), Trace_ELBO(),
               device="cpu").run(1, 2000, torch.tensor(x))
    for params, get in ((jres.params, lambda v: float(v)), (tres.params, lambda v: v.item())):
        assert abs(get(params["auto_mu_loc"]) - m) < 0.05
        assert abs(get(params["auto_mu_scale"]) - s) < 0.05
    assert abs(tres.params["auto_mu_loc"].item() - float(jres.params["auto_mu_loc"])) < 0.07


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _small_svi(loss=None, guide_cls=autoguide.AutoNormal, **kw):
    X, y = horseshoe_data()
    svi = SVI(torch_horseshoe, guide_cls(torch_horseshoe), optim.Adam(0.01),
              loss or Trace_ELBO(), **kw)
    return svi, (torch.tensor(X), torch.tensor(y))


def test_svi_defaults_to_cuda_and_never_falls_back():
    svi, args = _small_svi()
    assert svi.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            svi.init(0, *args)
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            svi.run(0, 2, *args)
    svi, args = _small_svi(device="cpu")
    with pytest.raises(TypeError, match="int seed or a torch.Generator"):
        svi.init(1.5, *args)


def test_run_pins_full_f32_matmuls_and_keeps_losses_on_the_device():
    svi, args = _small_svi(device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    res = svi.run(0, 5, *args)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert isinstance(res.losses, torch.Tensor) and res.losses.shape == (5,)
    assert torch.isfinite(res.losses).all()
    assert set(res.params) == {f"auto_{s}_{p}" for s in ("tau", "lambda", "sigma", "beta")
                               for p in ("loc", "scale")}
    assert (res.params["auto_tau_scale"] > 0).all()
    # the progress bar (ported since) leaves the steps as they are
    assert torch.equal(svi.run(0, 5, *args, progress_bar=True).losses, res.losses)


def test_evaluate_gives_the_loss_of_the_next_update():
    svi, args = _small_svi(device="cpu")
    state = svi.init(0, *args)
    before = state.rng_key.get_state()
    loss = svi.evaluate(state, *args)
    assert torch.equal(state.rng_key.get_state(), before)
    _, step_loss = svi.update(state, *args)
    torch.testing.assert_close(loss, step_loss, rtol=0, atol=0)


def test_run_from_an_init_state_continues_the_run():
    svi, args = _small_svi(device="cpu")
    whole = svi.run(0, 6, *args)
    first = svi.run(0, 3, *args)
    rest = svi.run(None, 3, *args, init_state=first.state)
    torch.testing.assert_close(torch.cat([first.losses, rest.losses]), whole.losses)
    for k in whole.params:
        torch.testing.assert_close(rest.params[k], whole.params[k])


def test_stable_update_keeps_the_state_where_the_loss_is_nan():
    svi, (X, y) = _small_svi(device="cpu")
    state = svi.init(0, X, y)
    bad = torch.full_like(y, torch.nan)
    new, loss = svi.stable_update(state, X, bad)
    assert torch.isnan(loss)
    old_p, new_p = svi.get_params(state), svi.get_params(new)
    for k in old_p:
        assert torch.equal(old_p[k], new_p[k])
    new, loss = svi.update(state, X, bad)
    assert torch.isnan(loss)


def test_init_params_override_the_guide_init():
    svi, args = _small_svi(device="cpu", guide_cls=autoguide.AutoDelta)
    state = svi.init(0, *args, init_params={"auto_tau_loc": torch.tensor(0.7)})
    torch.testing.assert_close(svi.get_params(state)["auto_tau_loc"], torch.tensor(0.7))


def test_mutable_state_is_threaded_through_steps():
    def model():
        count = npt.mutable("count", {"n": torch.tensor(0.0)})
        npt.sample("x", dist.Normal(0.0, 1.0))
        count["n"] = count["n"] + 1.0

    def guide():
        loc = npt.param("loc", torch.tensor(0.5))
        npt.sample("x", dist.Normal(loc, 1.0))

    svi = SVI(model, guide, optim.Adam(0.1), Trace_ELBO(), device="cpu")
    state = svi.init(0)
    assert set(state.mutable_state) == {"count"}
    state, _ = svi.update(state)
    assert float(state.mutable_state["count"]["n"]) >= 1.0
    with pytest.raises(ValueError, match="multi-particle"):
        SVI(model, guide, optim.Adam(0.1), Trace_ELBO(2), device="cpu").run(0, 1)


def test_loop_and_vmap_over_particles_agree_on_the_same_draws(monkeypatch):
    X, y = horseshoe_data()
    args = (torch.tensor(X), torch.tensor(y))
    guide = autoguide.AutoNormal(torch_horseshoe)
    svi = SVI(torch_horseshoe, guide, optim.Adam(0.01), Trace_ELBO(4), device="cpu")
    state = svi.init(0, *args)
    params = svi.get_params(state)
    gen = torch.Generator().manual_seed(5)
    tables = [torch.randn((4,) + tuple(params[f"auto_{s}_loc"].shape), generator=gen)
              for s in ("tau", "lambda", "sigma", "beta")]
    vm = Trace_ELBO(4, vectorize_particles=fed_particles(tables))
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", _fake_randn)
        vmapped = vm.loss(torch.Generator(), params, torch_horseshoe, guide, *args)
    looped = 0.0
    for i in range(4):
        with fed_noise(monkeypatch, [t[i] for t in tables]):
            looped = looped + Trace_ELBO().loss(torch.Generator(), params, torch_horseshoe,
                                                guide, *args)
    torch.testing.assert_close(vmapped, looped / 4, rtol=1e-6, atol=1e-4)


def test_vmapped_particles_draw_differently_and_loop_matches_their_law():
    svi, args = _small_svi(device="cpu", loss=Trace_ELBO(num_particles=64))
    state = svi.init(0, *args)
    params = svi.get_params(state)
    guide = svi.guide
    draws = torch.func.vmap(
        lambda i: handlers.seed(guide, torch.Generator().manual_seed(9))(*args)["beta"],
        randomness="different",
    )(torch.arange(64))
    assert draws.shape == (64, 4)
    assert len({tuple(r.tolist()) for r in draws}) == 64


def test_unported_objectives_raise():
    # TraceGraph_ELBO is ported: it builds and evaluates a loss
    def score_model():
        npt.sample("c", dist.Bernoulli(0.3))

    def score_guide():
        npt.sample("c", dist.Bernoulli(0.4))

    loss = infer.TraceGraph_ELBO().loss(torch.Generator().manual_seed(0), {}, score_model,
                                        score_guide)
    assert loss.shape == () and torch.isfinite(loss)

    # TraceEnum_ELBO is ported, save for guide-side enumeration
    def model():
        npt.sample("c", dist.Bernoulli(0.3))

    def guide():
        npt.sample("c", dist.Bernoulli(0.4), infer={"enumerate": "parallel"})

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        infer.TraceEnum_ELBO().loss(torch.Generator().manual_seed(0), {}, model, guide)


def test_guide_and_model_shape_mismatch_raises():
    def model():
        npt.sample("x", dist.Normal(torch.zeros(3), 1.0).to_event(1))

    def guide():
        npt.sample("x", dist.Normal(torch.zeros(2), 1.0).to_event(1))

    with pytest.raises(ValueError, match="shapes disagree"):
        Trace_ELBO().loss(torch.Generator().manual_seed(0), {}, model, guide)


# ---------------------------------------------------------------------------
# param sites through the handlers
# ---------------------------------------------------------------------------


def _param_model():
    a = npt.param("a", torch.tensor(1.0))
    b = npt.param("b", lambda key: torch.rand((), generator=key), constraint=dist.constraints.positive)
    npt.sample("x", dist.Normal(a * b, 1.0))


def _jax_param_model():
    a = numpyro_tpu.param("a", jnp.asarray(1.0))
    b = numpyro_tpu.param("b", lambda key: random.uniform(key, ()),
                          constraint=jdist.constraints.positive)
    numpyro_tpu.sample("x", jdist.Normal(a * b, 1.0))


def test_param_sites_pass_through_the_handlers_as_in_jax():
    tr = handlers.trace(handlers.seed(_param_model, 0)).get_trace()
    jtr = jhandlers.trace(jhandlers.seed(_jax_param_model, 0)).get_trace()
    assert [(k, s["type"]) for k, s in tr.items()] == [(k, s["type"]) for k, s in jtr.items()]
    assert tr["b"]["kwargs"]["constraint"] is dist.constraints.positive
    # substitute binds params, condition leaves them, block hides them
    sub = handlers.trace(handlers.substitute(handlers.seed(_param_model, 0),
                                             data={"a": torch.tensor(3.0)})).get_trace()
    assert sub["a"]["value"].item() == 3.0
    cond = handlers.trace(handlers.condition(handlers.seed(_param_model, 0),
                                             data={"a": torch.tensor(3.0)})).get_trace()
    assert cond["a"]["value"].item() == 1.0
    blocked = handlers.trace(handlers.block(handlers.seed(_param_model, 0),
                                            hide=["a"])).get_trace()
    assert "a" not in blocked and "b" in blocked
    # replay takes recorded values at param and sample sites alike
    rep = handlers.trace(handlers.replay(handlers.seed(_param_model, 1), tr)).get_trace()
    assert all(torch.equal(rep[k]["value"], tr[k]["value"]) for k in ("a", "b", "x"))
    with pytest.raises(ValueError, match="callable init_value"):
        npt.param("c", lambda key: 0.0)
    assert npt.param("c", 2.0) == 2.0


def test_replay_refuses_a_site_of_another_type():
    tr = handlers.trace(handlers.seed(_param_model, 0)).get_trace()
    tr["a"] = dict(tr["x"], name="a")

    with pytest.raises(RuntimeError, match="must be param"):
        handlers.replay(handlers.seed(_param_model, 0), tr)()


@pytest.mark.parametrize("name", ["AutoDiagonalNormal", "AutoMultivariateNormal"])
def test_packed_guides_keep_log_q_where_jax_drops_it(name):
    """On a standard normal target the packed guides should learn unit
    scales.  JAX's ``AutoContinuous`` leaves ``log q`` of its packed latent
    out (``posterior.mask(False)``), so its scales collapse towards zero and
    the loss settles at -log p at the mode, 2 x 0.9189 here; the port keeps
    the term (ROADMAP.md, Queue 3)."""

    def jmodel():
        numpyro_tpu.sample("x", jdist.Normal(jnp.zeros(2), 1.0).to_event(1))

    def tmodel():
        npt.sample("x", dist.Normal(torch.zeros(2), 1.0).to_event(1))

    jguide, tguide = getattr(jautoguide, name)(jmodel), getattr(autoguide, name)(tmodel)
    jres = jinfer.SVI(jmodel, jguide, joptim.Adam(0.05), jinfer.Trace_ELBO(8)).run(
        random.PRNGKey(0), 1000)
    tres = SVI(tmodel, tguide, optim.Adam(0.05), Trace_ELBO(8), device="cpu").run(0, 1000)
    jstd = np.sqrt(np.diag(np.asarray(jguide.get_posterior(jres.params).covariance_matrix))
                   if name == "AutoMultivariateNormal"
                   else np.asarray(jres.params["auto_scale"]) ** 2)
    tpost = tguide.get_posterior(tres.params)
    tstd = (tpost.variance if name == "AutoMultivariateNormal" else tres.params["auto_scale"] ** 2)
    tstd = tstd.detach().sqrt().numpy()
    assert (jstd < 0.1).all()
    np.testing.assert_allclose(tstd, 1.0, rtol=0.2)
    np.testing.assert_allclose(float(np.asarray(jres.losses[-100:]).mean()), 2 * 0.9189, rtol=0.02)


def test_get_importance_trace_matches_jax():
    """The model replayed against an AutoDelta guide (no draws): every sample
    site's scaled log-prob in both traces."""
    from numpyro_tpu.infer.util import get_importance_trace as jget
    from numpyro_tpu_torch.infer.util import get_importance_trace as tget

    X, y = horseshoe_data()
    jguide, jsvi, tguide, tsvi, u = _both_svis(
        "AutoDelta", jinfer.Trace_ELBO(), Trace_ELBO(), jax_horseshoe, torch_horseshoe,
        (jnp.asarray(X), jnp.asarray(y)), (torch.tensor(X), torch.tensor(y)))
    jp = jsvi.constrain_fn({k: jnp.asarray(v) for k, v in u.items()})
    tp = tsvi.constrain_fn({k: torch.tensor(v) for k, v in u.items()})
    jm, jg = jget(jhandlers.seed(jax_horseshoe, 0), jhandlers.seed(jguide, 0),
                  (jnp.asarray(X), jnp.asarray(y)), {}, jp)
    tm, tg = tget(handlers.seed(torch_horseshoe, 0), handlers.seed(tguide, 0),
                  (torch.tensor(X), torch.tensor(y)), {}, tp)
    for jt, tt in ((jm, tm), (jg, tg)):
        names = [k for k, s in jt.items() if s["type"] == "sample"]
        assert names == [k for k, s in tt.items() if s["type"] == "sample"]
        for k in names:
            np.testing.assert_allclose(tt[k]["log_prob"].numpy(), np.asarray(jt[k]["log_prob"]),
                                       rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
