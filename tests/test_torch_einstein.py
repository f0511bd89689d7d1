"""The port's ``contrib.einstein`` (SteinVI, SVGD, ASVGD, the Stein kernels,
``SteinLoss`` and ``MixtureGuidePredictive``) against the JAX package's, on
numpy-seeded particles and data.

- The flat layout (``batch_ravel_pytree``: a dict by sorted key) and the
  particle index ranges, exactly.
- ``median_bandwidth`` at an even and an odd count of pairs, and each
  kernel's ``k(x, y)`` over all pairs in every mode (rtol 1e-5).
- The Stein force of SVGD in every mode, from the same particles (the
  objective draws nothing): the loss to rtol 1e-5, the force to rtol 1e-5
  with an atol of 1e-6 of its largest component (a force is a difference of
  an attractive and a repulsive sum, which rounds in another order); 2e-5
  for the random-feature kernels (``RF_FORCE_ATOL``).
- 20 steps of SVGD and ASVGD from the same particles (rtol 1e-4 on the
  particles, atol 1e-5), and the annealing schedule at every step, equal.
- ``SteinVI``'s initial jitter, one step (its loss and gradient, with
  ``RBFKernel``, ``ProbabilityProductKernel`` and ``RadialGaussNewtonKernel``,
  whose objective is particle 0's on particle 0's draws for every particle)
  and ``SteinLoss.loss`` on the JAX package's draws (rtol 1e-5), through a
  draw source; a short whole run held to the posterior as the JAX package's
  test holds its own.
- ``MixtureGuidePredictive`` on JAX's assignments and guide draws (rtol
  1e-5), the model's draws on the port's generator held to their law.
- SVGD through the GLM op (N = 2,000, D = 8, float32 storage) against the
  JAX package's ``glm`` on the CPU (rtol 1e-4).
- The card by default, and the raise without one.

The JAX package's draws reach the port through ``chip_smoke.TableDraws``: a
draw source whose ``at(i)`` takes the particle, the ELBO draw or the predictive
draw, and whose ``normals`` serve one table per guide site in the guide's
order, indexed by those (batched) indices.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.contrib.einstein as jein
import numpyro_tpu.distributions as jdist
import numpyro_tpu.optim as joptim
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.contrib.einstein.stein_kernels import median_bandwidth as jmedian_bandwidth
from numpyro_tpu.contrib.einstein.stein_util import batch_ravel_pytree as jbatch_ravel
from numpyro_tpu.infer.autoguide import AutoNormal as JAutoNormal
from numpyro_tpu.infer.initialization import init_to_value as jinit_to_value
from numpyro_tpu.ops import glm as jglm
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.contrib.einstein as ein
import numpyro_tpu_torch.distributions as dist
import numpyro_tpu_torch.optim as optim
from numpyro_tpu_torch.contrib.einstein.stein_kernels import median_bandwidth
from numpyro_tpu_torch.contrib.einstein.stein_util import batch_ravel_pytree
from numpyro_tpu_torch.contrib.einstein.steinvi import SteinVIState
from numpyro_tpu_torch.infer.autoguide import AutoNormal
from numpyro_tpu_torch.infer.initialization import init_to_value
from numpyro_tpu_torch.ops import glm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

RTOL, STEPS_RTOL, STEPS_ATOL, FORCE_ATOL = 1e-5, 1e-4, 1e-5, 1e-6
# the random-feature forces take cosines of arguments in the tens, whose
# float32 rounding both packages carry: each is about 1e-5 of the largest
# component off the float64 force, so they are held to 2e-5 of it
RF_FORCE_ATOL = 2e-5


# ---------------------------------------------------------------------------
# state and draws carried across
# ---------------------------------------------------------------------------


def to_torch(tree):
    """A JAX params dict (or tree) as the port's tensors, on the CPU."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def port_state(stein, params, rng_key=None):
    """The port's state at the JAX package's unconstrained particles."""
    return SteinVIState(stein.optim.init(to_torch(params)),
                        rng_key if rng_key is not None else torch.Generator().manual_seed(0))


def table_draws(tables, ints=()):
    """``chip_smoke.TableDraws`` of numpy ``tables`` and ``ints``."""
    return cs.TableDraws([torch.tensor(np.asarray(t, dtype=np.float32)) for t in tables],
                         [torch.tensor(np.asarray(i, dtype=np.int64)) for i in ints])


def guide_noise(jguide, params, key, args):
    """The standard-normal draws of JAX's ``AutoNormal`` ``jguide`` seeded
    with ``key`` at constrained ``params`` (one particle), by site in the
    guide's order: ``(base value - loc) / scale``."""
    tr = jhandlers.trace(jhandlers.substitute(jhandlers.seed(jguide, key), data=params)
                         ).get_trace(*args)
    out = []
    for name, site in tr.items():
        if site["type"] == "sample" and not site["is_observed"]:
            u = site["intermediates"][0][0] if site["intermediates"] else site["value"]
            loc, scale = params[f"auto_{name}_loc"], params[f"auto_{name}_scale"]
            out.append(np.asarray((u - loc) / scale))
    return out


def step_noise(js, state, args):
    """The draws of one JAX ``SteinVI.update`` from ``state``: one
    ``(P, E) + site shape`` table per guide site."""
    _, step_key = random.split(state.rng_key)
    params = js.get_params(state)
    score_keys = random.split(step_key, js.num_stein_particles)
    rows = []
    for i in range(js.num_stein_particles):
        p_i = {k: v[i] for k, v in params.items()}
        draw_keys = random.split(score_keys[i], js.num_elbo_particles)
        rows.append([guide_noise(js.guide, p_i, random.split(k)[0], args) for k in draw_keys])
    return [np.stack([np.stack([draws[s] for draws in row]) for row in rows])
            for s in range(len(rows[0][0]))]


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def jgauss():
    numpyro_tpu.sample("x", jdist.Normal(jnp.array([1.0, -1.0]), jnp.array([1.0, 0.5])).to_event(1))


def tgauss():
    npt.sample("x", dist.Normal(torch.tensor([1.0, -1.0]), torch.tensor([1.0, 0.5])).to_event(1))


def jtwo():
    a = numpyro_tpu.sample("a", jdist.Normal(jnp.array([1.0, -1.0]), jnp.array([1.0, 0.5]))
                           .to_event(1))
    numpyro_tpu.sample("b", jdist.Normal(0.5 * a.sum(), 0.7))


def ttwo():
    a = npt.sample("a", dist.Normal(torch.tensor([1.0, -1.0]), torch.tensor([1.0, 0.5]))
                   .to_event(1))
    npt.sample("b", dist.Normal(0.5 * a.sum(), 0.7))


REG_X = np.random.default_rng(0).standard_normal((12, 2)).astype(np.float32)
REG_Y = (REG_X @ np.array([0.8, -0.4], np.float32)
         + 0.3 * np.random.default_rng(1).standard_normal(12)).astype(np.float32)


def jreg(x, y):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(2), 1.0).to_event(1))
    prec = numpyro_tpu.sample("prec", jdist.Gamma(2.0, 1.0))
    with numpyro_tpu.plate("N", x.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(x @ w, 1 / jnp.sqrt(prec)), obs=y)


def treg(x, y):
    w = npt.sample("w", dist.Normal(torch.zeros(2), 1.0).to_event(1))
    prec = npt.sample("prec", dist.Gamma(2.0, 1.0))
    with npt.plate("N", x.shape[0]):
        npt.sample("y", dist.Normal(x @ w, 1 / torch.sqrt(prec)), obs=y)


# ---------------------------------------------------------------------------
# layout and bandwidth
# ---------------------------------------------------------------------------


def test_flat_layout_follows_jax_s_pytree_order():
    rng = np.random.default_rng(2)
    tree = {"zeta": rng.standard_normal((4, 3)), "alpha": {"w": rng.standard_normal((4, 2, 2)),
                                                           "b": rng.standard_normal((4,))},
            "mid": [rng.standard_normal((4, 1)), rng.standard_normal((4, 2))]}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    ttree = {"zeta": torch.tensor(tree["zeta"], dtype=torch.float32),
             "alpha": {k: torch.tensor(v, dtype=torch.float32)
                       for k, v in tree["alpha"].items()},
             "mid": [torch.tensor(v, dtype=torch.float32) for v in tree["mid"]]}
    jflat, jone, jbatch = jbatch_ravel(jtree)
    tflat, tone, tbatch = batch_ravel_pytree(ttree)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tbatch(tflat)
    # the port keeps the tree's own key order; only the flat layout sorts
    assert list(back) == ["zeta", "alpha", "mid"] and list(back["alpha"]) == ["w", "b"]
    for a, b in zip(jax.tree.leaves(jbatch(jflat)), jax.tree.leaves(to_numpy(back))):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(jax.tree.leaves(jone(jflat[1])), jax.tree.leaves(to_numpy(tone(tflat[1])))):
        np.testing.assert_array_equal(b, np.asarray(a))
    jflat0, _, _ = jbatch_ravel(jax.tree.map(lambda a: a[0], jtree), 0)
    tflat0, tone0, _ = batch_ravel_pytree({"zeta": ttree["zeta"][0], "alpha": {
        k: v[0] for k, v in ttree["alpha"].items()}, "mid": [v[0] for v in ttree["mid"]]}, 0)
    np.testing.assert_array_equal(tflat0.numpy(), np.asarray(jflat0))
    assert tone0(tflat0)["zeta"].shape == (3,)


def test_particle_info_sorts_names_as_the_layout_does():
    params = {"b_loc": torch.zeros(3, 2), "a_scale": torch.zeros(3, 4), "a_loc": torch.zeros(3)}
    info = ein.SteinVI._calc_particle_info(params)
    jinfo = jein.SteinVI._calc_particle_info({k: jnp.zeros(v.shape) for k, v in params.items()})
    assert info == jinfo == {"a_loc": (0, 1), "a_scale": (1, 5), "b_loc": (5, 7)}


@pytest.mark.parametrize("num", [10, 7], ids=["even_count", "odd_count"])
def test_median_bandwidth_matches_jax(num):
    """100 pairs take the mean of the two middle distances, as
    ``jnp.median`` does; ``torch.median`` would take the lower one."""
    x = np.random.default_rng(num).standard_normal((num, 3)).astype(np.float32)
    want = np.asarray(jmedian_bandwidth(jnp.asarray(x), lambda n: 1 / jnp.log(n)))
    got = median_bandwidth(torch.tensor(x), lambda n: 1 / np.log(n))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    if num % 2 == 0:
        sq = ((x[:, None] - x[None]) ** 2).sum(-1).ravel()
        lower = torch.tensor(sq).median().item() / np.log(num) + 1e-5
        assert abs(lower - float(want)) > 1e-3 * float(want)


# ---------------------------------------------------------------------------
# kernels over all pairs
# ---------------------------------------------------------------------------

KERNELS = {
    "rbf": lambda m, g: m.RBFKernel(),
    "rbf_vector": lambda m, g: m.RBFKernel(mode="vector"),
    "rbf_matrix": lambda m, g: m.RBFKernel(mode="matrix"),
    "rbf_matrix_vector_diag": lambda m, g: m.RBFKernel(mode="matrix", matrix_mode="vector_diag"),
    "imq": lambda m, g: m.IMQKernel(),
    "imq_vector": lambda m, g: m.IMQKernel(mode="vector", const=0.7, expon=-0.3),
    "linear": lambda m, g: m.LinearKernel(),
    "random_feature": lambda m, g: m.RandomFeatureKernel(),
    "random_feature_subset": lambda m, g: m.RandomFeatureKernel(bandwidth_subset=3),
    "mixture": lambda m, g: m.MixtureKernel([0.3, 0.7], [m.RBFKernel(), m.IMQKernel()]),
    "graphical": lambda m, g: m.GraphicalKernel(local_kernel_fns={"b": m.IMQKernel()}),
    "graphical_vector": lambda m, g: m.GraphicalKernel(default_kernel_fn=m.RBFKernel(
        mode="vector")),
    "probability_product": lambda m, g: m.ProbabilityProductKernel(guide=g),
    "radial_gauss_newton": lambda m, g: m.RadialGaussNewtonKernel(),
}


def _hand_random_features(jk, tk, shape, seed=5):
    """The same random weights and biases in both kernels."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    b = (2 * np.pi * rng.random(shape)).astype(np.float32)
    for k, to in ((jk, jnp.asarray), (tk, torch.tensor)):
        kernels = getattr(k, "kernel_fns", [k])
        for kk in kernels:
            if hasattr(kk, "_random_weights"):
                kk._random_weights, kk._random_biases = to(w), to(b)


def _kernel_pair(name, jguide=None, tguide=None):
    jk, tk = KERNELS[name](jein, jguide), KERNELS[name](ein, tguide)
    return jk, tk


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_values_over_all_pairs_match_jax(name):
    x = np.random.default_rng(11).standard_normal((6, 5)).astype(np.float32)
    info = {"a_loc": (0, 2), "b": (2, 3), "a_scale": (3, 5)}
    jk, tk = _kernel_pair(name, JAutoNormal(jgauss), AutoNormal(tgauss))
    _hand_random_features(jk, tk, x.shape)

    def jloss(p):
        return -0.5 * jnp.sum(p**2 * jnp.arange(1.0, 6.0)) + jnp.sum(jnp.sin(p))

    def tloss(p):
        return -0.5 * (p**2 * torch.arange(1.0, 6.0)).sum() + torch.sin(p).sum()

    jfn = jk.compute(random.PRNGKey(0), jnp.asarray(x), info, jloss)
    tfn = tk.compute(torch.Generator().manual_seed(0), torch.tensor(x), info, tloss)
    want = jax.vmap(lambda a: jax.vmap(lambda b: jfn(a, b))(jnp.asarray(x)))(jnp.asarray(x))
    got = torch.func.vmap(lambda a: torch.func.vmap(lambda b: tfn(a, b))(torch.tensor(x)))(
        torch.tensor(x))
    assert tk.mode == jk.mode
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# SVGD's force from the same particles
# ---------------------------------------------------------------------------

FORCE_KERNELS = [k for k in KERNELS if k != "probability_product"]


def _svgd_pair(cls, name, num=8, jmodel=jtwo, tmodel=ttwo, lr=0.5, **kw):
    js = getattr(jein, cls)(jmodel, joptim.Adagrad(lr), KERNELS[name](jein, None),
                            num_stein_particles=num, **kw)
    ts = getattr(ein, cls)(tmodel, optim.Adagrad(lr), KERNELS[name](ein, None),
                           num_stein_particles=num, device="cpu", **kw)
    jstate = js.init(random.PRNGKey(1))
    ts.init(0)
    params = js.optim.get_params(jstate.optim_state)
    return js, ts, jstate, params


@pytest.mark.parametrize("name", FORCE_KERNELS)
def test_svgd_force_matches_jax(name):
    js, ts, jstate, params = _svgd_pair("SVGD", name)
    flat = jbatch_ravel(params)[0]
    _hand_random_features(js.kernel_fn, ts.kernel_fn, flat.shape)
    jloss, jgrads = jax.jit(js._loss_and_grads)(random.PRNGKey(2), params)
    tloss, tgrads = ts._loss_and_grads(torch.Generator().manual_seed(0), to_torch(params))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    assert set(tgrads) == set(jgrads)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrads.values())
    atol = (RF_FORCE_ATOL if name.startswith("random_feature") else FORCE_ATOL) * scale
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]), rtol=RTOL,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("cls,name", [("SVGD", "rbf"), ("SVGD", "imq_vector"),
                                      ("SVGD", "rbf_matrix"), ("SVGD", "graphical"),
                                      ("ASVGD", "rbf"), ("ASVGD", "linear")])
def test_twenty_steps_match_jax(cls, name):
    """SVGD's objective draws nothing, so from the same particles both
    packages take the same steps; ASVGD's at the same temperatures."""
    steps = 20
    kw = {"num_cycles": 3, "transition_speed": 5} if cls == "ASVGD" else {}
    js, ts, jstate, params = _svgd_pair(cls, name, **kw)
    tstate = port_state(ts, params)
    if cls == "ASVGD":
        jsched = js._cyclical_annealing(steps, 3, 5, jnp.arange(steps, dtype=jnp.float32))
        tsched = ts._cyclical_annealing(steps, 3, 5, np.arange(steps, dtype=np.float32))
        np.testing.assert_array_equal(tsched.numpy(), np.asarray(jsched))

    @jax.jit
    def jstep(state, t):
        params = js.optim.get_params(state.optim_state)
        if cls == "ASVGD":
            loss, grads = js._annealed_loss_and_grads(jsched[t], state.rng_key, params)
        else:
            loss, grads = js._loss_and_grads(state.rng_key, params)
        return state._replace(optim_state=js.optim.update(grads, state.optim_state)), loss

    jlosses, tlosses = [], []
    for t in range(steps):
        jstate, jl = jstep(jstate, t)
        if cls == "ASVGD":
            tparams = ts.optim.get_params(tstate.optim_state)
            tl, tg = ts._annealed_loss_and_grads(tsched[t], tstate.rng_key, tparams)
            tstate = tstate._replace(optim_state=ts.optim.update(tg, tstate.optim_state))
        else:
            tstate, tl = ts.update(tstate)
        jlosses.append(float(jl))
        tlosses.append(tl.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=STEPS_RTOL)
    jp, tp = js.get_params(jstate), ts.get_params(tstate)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=STEPS_RTOL,
                                   atol=STEPS_ATOL, err_msg=k)


@pytest.mark.parametrize("num_steps,num_cycles,speed", [(20, 3, 5), (200, 10, 10), (57, 4, 3),
                                                       (30, 2, 2.5)])
def test_annealing_schedule_equals_jax_at_every_step(num_steps, num_cycles, speed):
    t = np.arange(num_steps, dtype=np.float32)
    want = np.asarray(jein.ASVGD._cyclical_annealing(num_steps, num_cycles, speed, jnp.asarray(t)))
    got = ein.ASVGD._cyclical_annealing(num_steps, num_cycles, speed, t)
    assert got.dtype == torch.float32
    if isinstance(speed, int):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_asvgd_run_anneals_and_returns_its_losses_on_the_device():
    a = ein.ASVGD(tgauss, optim.Adagrad(0.5), ein.RBFKernel(), num_stein_particles=20,
                  num_cycles=2, device="cpu")
    res = a.run(3, 30)
    assert a._num_steps == 30 and res.losses.shape == (30,)
    assert torch.isfinite(res.losses).all()
    assert res.params["auto_x_loc"].shape == (20, 2)


# ---------------------------------------------------------------------------
# SteinVI on JAX's draws
# ---------------------------------------------------------------------------

REG_ARGS = (jnp.asarray(REG_X), jnp.asarray(REG_Y))
REG_TARGS = (torch.tensor(REG_X), torch.tensor(REG_Y))
REG_INIT = {"w": np.array([0.2, -0.1], np.float32), "prec": np.float32(1.5)}


def _steinvi_pair(kernel, num=4, elbo=3):
    jguide = JAutoNormal(jreg, init_loc_fn=jinit_to_value(
        values={k: jnp.asarray(v) for k, v in REG_INIT.items()}))
    tguide = AutoNormal(treg, init_loc_fn=init_to_value(
        values={k: torch.tensor(v) for k, v in REG_INIT.items()}))
    js = jein.SteinVI(jreg, jguide, joptim.Adagrad(0.3), KERNELS[kernel](jein, jguide),
                      num_stein_particles=num, num_elbo_particles=elbo)
    ts = ein.SteinVI(treg, tguide, optim.Adagrad(0.3), KERNELS[kernel](ein, tguide),
                     num_stein_particles=num, num_elbo_particles=elbo, device="cpu")
    return js, ts


def _jitter_draws(js, key, args):
    """JAX's init jitter, in the port's draw order: ``(P,) + leaf shape``
    per leaf of each param site, model params first, then the guide's."""
    _, init_key = random.split(key)
    model_seed, guide_seed, particle_seed = random.split(init_key, 3)
    guide_tr = jhandlers.trace(jhandlers.seed(js.guide, guide_seed)).get_trace(*args)
    model_tr = jhandlers.trace(jhandlers.substitute(
        jhandlers.seed(js.model, model_seed),
        data={k: s["value"] for k, s in guide_tr.items() if s["type"] == "sample"},
    )).get_trace(*args)
    sites = [s for tr in (model_tr, guide_tr) for s in tr.values() if s["type"] == "param"]
    keys = random.split(particle_seed, max(len(sites), 1))
    draws = []
    for site, pkey in zip(sites, keys):
        leaves = jax.tree.leaves(site["value"])
        for leaf, k in zip(leaves, random.split(pkey, max(len(leaves), 1))):
            draws.append(random.normal(k, (js.num_stein_particles,) + jnp.shape(leaf)))
    return draws


def test_initial_particles_match_jax_on_jax_draws():
    js, ts = _steinvi_pair("rbf")
    key = random.PRNGKey(4)
    jstate = js.init(key, *REG_ARGS)
    draws = _jitter_draws(js, key, REG_ARGS)
    tstate = ts.init(table_draws(draws), *REG_TARGS)
    jp, tp = js.optim.get_params(jstate.optim_state), ts.optim.get_params(tstate.optim_state)
    assert list(tp) == list(jp) and ts._particle_param_names == js._particle_param_names
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    assert set(ts.particle_transforms) == set(js.particle_transforms)


@pytest.mark.parametrize("kernel", ["rbf", "probability_product", "radial_gauss_newton",
                                    "rbf_matrix"])
def test_steinvi_step_matches_jax_on_jax_draws(kernel):
    """One step's loss and gradient: each particle's mixture ELBO on JAX's
    guide draws; ``RadialGaussNewtonKernel``'s objective is particle 0's on
    particle 0's draws for every particle, as JAX's shared key gives it."""
    js, ts = _steinvi_pair(kernel)
    jstate = js.init(random.PRNGKey(5), *REG_ARGS)
    ts.init(0, *REG_TARGS)
    params = js.optim.get_params(jstate.optim_state)
    noise = step_noise(js, jstate, REG_ARGS)
    _, step_key = random.split(jstate.rng_key)
    jloss, jgrads = jax.jit(js._loss_and_grads)(step_key, params, *REG_ARGS)
    tloss, tgrads = ts._loss_and_grads(table_draws(noise), to_torch(params), *REG_TARGS)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrads.values())
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]), rtol=RTOL,
                                   atol=FORCE_ATOL * scale, err_msg=k)
    # and through update, to the optimizer's next particles
    jnext, jl = jax.jit(js.update)(jstate, *REG_ARGS)
    tnext, tl = ts.update(port_state(ts, params, table_draws(noise)), *REG_TARGS)
    jp, tp = js.get_params(jnext), ts.get_params(tnext)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=1e-6,
                                   err_msg=k)


def test_stein_loss_matches_jax_on_jax_draws():
    """``SteinLoss.loss``: JAX's particle picks, then each pick's ELBO draws
    (``elbo_num_particles`` of them per pick)."""
    js, ts = _steinvi_pair("rbf", num=5, elbo=2)
    jstate = js.init(random.PRNGKey(6), *REG_ARGS)
    ts.init(0, *REG_TARGS)
    params = js.get_params(jstate)
    key = random.PRNGKey(7)
    pick_key, mc_key = random.split(key)
    picks = random.randint(pick_key, (2,), 0, 5)
    tables = []
    for e, k in enumerate(random.split(mc_key, 2)):
        p_i = {n: v[picks[e]] for n, v in params.items()}
        tables.append([guide_noise(js.guide, p_i, random.split(dk)[0], REG_ARGS)
                       for dk in random.split(k, 2)])
    noise = [np.stack([np.stack([row[d][s] for d in range(2)]) for row in tables])
             for s in range(len(tables[0][0]))]
    want = jax.jit(lambda k, p: js.stein_loss.loss(k, {}, jreg, js.guide, p, *REG_ARGS))(
        key, params)
    got = ts.stein_loss.loss(table_draws(noise, ints=[np.asarray(picks)]), {}, treg,
                             ts.guide, to_torch(params), *REG_TARGS)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    with pytest.raises(ValueError, match="at least one particle"):
        ts.stein_loss.loss(torch.Generator(), {}, treg, ts.guide, {}, *REG_TARGS)


@pytest.fixture(scope="module")
def conjugate_runs():
    """300 steps of the JAX package's test (5 particles, 3 ELBO draws,
    Adam(0.1), ``IMQKernel``) in both packages."""

    def jmodel(y):
        x = numpyro_tpu.sample("x", jdist.Normal(0.0, 2.0))
        numpyro_tpu.sample("y", jdist.Normal(x, 0.5), obs=y)

    def tmodel(y):
        x = npt.sample("x", dist.Normal(0.0, 2.0))
        npt.sample("y", dist.Normal(x, 0.5), obs=y)

    js = jein.SteinVI(jmodel, JAutoNormal(jmodel), joptim.Adam(0.1), jein.IMQKernel(),
                      num_stein_particles=5, num_elbo_particles=3)
    jres = js.run(random.PRNGKey(2), 300, 1.5)
    ts = ein.SteinVI(tmodel, AutoNormal(tmodel), optim.Adam(0.1), ein.IMQKernel(),
                     num_stein_particles=5, num_elbo_particles=3, device="cpu")
    tres = ts.run(2, 300, torch.tensor(1.5))
    return jres, tres


def test_short_steinvi_run_is_held_to_the_posterior_as_jax_s(conjugate_runs):
    """The JAX package's own gate on both: the particles' mean location
    within 0.35 of the posterior mean 1.5 * 4 / 4.25, finite losses."""
    jres, tres = conjugate_runs
    post = 1.5 * 4 / 4.25
    for locs, losses in ((np.asarray(jres.params["auto_x_loc"]), np.asarray(jres.losses)),
                         (tres.params["auto_x_loc"].numpy(), tres.losses.numpy())):
        assert abs(locs.mean() - post) < 0.35
        assert np.isfinite(losses).all() and losses.shape == (300,)
    # the mixture ELBO's level at the end: the means of the last 50 losses
    # agree within their spread
    jl, tl = np.asarray(jres.losses)[-50:], tres.losses.numpy()[-50:]
    assert abs(jl.mean() - tl.mean()) < 4 * np.hypot(jl.std(), tl.std()) / np.sqrt(50) + 0.1


def test_mixture_guide_predictive_matches_jax_on_jax_draws():
    js, ts = _steinvi_pair("rbf", num=4, elbo=1)
    jstate = js.init(random.PRNGKey(8), *REG_ARGS)
    ts.init(0, *REG_TARGS)
    params = js.get_params(jstate)
    sites = ["w", "prec", "y"]
    num = 40
    jpred = jein.MixtureGuidePredictive(jreg, js.guide, params, set(params), num_samples=num,
                                        return_sites=sites)
    key = random.PRNGKey(9)
    # y is left out, so the model draws it
    want = jpred(key, REG_ARGS[0], None)
    guide_key, assign_key, _ = random.split(key, 3)
    assigns = random.randint(assign_key, (num,), minval=0, maxval=4)
    draws = [guide_noise(js.guide, {k: v[a] for k, v in params.items()}, k, (REG_ARGS[0], None))
             for k, a in zip(random.split(guide_key, num), assigns)]
    noise = [np.stack([d[s] for d in draws]) for s in range(len(draws[0]))]
    tpred = ein.MixtureGuidePredictive(treg, ts.guide, to_torch(params), set(params),
                                       num_samples=num, return_sites=sites, device="cpu")
    got = tpred(table_draws(noise, ints=[np.asarray(assigns)]), REG_TARGS[0], None)
    np.testing.assert_array_equal(got["mixture_assignments"].numpy(),
                                  np.asarray(want["mixture_assignments"]))
    for k in ("w", "prec"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    # the model's draws on the port's generator: standardized residuals ~ N(0, 1)
    z = ((got["y"] - got["w"] @ torch.tensor(REG_X).T) * got["prec"].sqrt()[:, None]).numpy()
    assert got["y"].shape == (num, 12) and abs(z.mean()) < 0.15 and abs(z.std() - 1) < 0.1
    # an int seed draws on the predictive's device
    out = tpred(3, REG_TARGS[0], None)
    assert out["mixture_assignments"].shape == (num,) and out["y"].shape == (num, 12)


# ---------------------------------------------------------------------------
# through the GLM op
# ---------------------------------------------------------------------------


def _logreg_data(n=2_000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, d - 1)), np.ones((n, 1))], 1).astype(np.float32)
    w = (0.5 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ w))).astype(np.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=jnp.float32)
    td = glm.from_numpy_glm_data(np.asarray(jd.x_t), np.asarray(jd.y_row), jd.n, jd.d,
                                 torch.float32)
    return jd, td


def jlogreg(data):
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(data.d), 1.0).to_event(1))
    numpyro_tpu.factor("lik", jglm.bernoulli_logits_loglik(w, data))


def tlogreg(data):
    w = npt.sample("w", dist.Normal(torch.zeros(data.d), 1.0).to_event(1))
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


def test_svgd_through_the_glm_op_matches_jax():
    """16 particles, every step one evaluation of the op for all of them;
    10 steps of ``Adagrad(0.05)`` from the same particles (rtol 1e-4, the
    GLM op's own parity tolerance on a loss)."""
    jd, td = _logreg_data()
    js = jein.SVGD(jlogreg, joptim.Adagrad(0.05), jein.RBFKernel(), num_stein_particles=16)
    ts = ein.SVGD(tlogreg, optim.Adagrad(0.05), ein.RBFKernel(), num_stein_particles=16,
                  device="cpu")
    jstate = js.init(random.PRNGKey(10), jd)
    ts.init(0, td)
    tstate = port_state(ts, js.optim.get_params(jstate.optim_state))
    jupdate = jax.jit(lambda s: js.update(s, jd))
    glm.reset_launch_counts()
    jl, tl = [], []
    for _ in range(10):
        jstate, a = jupdate(jstate)
        tstate, b = ts.update(tstate, td)
        jl.append(float(a))
        tl.append(b.item())
    assert glm.launch_counts["plain"] == 10
    np.testing.assert_allclose(tl, jl, rtol=STEPS_RTOL)
    np.testing.assert_allclose(ts.get_params(tstate)["auto_w_loc"].numpy(),
                               np.asarray(js.get_params(jstate)["auto_w_loc"]),
                               rtol=STEPS_RTOL, atol=STEPS_ATOL)


# ---------------------------------------------------------------------------
# arguments and the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda: ein.RBFKernel(mode="diagonal"),
    lambda: ein.RBFKernel(matrix_mode="full"),
    lambda: ein.IMQKernel(mode="matrix"),
    lambda: ein.IMQKernel(const=0.0),
    lambda: ein.IMQKernel(expon=-1.5),
    lambda: ein.RandomFeatureKernel(bandwidth_subset=0),
    lambda: ein.MixtureKernel([0.5], [ein.RBFKernel(), ein.IMQKernel()]),
    lambda: ein.ASVGD(tgauss, optim.Adagrad(0.5), num_cycles=0, device="cpu"),
], ids=["rbf_mode", "rbf_matrix_mode", "imq_mode", "imq_const", "imq_expon",
        "random_feature_subset", "mixture_lengths", "asvgd_cycles"])
def test_arguments_the_jax_package_asserts_on_raise(make):
    """The JAX package asserts; the port raises ``ValueError``, which
    ``python -O`` keeps."""
    with pytest.raises(ValueError, match="invalid|positive"):
        make()


def test_the_stein_methods_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svgd = ein.SVGD(tgauss, optim.Adagrad(0.5), num_stein_particles=4)
    assert svgd.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svgd.run(0, 2)
    guide = AutoNormal(tgauss)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ein.SteinVI(tgauss, guide, optim.Adagrad(0.5)).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ein.ASVGD(tgauss, optim.Adagrad(0.5)).run(0, 2)
    pred = ein.MixtureGuidePredictive(tgauss, guide, {"auto_x_loc": torch.zeros(3, 2)},
                                      {"auto_x_loc"}, num_samples=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pred(0)
    with pytest.raises(TypeError, match="int seed or a torch.Generator"):
        ein.SVGD(tgauss, optim.Adagrad(0.5), device="cpu").run(1.5, 2)
