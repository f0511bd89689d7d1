"""The models of ``examples/ucbadmit.py``, ``examples/ssbvm_mixture.py``,
``examples/zero_inflated_poisson.py``, ``examples/baseball.py`` and
``examples/mortality.py`` in the port against the JAX package: the potential
and its gradient at the same 8 unconstrained points (``ssbvm_mixture``'s with
its label ``c`` enumerated; rtol 1e-5, atol 1e-5 of the largest gradient
entry), ``ucbadmit``'s ``Predictive`` on 64 fixed posterior draws (the mean
count of each row within 4 standard errors of the JAX package's), and
``Predictive`` on ``ssbvm_mixture``'s model, whose VonMises draws run under
``vmap``.  ``baseball.py`` and ``mortality.py`` are held on made-up counts of
their shapes: the Efron-Morris table's file is not in the repository."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.contrib.enum as jenum
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.infer import Predictive
from numpyro_tpu_torch.infer import util

torch.set_num_threads(1)

C = 8

# examples/ucbadmit.py:16-20: dept, male, applications, admits
UCB = np.array([
    [0, 1, 825, 512], [0, 0, 108, 89], [1, 1, 560, 353], [1, 0, 25, 17],
    [2, 1, 325, 120], [2, 0, 593, 202], [3, 1, 417, 138], [3, 0, 375, 131],
    [4, 1, 191, 53], [4, 0, 393, 94], [5, 1, 373, 22], [5, 0, 341, 24],
])


def _pkg(pkg):
    if pkg == "jax":
        return numpyro_tpu.sample, numpyro_tpu.plate, jdist
    return npt.sample, npt.plate, dist


def ucbadmit(pkg, dept, male, applications, admit=None):
    sample, plate, d = _pkg(pkg)
    sigma = sample("sigma", d.HalfNormal(1.0))
    with plate("dept", 6):
        a_dept = sample("a_dept", d.Normal(0.0, sigma))
    a = sample("a", d.Normal(0.0, 2.0))
    bm = sample("bm", d.Normal(0.0, 1.0))
    logits = a + a_dept[dept] + bm * male
    with plate("obs", dept.shape[0]):
        sample("admit", d.Binomial(applications, logits=logits), obs=admit)


def ssbvm_mixture(pkg, angles, K=2):
    sample, plate, d = _pkg(pkg)
    ones = jnp.ones(K) if pkg == "jax" else torch.ones(K)
    with plate("mix", K):
        loc_phi = sample("loc_phi", d.VonMises(0.0, 0.5))
        loc_psi = sample("loc_psi", d.VonMises(0.0, 0.5))
        conc_phi = sample("conc_phi", d.Gamma(2.0, 0.5))
        conc_psi = sample("conc_psi", d.Gamma(2.0, 0.5))
    weights = sample("weights", d.Dirichlet(ones))
    with plate("obs", angles.shape[0]):
        c = sample("c", d.Categorical(weights), infer={"enumerate": "parallel"})
        sample("phi", d.VonMises(loc_phi[c], conc_phi[c]), obs=angles[:, 0])
        sample("psi", d.VonMises(loc_psi[c], conc_psi[c]), obs=angles[:, 1])


def zero_inflated(pkg, X, y=None):
    sample, plate, d = _pkg(pkg)
    D = X.shape[1]
    zeros = jnp.zeros(D) if pkg == "jax" else torch.zeros(D)
    beta = sample("beta", d.Normal(zeros, 1.0).to_event(1))
    gate_logit = sample("gate_logit", d.Normal(0.0, 1.0))
    rate = (jnp if pkg == "jax" else torch).exp(X @ beta)
    sigmoid = jax.nn.sigmoid if pkg == "jax" else torch.sigmoid
    gate = (jnp if pkg == "jax" else torch).broadcast_to(sigmoid(gate_logit), rate.shape)
    with plate("N", X.shape[0]):
        sample("y", d.ZeroInflatedPoisson(gate=gate, rate=rate), obs=y)


def baseball_partially_pooled(pkg, at_bats, hits=None):
    sample, plate, d = _pkg(pkg)
    m = sample("m", d.Uniform(0.0, 1.0))
    kappa = sample("kappa", d.Pareto(1.0, 1.5))
    with plate("players", at_bats.shape[0]):
        phi = sample("phi", d.Beta(m * kappa, (1 - m) * kappa))
        sample("obs", d.Binomial(at_bats, probs=phi), obs=hits)


def baseball_fully_pooled(pkg, at_bats, hits=None):
    sample, plate, d = _pkg(pkg)
    phi = sample("phi", d.Uniform(0.0, 1.0))
    with plate("players", at_bats.shape[0]):
        sample("obs", d.Binomial(at_bats, probs=phi), obs=hits)


def mortality(pkg, age_idx, time_idx, exposure, deaths=None, *, A, T):
    sample, plate, d = _pkg(pkg)
    sigma_a = sample("sigma_age", d.HalfNormal(1.0))
    sigma_t = sample("sigma_time", d.HalfNormal(0.5))
    intercept = sample("intercept", d.Normal(-4.0, 2.0))
    age_eff = sample("age_eff", d.GaussianRandomWalk(sigma_a, A))
    time_eff = sample("time_eff", d.GaussianRandomWalk(sigma_t, T))
    logits = intercept + age_eff[age_idx] + time_eff[time_idx]
    with plate("obs", age_idx.shape[0]):
        sample("deaths", d.Binomial(exposure, logits=logits), obs=deaths)


def _ucb_args():
    cols = (UCB[:, 0].astype(np.int32), UCB[:, 1].astype(np.float32),
            UCB[:, 2].astype(np.float32), UCB[:, 3].astype(np.float32))
    return (tuple(jnp.asarray(c) for c in cols),
            tuple(torch.from_numpy(c.astype(np.int64) if c.dtype == np.int32 else c)
                  for c in cols))


def _angles(n=200):
    """``examples/ssbvm_mixture.py``'s data: numpy's von Mises, seed 0."""
    rng = np.random.RandomState(0)
    half = n // 2
    a = np.stack([rng.vonmises(-2.0, 8, half), rng.vonmises(2.0, 8, half)], 1)
    b = np.stack([rng.vonmises(1.0, 8, half), rng.vonmises(-1.0, 8, half)], 1)
    return np.concatenate([a, b]).astype(np.float32)


def _zip_args(n=300):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 3).astype(np.float32)
    y = rng.poisson(np.exp(X @ np.array([0.5, -0.5, 0.3])))
    y[rng.rand(n) < 0.3] = 0
    y = y.astype(np.float32)
    return (jnp.asarray(X), jnp.asarray(y)), (torch.from_numpy(X), torch.from_numpy(y))


def _baseball_args():
    """18 players at 45 at-bats (the Efron-Morris shape), made-up hits."""
    rng = np.random.default_rng(1)
    at_bats = np.full(18, 45.0, np.float32)
    hits = rng.binomial(45, rng.uniform(0.2, 0.35, 18)).astype(np.float32)
    return (jnp.asarray(at_bats), jnp.asarray(hits)), (torch.from_numpy(at_bats),
                                                       torch.from_numpy(hits))


def _mortality_args(A=10, T=8):
    """``examples/mortality.py``'s construction at a smaller grid."""
    rng = np.random.RandomState(0)
    age_idx, time_idx = np.meshgrid(np.arange(A), np.arange(T), indexing="ij")
    age_idx, time_idx = age_idx.ravel(), time_idx.ravel()
    exposure = rng.randint(500, 2000, size=A * T).astype(np.float32)
    logit = -4.0 + 0.15 * age_idx - 0.05 * time_idx
    deaths = rng.binomial(exposure.astype(int), 1 / (1 + np.exp(-logit))).astype(np.float32)
    cols = (age_idx, time_idx, exposure, deaths)
    return (tuple(jnp.asarray(c) for c in cols),
            tuple(torch.from_numpy(c.astype(np.int64) if c.dtype.kind == "i" else c)
                  for c in cols), {"A": A, "T": T})


def _check_potential(model, jargs, targs, kwargs=None, enum=False, seed=0):
    """The potential and its gradient at ``C`` unconstrained points drawn
    around the port's initial ones, against the JAX package's."""
    kwargs = kwargs or {}
    info = util.initialize_model(torch.Generator().manual_seed(seed),
                                 lambda *a, **k: model("torch", *a, **k), num_chains=C,
                                 model_args=targs, model_kwargs=kwargs)
    rng = np.random.default_rng(seed)
    z = {k: (v.numpy() + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in info.param_info.z.items()}
    jmodel = lambda *a, **k: model("jax", *a, **k)  # noqa: E731
    if enum:
        jmodel = jenum.enum(jenum.config_enumerate(jmodel), first_available_dim=-2)
    jvg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: jutil.potential_energy(jmodel, jargs, kwargs, p, enum=enum))))
    jpe, jg = jvg({k: jnp.asarray(v) for k, v in z.items()})
    tpe, tg = util.batched_value_and_grad(info.potential_fn)(
        {k: torch.from_numpy(v) for k, v in z.items()})
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), rtol=1e-5)
    assert set(tg) == set(jg)
    for k in jg:
        g = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), g, rtol=1e-5, atol=1e-5 * np.abs(g).max(),
                                   err_msg=k)


def test_ucbadmit_potential_matches_jax():
    jargs, targs = _ucb_args()
    _check_potential(ucbadmit, jargs, targs)


def test_ucbadmit_predictive_matches_jax():
    """64 fixed posterior draws (numpy, seed 3) through both packages'
    ``Predictive``: the mean admit count of each row within 4 standard
    errors of the two means' difference."""
    jargs, targs = _ucb_args()
    rng = np.random.default_rng(3)
    post = {"sigma": np.abs(rng.normal(1.0, 0.2, 64)), "a_dept": rng.normal(0.0, 1.0, (64, 6)),
            "a": rng.normal(-0.5, 0.3, 64), "bm": rng.normal(-0.1, 0.1, 64)}
    post = {k: v.astype(np.float32) for k, v in post.items()}
    want = np.asarray(jinfer.Predictive(lambda *a: ucbadmit("jax", *a),
                                        {k: jnp.asarray(v) for k, v in post.items()})(
        random.PRNGKey(1), *jargs[:3])["admit"])
    got = Predictive(lambda *a: ucbadmit("torch", *a),
                     {k: torch.from_numpy(v) for k, v in post.items()}, device="cpu")(
        1, *targs[:3])["admit"]
    assert got.shape == want.shape == (64, 12) and got.dtype == torch.int64
    got = got.double().numpy()
    assert (got >= 0).all() and (got <= UCB[:, 2]).all()
    se = np.sqrt(got.var(0) / 64 + want.var(0) / 64)
    assert (np.abs(got.mean(0) - want.mean(0)) <= 4 * se).all()
    # each posterior draw gets its own counts
    assert len(np.unique(got[:, 0])) > 16


def test_ssbvm_mixture_enumerated_potential_matches_jax():
    angles = _angles()
    _check_potential(ssbvm_mixture, (jnp.asarray(angles),), (torch.from_numpy(angles),),
                     enum=True)


def test_ssbvm_mixture_predictive_draws_von_mises_under_vmap():
    angles = _angles(40)
    rng = np.random.default_rng(4)
    post = {"loc_phi": rng.uniform(-3, 3, (16, 2)), "loc_psi": rng.uniform(-3, 3, (16, 2)),
            "conc_phi": rng.uniform(2, 10, (16, 2)), "conc_psi": rng.uniform(2, 10, (16, 2)),
            "weights": np.full((16, 2), 0.5)}
    post = {k: torch.from_numpy(v.astype(np.float32)) for k, v in post.items()}

    def model(angles):
        # the example's model with its observations left out (phi and psi drawn)
        sample, plate, d = _pkg("torch")
        with plate("mix", 2):
            loc_phi = sample("loc_phi", d.VonMises(0.0, 0.5))
            conc_phi = sample("conc_phi", d.Gamma(2.0, 0.5))
            sample("loc_psi", d.VonMises(0.0, 0.5))
            sample("conc_psi", d.Gamma(2.0, 0.5))
        weights = sample("weights", d.Dirichlet(torch.ones(2)))
        with plate("obs", angles.shape[0]):
            c = sample("c", d.Categorical(weights))
            sample("phi", d.VonMises(loc_phi[c], conc_phi[c]))

    pred = Predictive(model, post, device="cpu")(0, torch.from_numpy(angles))
    phi = pred["phi"]
    assert phi.shape == (16, 40) and bool(((phi >= -np.pi) & (phi <= np.pi)).all())
    assert len(torch.unique(phi)) == phi.numel()


def test_zero_inflated_poisson_potential_matches_jax():
    jargs, targs = _zip_args()
    _check_potential(zero_inflated, jargs, targs)


@pytest.mark.parametrize("model", [baseball_fully_pooled, baseball_partially_pooled])
def test_baseball_potential_matches_jax(model):
    jargs, targs = _baseball_args()
    _check_potential(model, jargs, targs)


def test_mortality_potential_matches_jax():
    jargs, targs, kwargs = _mortality_args()
    _check_potential(mortality, jargs, targs, kwargs)
