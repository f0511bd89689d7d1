"""Parallel enumeration in the port against the JAX package and numpy:
``Categorical``, ``enum``/``config_enumerate``/``markov`` and their dims,
``contrib.enum.log_density`` on plated mixtures, a ``markov`` HMM and a
second-order chain, ``infer_discrete`` (the joint mode exactly, draws by
their frequencies), ``TraceEnum_ELBO`` (the guide-side fault of the JAX
package), ``Predictive(infer_discrete=True)`` and the dim cap.

Each model is written once for both packages (``JAX`` and ``TORCH`` hold a
package's primitives); the inputs are numpy arrays from a seed.  Tolerances: log
densities to ``rtol=1e-5`` (float32 sums in another order); the joint mode
exactly; draw frequencies within 4 binomial standard errors.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.special import logsumexp
from scipy.stats import norm

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.contrib.enum as jenum
import numpyro_tpu.distributions as jdist
import numpyro_tpu.infer as jinfer
from numpyro_tpu import handlers as jhandlers
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.contrib.enum as tenum
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.infer import Predictive, TraceEnum_ELBO

torch.set_num_threads(1)
RTOL = 1e-5

JAX = SimpleNamespace(sample=numpyro_tpu.sample, plate=numpyro_tpu.plate, dist=jdist,
                      markov=jenum.markov, arr=lambda a: jnp.asarray(np.asarray(a, np.float32)))
TORCH = SimpleNamespace(sample=npt.sample, plate=npt.plate, dist=dist, markov=tenum.markov,
                        arr=lambda a: torch.as_tensor(np.asarray(a, np.float32)))


def _density(pkg, model, args=(), first_available_dim=-1):
    e = jenum if pkg is JAX else tenum
    wrapped = e.enum(e.config_enumerate(model), first_available_dim=first_available_dim)
    if pkg is JAX:
        # one compiled program: the JAX package's eager ops are slow to dispatch
        return float(jax.jit(lambda *a: e.log_density(wrapped, a, {}, {})[0])(*args))
    return float(e.log_density(wrapped, args, {}, {})[0])


# ---------------------------------------------------------------------------
# Categorical

def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = (2 * rng.standard_normal((4, 3, 5))).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0] = [0.0, 0.0, 1.0, 0.0, 0.0]
    value = rng.integers(0, 5, (2, 4, 3))
    for kw in ({"probs": probs}, {"logits": logits}):
        t = dist.Categorical(**{k: torch.from_numpy(v) for k, v in kw.items()})
        j = jdist.Categorical(**{k: jnp.asarray(v) for k, v in kw.items()})
        assert t.batch_shape == j.batch_shape == (4, 3) and t.event_shape == ()
        np.testing.assert_allclose(t.log_prob(torch.from_numpy(value)).numpy(),
                                   np.asarray(j.log_prob(jnp.asarray(value))), rtol=1e-6)
        np.testing.assert_array_equal(t.enumerate_support(expand=False).numpy(),
                                      np.asarray(j.enumerate_support(expand=False)))
        assert t.enumerate_support().shape == (5, 4, 3)
        assert t.support.is_discrete and t.support.upper_bound == 4
        np.testing.assert_allclose(t.probs.numpy(), np.asarray(j.probs), rtol=1e-5, atol=1e-7)
    assert isinstance(dist.Categorical(torch.ones(2) / 2), dist.CategoricalProbs)
    assert isinstance(dist.Categorical(logits=torch.zeros(2)), dist.CategoricalLogits)
    with pytest.raises(ValueError):
        dist.Categorical()
    with pytest.raises(ValueError, match="category axis"):
        dist.Categorical(torch.tensor(0.5))
    # expanded, as a plate makes it
    e = dist.Categorical(torch.from_numpy(probs[0, 0])).expand((3, 2))
    assert e.has_enumerate_support and e.enumerate_support(expand=False).shape == (5, 1, 1)


def test_categorical_draws_follow_the_probabilities():
    probs = torch.tensor([0.1, 0.6, 0.3])
    g = torch.Generator().manual_seed(0)
    n = 20_000
    x = dist.Categorical(probs).sample(g, (n,))
    freq = torch.bincount(x, minlength=3).double().numpy() / n
    se = np.sqrt(probs.numpy() * (1 - probs.numpy()) / n)
    assert np.all(np.abs(freq - probs.numpy()) < 4 * se)
    # one draw per element under vmap
    out = torch.func.vmap(lambda p: dist.Categorical(logits=p).sample(g, (16,)),
                          randomness="different")(torch.zeros(200, 4))
    assert len({tuple(r.tolist()) for r in out}) == 200


# ---------------------------------------------------------------------------
# mixtures in a plate

LOCS = np.array([-2.0, 0.0, 2.5], np.float32)
MIX_W = np.array([0.2, 0.5, 0.3], np.float32)
SCALES = np.array([0.7, 1.6], np.float32)


def _mixture(pkg, x, global_site):
    """Each point a Categorical component and a Bernoulli shift; with
    ``global_site`` a global Bernoulli picks the noise scale of all points."""

    def model():
        g = pkg.sample("g", pkg.dist.Bernoulli(0.4)) if global_site else 0
        with pkg.plate("N", x.shape[0]):
            c = pkg.sample("c", pkg.dist.Categorical(pkg.arr(MIX_W)))
            b = pkg.sample("b", pkg.dist.Bernoulli(0.3))
            pkg.sample("x", pkg.dist.Normal(pkg.arr(LOCS)[c] + 0.5 * b, pkg.arr(SCALES)[g]),
                       obs=pkg.arr(x))

    return model


def _mixture_brute(x, global_site):
    def per_scale(s):
        comp = [np.log(MIX_W[c]) + np.log(0.3 if b else 0.7)
                + norm(LOCS[c] + 0.5 * b, s).logpdf(x) for c in range(3) for b in range(2)]
        return logsumexp(np.stack(comp), axis=0).sum()

    if not global_site:
        return per_scale(SCALES[0])
    return logsumexp([np.log(0.6) + per_scale(SCALES[0]), np.log(0.4) + per_scale(SCALES[1])])


@pytest.mark.parametrize("global_site", [False, True])
def test_plated_mixture_density_matches_jax_and_numpy(global_site):
    x = np.random.default_rng(1).normal(0, 2, 7).astype(np.float32)
    want = _mixture_brute(x.astype(np.float64), global_site)
    got_j = _density(JAX, _mixture(JAX, x, global_site), first_available_dim=-2)
    got_t = _density(TORCH, _mixture(TORCH, x, global_site), first_available_dim=-2)
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL)


def test_enumeration_dims_match_jax():
    """Each site's enumeration dim, and its value's shape, as the JAX
    package lays them out: a global site first, then the plate-local ones,
    and a markov chain on a recycled pool of two."""
    x = np.zeros(4, np.float32)

    def dims(pkg, model, fad):
        e = jenum if pkg is JAX else tenum
        h = jhandlers if pkg is JAX else handlers
        seed = random.PRNGKey(0) if pkg is JAX else torch.Generator().manual_seed(0)
        tr = h.trace(h.seed(e.enum(e.config_enumerate(model), first_available_dim=fad),
                            seed)).get_trace()
        return {k: (s["infer"].get("_enum_dim"), tuple(np.shape(s["value"])))
                for k, s in tr.items() if s["type"] == "sample" and not s["is_observed"]}

    got = dims(TORCH, _mixture(TORCH, x, True), -2)
    assert got == dims(JAX, _mixture(JAX, x, True), -2)
    assert got["g"] == (-2, (2, 1)) and got["b"][0] == -4
    hm = dims(TORCH, _hmm_markov(TORCH, np.zeros(5, np.float32), P3), -1)
    assert hm == dims(JAX, _hmm_markov(JAX, np.zeros(5, np.float32), P3), -1)
    assert [hm[f"z_{t}"][0] for t in range(5)] == [-1, -2, -1, -2, -1]


# ---------------------------------------------------------------------------
# markov chains

P3 = np.array([[0.7, 0.2, 0.1], [0.15, 0.7, 0.15], [0.1, 0.3, 0.6]], np.float32)
LOCS3 = np.array([-2.0, 0.0, 2.0], np.float32)


def _hmm_markov(pkg, ys, P, history=1):
    def model():
        z = 0
        for t in pkg.markov(range(ys.shape[0]), history=history):
            z = pkg.sample(f"z_{t}", pkg.dist.Categorical(pkg.arr(P)[z]))
            pkg.sample(f"y_{t}", pkg.dist.Normal(pkg.arr(LOCS3)[z], 1.0), obs=pkg.arr(ys[t]))

    return model


def _forward(ys, P, init):
    emit = norm(LOCS3[: P.shape[0]].astype(np.float64), 1.0).logpdf(ys[:, None])
    alpha = np.log(init) + emit[0]
    for t in range(1, len(ys)):
        alpha = logsumexp(alpha[:, None] + np.log(P), axis=0) + emit[t]
    return logsumexp(alpha)


def test_markov_hmm_density_matches_jax_and_the_forward_algorithm():
    """T = 12, K = 3: the chain starts from row 0 of P."""
    ys = np.random.default_rng(2).normal(0, 1.5, 12).astype(np.float32)
    want = _forward(ys.astype(np.float64), P3.astype(np.float64), P3[0].astype(np.float64))
    got_t = _density(TORCH, _hmm_markov(TORCH, ys, P3))
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, _density(JAX, _hmm_markov(JAX, ys, P3)), rtol=RTOL)


def test_markov_history_two_matches_jax_and_brute_force():
    """A second-order chain recycles a pool of three dims."""
    T, K = 6, 2
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((K, K, K))
    P = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    ys = rng.standard_normal(T).astype(np.float32)

    def make(pkg):
        def model():
            prev, prev2 = 0, 0
            for t in pkg.markov(range(T), history=2):
                x = pkg.sample(f"x_{t}", pkg.dist.Categorical(pkg.arr(P)[prev2, prev]))
                pkg.sample(f"y_{t}", pkg.dist.Normal(pkg.arr(LOCS3[:2])[x], 1.0),
                           obs=pkg.arr(ys[t]))
                prev2, prev = prev, x

        return model

    emit = norm(LOCS3[:2].astype(np.float64), 1.0).logpdf(ys[:, None].astype(np.float64))
    logP = np.log(P.astype(np.float64))
    total = []
    for path in itertools.product(range(K), repeat=T):
        lp, p2, p1 = 0.0, 0, 0
        for t in range(T):
            lp += logP[p2, p1, path[t]] + emit[t, path[t]]
            p2, p1 = p1, path[t]
        total.append(lp)
    got_t = _density(TORCH, make(TORCH))
    np.testing.assert_allclose(got_t, logsumexp(total), rtol=RTOL)
    np.testing.assert_allclose(got_t, _density(JAX, make(JAX)), rtol=RTOL)


# ---------------------------------------------------------------------------
# infer_discrete

def _posterior_marginals(ys, P):
    """Forward-backward marginals p(z_t | ys) of the chain from row 0."""
    emit = norm(LOCS3[: P.shape[0]].astype(np.float64), 1.0).logpdf(ys[:, None])
    T, K = emit.shape
    logP = np.log(P)
    alpha = np.zeros((T, K))
    beta = np.zeros((T, K))
    alpha[0] = logP[0] + emit[0]
    for t in range(1, T):
        alpha[t] = logsumexp(alpha[t - 1][:, None] + logP, axis=0) + emit[t]
    for t in range(T - 2, -1, -1):
        beta[t] = logsumexp(logP + emit[t + 1] + beta[t + 1], axis=1)
    post = alpha + beta
    return np.exp(post - logsumexp(post, axis=1, keepdims=True))


def _decode(pkg, model, T, temperature, key):
    e = jenum if pkg is JAX else tenum
    h = jhandlers if pkg is JAX else handlers
    run = e.infer_discrete(model, first_available_dim=-1, temperature=temperature, rng_key=key)
    seed = random.PRNGKey(0) if pkg is JAX else torch.Generator().manual_seed(0)
    with h.block():
        tr = h.trace(h.seed(run, seed)).get_trace()
    return np.array([int(tr[f"z_{t}"]["value"]) for t in range(T)])


def test_infer_discrete_joint_mode_equals_jax():
    """At temperature 0 both packages give the same Viterbi path, and it is
    the most probable path of the brute-force enumeration."""
    ys = np.random.default_rng(4).normal(0, 1.2, 7).astype(np.float32)
    got = _decode(TORCH, _hmm_markov(TORCH, ys, P3), 7, 0, torch.Generator().manual_seed(1))
    want = _decode(JAX, _hmm_markov(JAX, ys, P3), 7, 0, random.PRNGKey(1))
    np.testing.assert_array_equal(got, want)
    emit = norm(LOCS3.astype(np.float64), 1.0).logpdf(ys[:, None].astype(np.float64))
    logP = np.log(P3.astype(np.float64))

    def score(path):
        prev, lp = 0, 0.0
        for t, z in enumerate(path):
            lp += logP[prev, z] + emit[t, z]
            prev = z
        return lp

    best = max(itertools.product(range(3), repeat=7), key=score)
    np.testing.assert_array_equal(got, best)


def test_infer_discrete_draws_follow_the_forward_backward_marginals():
    """2,000 draws at temperature 1 in one vmap: each step's frequencies
    within 4 binomial standard errors of the exact marginals."""
    ys = np.random.default_rng(5).normal(0, 1.5, 8).astype(np.float32)
    model = _hmm_markov(TORCH, ys, P3)
    gen = torch.Generator().manual_seed(6)

    def one(i):
        run = tenum.infer_discrete(model, first_available_dim=-1, temperature=1, rng_key=gen)
        with handlers.block():
            tr = handlers.trace(run).get_trace()
        return torch.stack([tr[f"z_{t}"]["value"] for t in range(8)])

    n = 2000
    draws = torch.func.vmap(one, randomness="different")(torch.arange(n)).numpy()
    post = _posterior_marginals(ys.astype(np.float64), P3.astype(np.float64))
    freq = np.stack([(draws == k).mean(0) for k in range(3)], -1)
    se = np.sqrt(post * (1 - post) / n)
    assert np.all(np.abs(freq - post) <= 4 * se + 1e-12), np.abs(freq - post) / (se + 1e-12)


def test_predictive_infer_discrete_shapes_and_posterior():
    """``Predictive(infer_discrete=True)`` of a plated mixture: a state per
    point and per sample, drawn from its posterior given the sample; the
    call keeps f32 matmuls out of TF32, as ``MCMC`` and ``SVI`` do."""
    x = np.array([-2.1, 2.4, 0.1, -1.8, 2.6], np.float32)
    model = _mixture(TORCH, x, False)
    samples = {"dummy": torch.zeros(400)}
    torch.backends.cuda.matmul.allow_tf32 = True
    pred = Predictive(model, samples, infer_discrete=True, device="cpu", parallel=True)(3)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert pred["c"].shape == (400, 5) and pred["b"].shape == (400, 5)
    assert pred["x"].shape == (400, 5)
    # point 1 at 2.4 is component 2 with posterior probability above 0.99
    assert (pred["c"][:, 1] == 2).float().mean() > 0.95
    with pytest.raises(AssertionError):
        tenum.infer_discrete(model, first_available_dim=-1)


# ---------------------------------------------------------------------------
# TraceEnum_ELBO and the guide-side fault

def _three_step_chain(pkg, ys, q_param=False):
    """A shift c picked by a global Bernoulli, then three markov steps of a
    two-state chain; the third step recycles the dim of the first."""
    P = np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)

    def model():
        c = pkg.sample("c", pkg.dist.Bernoulli(0.3))
        z = 0
        for t in pkg.markov(range(3), history=1):
            z = pkg.sample(f"z_{t}", pkg.dist.Categorical(pkg.arr(P)[z]),
                           infer={"enumerate": "parallel"})
            pkg.sample(f"y_{t}", pkg.dist.Normal(pkg.arr(LOCS3[:2])[z] + c, 1.0),
                       obs=pkg.arr(ys[t]))

    def guide():
        pkg.sample("c", pkg.dist.Bernoulli(0.6), infer={"enumerate": "parallel"})

    return model, guide, P


def test_guide_enumeration_raises_where_jax_returns_a_wrong_elbo():
    """The JAX package's guide-side enumeration sums the model's dims at the
    end, not in site order, so z_0 and z_2, which share a recycled dim, are
    summed as one variable and its ELBO is off the brute-force one; the port
    raises (ROADMAP.md, Queue 3)."""
    ys = np.array([-0.8, 1.1, 0.9], np.float32)
    jmodel, jguide, P = _three_step_chain(JAX, ys)
    jval = -float(jax.jit(lambda k: jinfer.TraceEnum_ELBO().loss(k, {}, jmodel, jguide))(
        random.PRNGKey(0)))
    # brute force: E_q(c) [log sum_z p(c, z, ys) - log q(c)]
    logP = np.log(P.astype(np.float64))
    want = 0.0
    for c, q in ((0, 0.4), (1, 0.6)):
        paths = []
        for path in itertools.product(range(2), repeat=3):
            prev, lp = 0, np.log(0.3 if c else 0.7)
            for t, z in enumerate(path):
                lp += logP[prev, z] + norm(LOCS3[z] + c, 1.0).logpdf(ys[t])
                prev = z
            paths.append(lp)
        want += q * (logsumexp(paths) - np.log(q))
    assert abs(jval - want) > 0.1, (jval, want)
    tmodel, tguide, _ = _three_step_chain(TORCH, ys)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TraceEnum_ELBO().loss(torch.Generator().manual_seed(0), {}, tmodel, tguide)


def test_trace_enum_elbo_without_guide_sites_is_the_marginal():
    """With a guide that samples nothing, the ELBO is the model's enumerated
    log marginal in both packages."""
    ys = np.random.default_rng(7).normal(0, 1.5, 6).astype(np.float32)
    want = _forward(ys.astype(np.float64), P3.astype(np.float64), P3[0].astype(np.float64))
    got_t = -TraceEnum_ELBO().loss(torch.Generator().manual_seed(0), {},
                                   _hmm_markov(TORCH, ys, P3), lambda: None).item()
    got_j = -float(jinfer.TraceEnum_ELBO().loss(random.PRNGKey(0), {},
                                               _hmm_markov(JAX, ys, P3), lambda: None))
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL)


# ---------------------------------------------------------------------------
# the cap of 25 dims

def _many_bernoullis(n):
    def model():
        x = npt.sample("x", dist.Normal(0.0, 1.0))
        for i in range(n):
            npt.sample(f"b{i}", dist.Bernoulli(logits=x), infer={"enumerate": "parallel"})
    return model


def test_more_than_25_dims_with_the_vmap_dims_raise():
    """24 enumeration dims under one vmap make 25 dims and run; 25 make 26
    and raise with a clear message, on the CPU as on the card.  Without a
    vmap, 25 run; the JAX package's budget of 25 enumeration dims stands."""
    xs = torch.linspace(-1.0, 1.0, 3)

    def density(n, mapped=True):
        wrapped = tenum.enum(tenum.config_enumerate(_many_bernoullis(n)), first_available_dim=-1)
        fn = lambda x: tenum.log_density(wrapped, (), {}, {"x": x})[0]  # noqa: E731
        return torch.func.vmap(fn)(xs) if mapped else fn(xs[0])

    torch.testing.assert_close(density(24), -0.5 * xs**2 - 0.5 * np.log(2 * np.pi),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="more than the 25"):
        density(25)
    assert torch.isfinite(density(25, mapped=False))
    with pytest.raises(RuntimeError, match="budget of 25"):
        density(26, mapped=False)
    depth = tenum.enum_messenger.vmap_depth
    assert depth() == 0
    torch.testing.assert_close(torch.func.vmap(lambda x: x + depth())(xs), xs + 1)
