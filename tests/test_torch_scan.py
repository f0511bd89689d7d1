"""The effectful ``scan`` in the port against the JAX package and numpy
(the cases of ``tests/test_control_flow.py`` and the enumerated scans of
``tests/contrib/test_enum.py``): a continuous scan's trace, density,
substitution and potential; enumerated HMMs (a chain from step 0, a mixture
of HMMs, a plate inside the step, a chain per element of a plate, history 0,
length 1, a reverse scan, a carry that moves beside the enumerated state, a
substituted series shorter than the scan); and the cases that raise.

Models are written once for both packages (``JAX`` and ``TORCH`` hold a
package's primitives), on numpy inputs from a seed.  Tolerances: densities
and potentials to ``rtol=1e-5``, gradients to ``atol=1e-5 max|g|``.
"""

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
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.contrib.control_flow import scan as jscan
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.contrib.enum as tenum
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.control_flow import scan as tscan
from numpyro_tpu_torch.infer import Predictive, util

torch.set_num_threads(1)
RTOL = 1e-5

JAX = SimpleNamespace(sample=numpyro_tpu.sample, plate=numpyro_tpu.plate, dist=jdist,
                      scan=jscan, arr=lambda a: jnp.asarray(np.asarray(a, np.float32)),
                      enum=jenum, handlers=jhandlers)
TORCH = SimpleNamespace(sample=npt.sample, plate=npt.plate, dist=dist, scan=tscan,
                        arr=lambda a: torch.as_tensor(np.asarray(a, np.float32)),
                        enum=tenum, handlers=handlers)


def _density(pkg, model, args=(), first_available_dim=-1):
    e = pkg.enum
    wrapped = e.enum(e.config_enumerate(model), first_available_dim=first_available_dim)
    if pkg is JAX:
        # one compiled program: the JAX package's eager ops are slow to dispatch
        return float(jax.jit(lambda *a: e.log_density(wrapped, a, {}, {})[0])(*args))
    return float(e.log_density(wrapped, args, {}, {})[0])


# ---------------------------------------------------------------------------
# a continuous scan: the Gaussian HMM of tests/test_control_flow.py

def _gaussian_hmm(pkg):
    def model(y=None, T=10):
        def transition(x_prev, y_curr):
            x_curr = pkg.sample("x", pkg.dist.Normal(x_prev, 1.0))
            y_curr = pkg.sample("y", pkg.dist.Normal(x_curr, 1.0), obs=y_curr)
            return x_curr, (x_curr, y_curr)

        x0 = pkg.sample("x_0", pkg.dist.Normal(0.0, 1.0))
        _, (x, y) = pkg.scan(transition, x0, y, length=T)
        return x, y

    return model


def test_scan_seed_and_trace():
    model = _gaussian_hmm(TORCH)
    ys = torch.arange(10.0)
    with handlers.seed(rng_seed=0):
        x, y = model(ys)
    assert x.shape == (10,) and torch.equal(y, ys)
    with handlers.seed(rng_seed=0):
        x, y = model()
    assert x.shape == (10,) and y.shape == (10,)
    tr = handlers.trace(handlers.seed(model, 0)).get_trace(ys)
    jtr = jhandlers.trace(jhandlers.seed(_gaussian_hmm(JAX), 0)).get_trace(jnp.arange(10.0))
    for name in ("x", "y"):
        assert tr[name]["value"].shape == jtr[name]["value"].shape == (10,)
        assert tr[name]["fn"].batch_shape == jtr[name]["fn"].batch_shape == (10,)
        assert tr[name]["is_observed"] == jtr[name]["is_observed"]
        assert tr[name]["_control_flow_done"]
    # outside any handler the body runs too
    with pytest.raises(ValueError, match="rng_key"):
        model()


def test_scan_log_density_and_substitution_match_jax():
    ys = np.random.default_rng(0).standard_normal(10).astype(np.float32)
    xs = np.random.default_rng(1).standard_normal(10).astype(np.float32)
    t_ld, t_tr = util.log_density(_gaussian_hmm(TORCH), (torch.from_numpy(ys),), {},
                                  {"x_0": torch.tensor(0.3), "x": torch.from_numpy(xs)})
    j_ld, _ = jutil.log_density(_gaussian_hmm(JAX), (jnp.asarray(ys),), {},
                                {"x_0": 0.3, "x": jnp.asarray(xs)})
    x_prev = np.concatenate([[0.3], xs[:-1]])
    want = (norm(0, 1).logpdf(0.3) + norm(x_prev, 1).logpdf(xs).sum()
            + norm(xs, 1).logpdf(ys).sum())
    np.testing.assert_allclose(float(t_ld), want, rtol=RTOL)
    np.testing.assert_allclose(float(t_ld), float(j_ld), rtol=RTOL)
    np.testing.assert_array_equal(t_tr["x"]["value"].numpy(), xs)
    # condition reaches the steps too: y becomes observed at the given series
    cond = handlers.condition(_gaussian_hmm(TORCH), data={"y": torch.from_numpy(ys)})
    tr = handlers.trace(handlers.seed(cond, 1)).get_trace()
    assert tr["y"]["is_observed"] and torch.equal(tr["y"]["value"], torch.from_numpy(ys))


def test_scan_potential_and_gradient_match_jax():
    """Per-step latent sites under the potential's unconstraining
    substitution: each step takes its slice of the series (the scan's
    ``_scan_current_index``), a positive one with its log-Jacobian."""

    def make(pkg):
        def model(ys):
            s = pkg.sample("s", pkg.dist.HalfNormal(1.0))

            def step(prev, y):
                x = pkg.sample("x", pkg.dist.Normal(prev, s))
                w = pkg.sample("w", pkg.dist.HalfNormal(1.0))
                pkg.sample("y", pkg.dist.Normal(x, w), obs=y)
                return x, None

            pkg.scan(step, 0.0, ys)

        return model

    rng = np.random.default_rng(2)
    ys = rng.standard_normal(6).astype(np.float32)
    u = {"s": np.float32(-0.3), "x": rng.standard_normal(6).astype(np.float32),
         "w": rng.standard_normal(6).astype(np.float32)}
    jfn = lambda p: jutil.potential_energy(make(JAX), (jnp.asarray(ys),), {}, p)  # noqa: E731
    jpe, jg = jax.value_and_grad(jfn)({k: jnp.asarray(v) for k, v in u.items()})
    tfn = lambda p: util.potential_energy(make(TORCH), (torch.from_numpy(ys),), {}, p)  # noqa: E731
    tg, tpe = torch.func.grad_and_value(tfn)({k: torch.as_tensor(v) for k, v in u.items()})
    np.testing.assert_allclose(tpe.item(), float(jpe), rtol=RTOL)
    for k in u:
        g = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), g, rtol=RTOL, atol=RTOL * np.abs(g).max())


def test_reverse_scan_matches_jax():
    def make(pkg):
        def model(ys):
            def step(c, y):
                x = pkg.sample("x", pkg.dist.Normal(c, 1.0))
                pkg.sample("y", pkg.dist.Normal(x, 0.5), obs=y)
                return x, x + c

            return pkg.scan(step, 0.0, ys, reverse=True)

        return model

    ys = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    xs = np.random.default_rng(4).standard_normal(5).astype(np.float32)
    t = handlers.substitute(make(TORCH), data={"x": torch.from_numpy(xs)})
    j = jhandlers.substitute(make(JAX), data={"x": jnp.asarray(xs)})
    (tc, tys), t_ld = t(torch.from_numpy(ys)), util.log_density(t, (torch.from_numpy(ys),), {},
                                                                  {})[0]
    (jc, jys), j_ld = j(jnp.asarray(ys)), jutil.log_density(j, (jnp.asarray(ys),), {}, {})[0]
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=RTOL)
    np.testing.assert_allclose(float(tc), float(jc), rtol=RTOL)
    np.testing.assert_allclose(float(t_ld), float(j_ld), rtol=RTOL)


# ---------------------------------------------------------------------------
# enumerated scans

LOCS = np.array([-2.0, 0.0, 2.0], np.float32)


def _forward(init, logP, emit):
    alpha = np.log(init) + emit[0]
    for t in range(1, emit.shape[0]):
        alpha = logsumexp(alpha[:, None] + logP, axis=0) + emit[t]
    return logsumexp(alpha)


def _hmm(pkg, P, history=1, reverse=False):
    def model(ys):
        def transition(x_prev, y):
            x = pkg.sample("x", pkg.dist.Categorical(pkg.arr(P)[x_prev]),
                           infer={"enumerate": "parallel"})
            pkg.sample("y", pkg.dist.Normal(pkg.arr(LOCS)[x], 1.0), obs=y)
            return x, None

        pkg.scan(transition, 0, ys, history=history, reverse=reverse)

    return model


def _random_P(K, seed):
    logits = np.random.default_rng(seed).standard_normal((K, K))
    return (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True])
def test_enumerated_hmm_matches_jax_and_the_forward_algorithm(reverse):
    """T = 12, K = 3: the chain starts from row 0 of P (the carry 0); a
    reverse scan runs the chain from the end."""
    T, K = 12, 3
    P = _random_P(K, 0)
    ys = np.random.default_rng(1).standard_normal(T).astype(np.float32)
    emit = norm(LOCS.astype(np.float64), 1.0).logpdf(ys[:, None].astype(np.float64))
    want = _forward(P[0].astype(np.float64), np.log(P.astype(np.float64)),
                    emit[::-1] if reverse else emit)
    got_t = _density(TORCH, _hmm(TORCH, P, reverse=reverse), (TORCH.arr(ys),))
    got_j = _density(JAX, _hmm(JAX, P, reverse=reverse), (JAX.arr(ys),))
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL)


def test_enumerated_mixture_of_hmms_matches_jax():
    """A global enumerated discrete outside the scan picks the transition
    matrix: its dim survives the time collapse and is summed out after."""
    T = 8
    trans = np.stack([[[0.9, 0.1], [0.1, 0.9]], [[0.5, 0.5], [0.5, 0.5]]]).astype(np.float32)
    ys = np.random.default_rng(3).standard_normal(T).astype(np.float32)

    def make(pkg):
        def model(ys):
            m = pkg.sample("m", pkg.dist.Bernoulli(0.3), infer={"enumerate": "parallel"})
            table = pkg.arr(trans)[m]  # (2, 2, 2) over m, prev, cur

            def transition(x_prev, y):
                # the rows (m, x_prev), broadcast as the JAX test's Vindex
                # broadcasts them: m lives on dim -1, x_prev on its own dim
                if isinstance(x_prev, int):
                    probs = table[:, x_prev]
                else:
                    m_all = jnp.arange(2) if pkg is JAX else torch.arange(2)
                    probs = table[m_all, x_prev]
                x = pkg.sample("x", pkg.dist.Categorical(probs), infer={"enumerate": "parallel"})
                pkg.sample("y", pkg.dist.Normal(pkg.arr(LOCS[:2])[x], 1.0), obs=y)
                return x, None

            pkg.scan(transition, 0, ys)

        return model

    emit = norm(LOCS[:2].astype(np.float64), 1.0).logpdf(ys[:, None].astype(np.float64))
    f = [_forward(trans[k][0].astype(np.float64), np.log(trans[k].astype(np.float64)), emit)
         for k in range(2)]
    want = logsumexp([f[0] + np.log(0.7), f[1] + np.log(0.3)])
    got_t = _density(TORCH, make(TORCH), (TORCH.arr(ys),))
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, _density(JAX, make(JAX), (JAX.arr(ys),)), rtol=RTOL)


def test_enumerated_scan_with_a_plate_inside_matches_jax():
    """iid emissions in a plate inside the step: foreign plate axes are
    summed per step before the time collapse."""
    T, N = 8, 5
    P = np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)
    ys = np.random.default_rng(4).standard_normal((T, N)).astype(np.float32)

    def make(pkg):
        def model(ys):
            def transition(x_prev, y):
                x = pkg.sample("x", pkg.dist.Categorical(pkg.arr(P)[x_prev]),
                               infer={"enumerate": "parallel"})
                with pkg.plate("N", N):
                    pkg.sample("y", pkg.dist.Normal(pkg.arr(LOCS[:2])[x], 1.0), obs=y)
                return x, None

            pkg.scan(transition, 0, ys)

        return model

    emit = norm(LOCS[:2].astype(np.float64), 1.0).logpdf(ys[:, :, None]).sum(1)
    want = _forward(P[0].astype(np.float64), np.log(P.astype(np.float64)), emit)
    got_t = _density(TORCH, make(TORCH), (TORCH.arr(ys),), -2)
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, _density(JAX, make(JAX), (JAX.arr(ys),), -2), rtol=RTOL)


def test_enumerated_chain_per_plate_element_matches_jax():
    """The carried discrete lives inside a plate: one chain per element, the
    time collapse batched over the plate axis."""
    T, N = 6, 3
    P = np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)
    ys = np.random.default_rng(5).standard_normal((T, N)).astype(np.float32)

    def make(pkg, zeros):
        def model(ys):
            def transition(x_prev, y):
                with pkg.plate("N", N):
                    x = pkg.sample("x", pkg.dist.Categorical(pkg.arr(P)[x_prev]),
                                   infer={"enumerate": "parallel"})
                    pkg.sample("y", pkg.dist.Normal(pkg.arr(LOCS[:2])[x], 1.0), obs=y)
                return x, None

            pkg.scan(transition, zeros, ys)

        return model

    emit = norm(LOCS[:2].astype(np.float64), 1.0).logpdf(ys[..., None].astype(np.float64))
    want = sum(_forward(P[0].astype(np.float64), np.log(P.astype(np.float64)), emit[:, n])
               for n in range(N))
    got_t = _density(TORCH, make(TORCH, torch.zeros(N, dtype=torch.long)), (TORCH.arr(ys),), -2)
    got_j = _density(JAX, make(JAX, jnp.zeros(N, jnp.int32)), (JAX.arr(ys),), -2)
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL)


def test_history_zero_and_length_one_match_jax():
    T = 6
    ys = np.random.default_rng(6).standard_normal(T).astype(np.float32)
    P = np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)

    def indep(pkg):
        def model(ys):
            def transition(carry, y):
                c = pkg.sample("c", pkg.dist.Bernoulli(0.4), infer={"enumerate": "parallel"})
                pkg.sample("y", pkg.dist.Normal(pkg.arr(LOCS[:2])[c], 1.0), obs=y)
                return carry, None

            pkg.scan(transition, 0.0, ys, history=0)

        return model

    emit = norm(LOCS[:2].astype(np.float64), 1.0).logpdf(ys[:, None].astype(np.float64))
    want0 = logsumexp(emit + np.log([0.6, 0.4]), axis=-1).sum()
    got0 = _density(TORCH, indep(TORCH), (TORCH.arr(ys),))
    np.testing.assert_allclose(got0, want0, rtol=RTOL)
    np.testing.assert_allclose(got0, _density(JAX, indep(JAX), (JAX.arr(ys),)), rtol=RTOL)
    want1 = logsumexp(np.log(P[0].astype(np.float64)) + emit[0])
    got1 = _density(TORCH, _hmm(TORCH, P), (TORCH.arr(ys[:1]),))
    np.testing.assert_allclose(got1, want1, rtol=RTOL)
    np.testing.assert_allclose(got1, _density(JAX, _hmm(JAX, P), (JAX.arr(ys[:1]),)), rtol=RTOL)


def _counter_hmm(pkg, P, reverse=False):
    """An HMM whose carry is its state and a step counter that shifts the
    emission: the carry moves in a way other than the enumerated state."""
    def model(ys):
        def transition(carry, y):
            x_prev, t = carry
            x = pkg.sample("x", pkg.dist.Categorical(pkg.arr(P)[x_prev]))
            pkg.sample("y", pkg.dist.Normal(pkg.arr(LOCS[:2])[x] + 0.3 * t, 1.0), obs=y)
            return (x, t + 1.0), None

        pkg.scan(transition, (0, pkg.arr(0.0)), ys, reverse=reverse)

    return model


@pytest.mark.parametrize("reverse", [False, True])
def test_enumerated_scan_with_a_moving_carry_matches_jax(reverse):
    """T = 7: the steps run one at a time, each from the last one's carry,
    against the JAX package's ``lax.scan`` and the forward algorithm."""
    T = 7
    P = np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)
    ys = np.random.default_rng(9).standard_normal(T).astype(np.float32)
    got_t = _density(TORCH, _counter_hmm(TORCH, P, reverse), (TORCH.arr(ys),))
    got_j = _density(JAX, _counter_hmm(JAX, P, reverse), (JAX.arr(ys),))
    order = ys[::-1] if reverse else ys
    locs = LOCS[:2].astype(np.float64)[None] + 0.3 * np.arange(T)[:, None]
    emit = norm(locs, 1.0).logpdf(order[:, None].astype(np.float64))
    want = _forward(P[0].astype(np.float64), np.log(P.astype(np.float64)), emit)
    np.testing.assert_allclose(got_t, want, rtol=RTOL)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL)


def _latent_hmm(pkg, P, out):
    """An HMM with a continuous latent ``z`` a step beside the enumerated
    state; the scan's outputs, the series of ``z``, go to ``out``."""
    def model(ys):
        def transition(x_prev, y):
            x = pkg.sample("x", pkg.dist.Categorical(pkg.arr(P)[x_prev]))
            z = pkg.sample("z", pkg.dist.Normal(0.0, 1.0))
            pkg.sample("y", pkg.dist.Normal(pkg.arr(LOCS[:2])[x] + z, 1.0), obs=y)
            return x, z

        _, zs = pkg.scan(transition, 0, ys)
        out.append(zs)

    return model


def test_enumerated_scan_with_a_shorter_substituted_series_matches_jax():
    """T = 6, a series of 3 values of ``z`` substituted: the steps past its
    end draw ``z`` from its distribution, as the JAX package's do.  The
    port's density equals the JAX package's with the whole series, the
    given values then the port's draws, substituted."""
    T, n = 6, 3
    P = np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)
    ys = np.random.default_rng(9).standard_normal(T).astype(np.float32)
    z_short = np.random.default_rng(10).standard_normal(n).astype(np.float32)
    out = []
    model = handlers.substitute(handlers.seed(_latent_hmm(TORCH, P, out), 3),
                                data={"z": TORCH.arr(z_short)})
    got_t = _density(TORCH, model, (TORCH.arr(ys),))
    zs = out[-1].numpy()
    assert zs.shape == (T,) and np.array_equal(zs[:n], z_short)
    assert np.unique(zs[n:]).size == T - n  # a draw of its own for each step
    whole = jhandlers.substitute(_latent_hmm(JAX, P, []), data={"z": JAX.arr(zs)})
    np.testing.assert_allclose(got_t, _density(JAX, whole, (JAX.arr(ys),)), rtol=RTOL)


def test_unsupported_enumerated_scans_raise():
    ys = TORCH.arr(np.zeros(4))
    P = np.array([[0.8, 0.2], [0.3, 0.7]], np.float32)
    with pytest.raises(NotImplementedError, match="history <= 1"):
        _density(TORCH, _hmm(TORCH, P, history=2), (ys,))

    def two_sites(ys):
        def transition(x_prev, y):
            x = npt.sample("x", dist.Categorical(TORCH.arr(P)[x_prev]))
            w = npt.sample("w", dist.Bernoulli(0.5))
            npt.sample("y", dist.Normal(x + w, 1.0), obs=y)
            return x, None

        tscan(transition, 0, ys)

    with pytest.raises(NotImplementedError):
        _density(TORCH, two_sites, (ys,))

    def data_carry(ys):
        # the carry depends on the data and the enumerated site on nothing
        # carried: the JAX package's time collapse fails on its factors too
        def transition(c, y):
            x = npt.sample("x", dist.Categorical(TORCH.arr(P)[0]))
            npt.sample("y", dist.Normal(x + c, 1.0), obs=y)
            return c + y, None

        tscan(transition, torch.tensor(0.0), ys)

    with pytest.raises(NotImplementedError, match="must depend on the carried state"):
        _density(TORCH, data_carry, (ys,))

    def under_plate(ys):
        with npt.plate("N", 2):
            tscan(lambda c, y: (c, None), 0.0, ys)

    with pytest.raises(NotImplementedError, match="plate"):
        handlers.trace(under_plate).get_trace(ys)


def test_infer_discrete_of_an_enumerated_scan_raises_where_jax_draws_the_prior():
    """The JAX package gives no decode of a scan's states: its
    ``Predictive(infer_discrete=True)`` draws them from their prior, which
    here agree with the clearly separated generating states no better than
    chance; the port raises."""
    P = np.array([[0.9, 0.1], [0.1, 0.9]], np.float32)
    rng = np.random.default_rng(7)
    z = [0]
    for _ in range(19):
        z.append(rng.choice(2, p=P[z[-1]]))
    z = np.array(z)
    ys = (LOCS[:2][z] + 0.1 * rng.standard_normal(20)).astype(np.float32)
    jpred = jinfer_predictive(_hmm(JAX, P), ys)
    share = (np.asarray(jpred["x"]) == z).mean()
    assert jpred["x"].shape == (50, 20) and share < 0.8
    with pytest.raises(NotImplementedError, match="enumerated scan"):
        Predictive(_hmm(TORCH, P), {"unused": torch.zeros(50)}, infer_discrete=True,
                   device="cpu")(0, TORCH.arr(ys))


def jinfer_predictive(model, ys):
    from numpyro_tpu.infer import Predictive as JPredictive

    predictive = JPredictive(model, {"unused": jnp.zeros(50)}, infer_discrete=True)
    return jax.jit(predictive)(random.PRNGKey(0), JAX.arr(ys))
