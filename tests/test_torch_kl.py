"""The port's KL rows against the JAX package's, on the pairs of
``tests/test_kl.py::PAIRS`` (each widened to a batch of 3 by numpy draws
from a seed), and the combinators over them.  Tolerance: rtol 1e-5, atol
1e-6 (float32 formulas in the same order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import numpyro_tpu.distributions as jdist
from numpyro_tpu.distributions.kl import kl_divergence as jkl
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions import kl_divergence

torch.set_num_threads(1)


def _rng_params(seed, **centers):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v, np.float32) * (1 + 0.2 * rng.uniform(-1, 1, (3,) + np.shape(v))))
            .astype(np.float32) for k, v in centers.items()}


# name, p's class and params, q's class and params (the centres of PAIRS)
PAIRS = [
    ("Normal", dict(loc=0.3, scale=1.2), "Normal", dict(loc=-0.5, scale=2.0)),
    ("Beta", dict(concentration1=2.0, concentration0=3.0),
     "Beta", dict(concentration1=4.0, concentration0=1.5)),
    ("Gamma", dict(concentration=2.5, rate=1.2), "Gamma", dict(concentration=1.1, rate=0.7)),
    ("Dirichlet", dict(concentration=[1.5, 2.5, 3.0]),
     "Dirichlet", dict(concentration=[3.0, 1.0, 2.0])),
    ("CategoricalProbs", dict(probs=[0.2, 0.3, 0.5]),
     "CategoricalProbs", dict(probs=[0.5, 0.25, 0.25])),
    ("CategoricalLogits", dict(logits=[0.1, -0.4, 1.0]),
     "CategoricalLogits", dict(logits=[-1.0, 0.3, 0.2])),
    ("Weibull", dict(scale=1.5, concentration=2.0), "Gamma", dict(concentration=2.0, rate=1.0)),
    ("Kumaraswamy", dict(concentration1=2.0, concentration0=3.0),
     "Beta", dict(concentration1=1.5, concentration0=2.5)),
]


def _pair(i):
    pn, pp, qn, qp = PAIRS[i]
    pp, qp = _rng_params(2 * i, **pp), _rng_params(2 * i + 1, **qp)
    for params in (pp, qp):
        if "probs" in params:
            params["probs"] = params["probs"] / params["probs"].sum(-1, keepdims=True)
    make = lambda mod, n, ps, conv: getattr(mod, n)(**{k: conv(v) for k, v in ps.items()})  # noqa
    return (make(dist, pn, pp, torch.from_numpy), make(dist, qn, qp, torch.from_numpy),
            make(jdist, pn, pp, jnp.asarray), make(jdist, qn, qp, jnp.asarray))


@pytest.mark.parametrize("i", range(len(PAIRS)), ids=[f"{p[0]}-{p[2]}" for p in PAIRS])
def test_kl_rows_match_jax(i):
    p_t, q_t, p_j, q_j = _pair(i)
    got = kl_divergence(p_t, q_t)
    want = np.asarray(jkl(p_j, q_j))
    assert tuple(got.shape) == want.shape == (3,)
    # Kumaraswamy/Beta sums terms of order 1 to a KL near 0.01: each term
    # is 1e-6 apart in float32 (the port's betaln runs in float64), so 5e-6
    atol = 5e-6 if PAIRS[i][0] == "Kumaraswamy" else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


def test_kumaraswamy_beta_taylor_order_is_read_from_p():
    p_t, q_t, p_j, q_j = _pair(len(PAIRS) - 1)
    p_t.KL_KUMARASWAMY_BETA_TAYLOR_ORDER = 50
    p_j.KL_KUMARASWAMY_BETA_TAYLOR_ORDER = 50
    np.testing.assert_allclose(kl_divergence(p_t, q_t).numpy(), np.asarray(jkl(p_j, q_j)),
                               rtol=1e-5, atol=5e-6)
    assert not torch.allclose(kl_divergence(p_t, q_t),
                              kl_divergence(dist.Kumaraswamy(p_t.concentration1,
                                                             p_t.concentration0), q_t))


@pytest.mark.parametrize("i", [1, 2])
def test_kl_rows_through_the_combinators(i):
    """Expanded and independent Beta and Gamma pairs, as TraceMeanField_ELBO
    meets them."""
    p_t, q_t, p_j, q_j = _pair(i)
    got = kl_divergence(p_t.expand((4, 3)).to_event(1), q_t.expand((4, 3)).to_event(1))
    want = jkl(p_j.expand((4, 3)).to_event(1), q_j.expand((4, 3)).to_event(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
