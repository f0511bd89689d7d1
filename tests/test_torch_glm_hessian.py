"""Reverse over reverse through the GLM op raises in the port, as it does in
the JAX package: the op's backward multiplies the cotangent by the saved
gradient, and a derivative of that product would need the Hessian, which
the op does not compute.  The port used to mark the saved gradient as
non-differentiable, which gave a silent all-zero Hessian; now a cotangent
reaching it raises ``NotImplementedError``.  The first derivative and the
count of evaluations are unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from numpyro_tpu.ops import glm as jglm
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import optim
from numpyro_tpu_torch.infer import SVI, Trace_ELBO, autoguide
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)


def _problem(n=2000, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    td = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y), dtype=torch.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=jnp.float32)
    return X, y, w, td, jd


def _true_hessian(X, w):
    p = 1 / (1 + np.exp(-(X.astype(np.float64) @ w)))
    return -(X.T * (p * (1 - p))) @ X


def test_jax_raises_on_reverse_over_reverse():
    X, y, w, _, jd = _problem()
    f = lambda w: jglm.bernoulli_logits_loglik(w, jd)  # noqa: E731
    for transform in (lambda: jax.jacrev(jax.grad(f))(jnp.asarray(w)),
                      lambda: jax.hessian(f)(jnp.asarray(w))):
        with pytest.raises(Exception):
            transform()


@pytest.mark.parametrize("how", ["jacrev", "hessian", "vmap", "grad_of_vmap"])
def test_port_raises_where_it_returned_a_zero_hessian(how):
    X, y, w, td, _ = _problem()
    assert abs(_true_hessian(X, w)[0, 0]) > 100  # what a silent zero would hide
    f = lambda w: glm.bernoulli_logits_loglik(w, td)  # noqa: E731
    W = torch.from_numpy(np.stack([w, -w, 2 * w]))
    calls = {
        "jacrev": lambda: torch.func.jacrev(torch.func.grad(f))(torch.from_numpy(w)),
        "hessian": lambda: torch.func.hessian(f)(torch.from_numpy(w)),
        "vmap": lambda: torch.func.vmap(torch.func.jacrev(torch.func.grad(f)))(W),
        "grad_of_vmap": lambda: torch.func.grad(
            lambda W: torch.func.vmap(torch.func.grad(f))(W).square().sum())(W),
    }
    with pytest.raises(NotImplementedError, match="no second derivative"):
        calls[how]()


def test_create_graph_raises_with_the_cause():
    X, y, w, td, _ = _problem()
    wr = torch.from_numpy(w).requires_grad_()
    (g,) = torch.autograd.grad(glm.bernoulli_logits_loglik(wr, td), wr, create_graph=True)
    with pytest.raises(NotImplementedError, match="no second derivative"):
        torch.autograd.grad(g[0], wr)


def test_first_derivative_and_evaluation_count_unchanged():
    """The gradient matches JAX's and the closed form; one plain evaluation
    for a vmap over chains; ``backward`` without a graph still works."""
    X, y, w, td, jd = _problem()
    W = np.stack([w, -w, 2 * w])
    glm.reset_launch_counts()
    g = torch.func.vmap(torch.func.grad(lambda w: glm.bernoulli_logits_loglik(w, td)))(
        torch.from_numpy(W))
    assert glm.launch_counts["plain"] == 1
    jg = jax.vmap(jax.grad(lambda w: jglm.bernoulli_logits_loglik(w, jd)))(jnp.asarray(W))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-3)
    p = 1 / (1 + np.exp(-(X.astype(np.float64) @ W.T)))
    np.testing.assert_allclose(g.numpy(), ((y[:, None] - p).T @ X), rtol=1e-3, atol=1e-3)
    wr = torch.from_numpy(w).requires_grad_()
    glm.bernoulli_logits_loglik(wr, td).backward()
    # one row against three: the products round in another order
    np.testing.assert_allclose(wr.grad.numpy(), g[0].numpy(), rtol=1e-6)


def test_autodais_on_a_glm_model_raises_at_its_first_step():
    """AutoDAIS differentiates the model's gradient inside the ELBO's: on a
    model with the GLM factor the port raises instead of training on a zero
    Hessian (its init, which takes no second derivative, passes)."""
    _, _, _, td, _ = _problem()

    def logreg(data):
        w = npt.sample("w", dist.Normal(torch.zeros(data.d), 1.0).to_event(1))
        npt.factor("lik", glm.bernoulli_logits_loglik(w, data))

    svi = SVI(logreg, autoguide.AutoDAIS(logreg, K=2), optim.Adam(0.01), Trace_ELBO(),
              device="cpu")
    state = svi.init(0, td)
    with pytest.raises(NotImplementedError, match="no second derivative"):
        svi.update(state, td)
