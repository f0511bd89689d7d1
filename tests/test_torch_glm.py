"""The port's fused GLM op against the JAX package's.

On the CPU the JAX op takes its plain XLA path (``_xla_fused``, as in
tests/test_ops_glm.py) and the port takes its plain PyTorch version; both
score the same padded matrix.  The CUDA kernels are checked against the
plain version on a GPU by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)

# log-likelihood: rtol 1e-5 (JAX sums the nll in f32, the port in f64);
# gradient: rtol/atol 1e-3 as in tests/test_ops_glm.py:35-36 (the port's
# plain version splits w and the residual hi+lo like the kernels; JAX's
# plain path keeps both in f32)
LL_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-3, 1e-3
MODES = {"f32": (jnp.float32, torch.float32), "split": ("split", "split"),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def _problem(n=5000, d=7, c=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = (0.3 * rng.standard_normal((c, d))).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    return X, y, W


def _both(X, y, mode):
    jmode, tmode = MODES[mode]
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=jmode)
    td = glm.from_numpy_glm_data(np.asarray(jd.x_t), np.asarray(jd.y_row), jd.n, jd.d, tmode)
    return jd, td


def _jax_reference(W, jd, mode):
    """JAX's (loglik, grad) for chains ``W`` (C, D) or one chain (D,).

    The bf16 mode's TPU kernel rounds w and the residual to bf16
    (glm.py:330-331, :354-355) while JAX's plain path keeps both in f32; so
    JAX is handed the rounded w, and its gradient is the residual rounded
    as the kernel rounds it, contracted with the same matrix."""
    w = jnp.asarray(W)
    if mode == "bf16":
        w = w.astype(jnp.bfloat16).astype(jnp.float32)
    f = jax.value_and_grad(jglm.bernoulli_logits_loglik)
    ll, g = (jax.vmap(f, in_axes=(0, None)) if w.ndim == 2 else f)(w, jd)
    if mode == "bf16":
        x = jd.x_t.astype(jnp.float32)[: jd.d]
        r = jax.nn.sigmoid(w @ x) - jd.y_row[0]
        g = -(r.astype(jnp.bfloat16).astype(jnp.float32) @ x.T)
    return np.asarray(ll), np.asarray(g)


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_value_and_grad_matches_jax(mode):
    X, y, W = _problem()
    jd, td = _both(X, y, mode)
    ll_j, g_j = _jax_reference(W, jd, mode)
    glm.reset_launch_counts()
    g_t, ll_t = torch.func.vmap(
        torch.func.grad_and_value(glm.bernoulli_logits_loglik), in_dims=(0, None)
    )(torch.from_numpy(W), td)
    # the vmap rule sends all chains to ONE evaluation
    assert glm.launch_counts["plain"] == 1
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=LL_RTOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_single_chain_matches_jax(mode):
    X, y, W = _problem()
    jd, td = _both(X, y, mode)
    ll_j, g_j = _jax_reference(W[0], jd, mode)
    w = torch.from_numpy(W[0]).requires_grad_()
    ll_t = glm.bernoulli_logits_loglik(w, td)
    ll_t.backward()
    assert ll_t.shape == ()
    np.testing.assert_allclose(ll_t.item(), float(ll_j), rtol=LL_RTOL)
    np.testing.assert_allclose(w.grad.numpy(), g_j, rtol=G_RTOL, atol=G_ATOL)


def test_bf16_gradient_near_jax_plain_path():
    """The bf16 mode against JAX's own plain path on the same bf16 matrix.

    JAX's ``_xla_fused`` keeps w and the residual in f32, where the port (and
    the TPU kernel) rounds both to bf16; the gradients may differ by the
    first-order effect of those two roundings, summed over the data:
    |dg_j| <= sum_n |x_nj| (|x_n| . |w - bf16(w)| / 4 + 2^-8 |r_n|)
    (sigmoid' <= 1/4; a bf16 rounding is within 2^-9 relative, doubled for
    the f32 sums)."""
    X, y, W = _problem()
    jd, td = _both(X, y, "bf16")
    f = jax.vmap(jax.value_and_grad(jglm.bernoulli_logits_loglik), in_axes=(0, None))
    _, g_j = f(jnp.asarray(W), jd)
    g_t, _ = torch.func.vmap(
        torch.func.grad_and_value(glm.bernoulli_logits_loglik), in_dims=(0, None)
    )(torch.from_numpy(W), td)
    x = np.asarray(jd.x_t.astype(jnp.float32))[: jd.d, : jd.n].astype(np.float64)
    dw = np.abs(W - np.asarray(jnp.asarray(W).astype(jnp.bfloat16).astype(jnp.float32)))
    r = 1.0 / (1.0 + np.exp(-(W.astype(np.float64) @ x))) - y
    bound = (np.abs(x).T[None] * (dw @ np.abs(x) / 4 + 2.0**-8 * np.abs(r))[..., None]).sum(1)
    assert np.all(np.abs(g_t.numpy() - np.asarray(g_j)) <= bound)
    # the roundings do move the gradient: this is not a vacuous comparison
    assert np.abs(g_t.numpy() - np.asarray(g_j)).max() > 1e-3


@pytest.mark.parametrize("mode", list(MODES))
def test_prepare_matches_jax_layout(mode):
    X, y, _ = _problem(n=1000, d=5)
    jd, td = _both(X, y, mode)
    ours = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y), dtype=MODES[mode][1])
    assert ours.x_t.shape == (8, 32768) and ours.x_t.dtype == td.x_t.dtype
    as_bits = (lambda t: t.view(torch.int16)) if td.x_t.dtype == torch.bfloat16 else (lambda t: t)
    assert torch.equal(as_bits(ours.x_t), as_bits(td.x_t))
    assert torch.equal(ours.y_row, td.y_row)


def test_split_hi_lo_matches_reduce_precision_bitwise():
    w = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32) * 0.5
    hi_j, lo_j = jglm.split_hi_lo(jnp.asarray(w))
    hi_t, lo_t = glm.split_hi_lo(torch.from_numpy(w))
    np.testing.assert_array_equal(hi_t.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(hi_j).view(np.uint16))
    np.testing.assert_array_equal(lo_t.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(lo_j).view(np.uint16))
    assert lo_t.float().abs().max() > 0
    np.testing.assert_allclose((hi_t.float() + lo_t.float()).numpy(), w, rtol=2**-16, atol=1e-7)


def test_other_devices_raise():
    X, y, W = _problem(n=100, d=3, c=2)
    data = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y))
    with pytest.raises(NotImplementedError):
        glm.glm_value_and_grad(torch.empty((2, 3), device="meta"), data)
