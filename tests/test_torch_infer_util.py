"""The port's model -> density bridge against the JAX package's: the bench
model's potential and gradient at the same unconstrained points, and the
batched initialization."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.infer import util as jutil
from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch.infer import util
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)

# N close below a multiple of 32768: JAX sums the padded columns' log 2 in
# f32 and takes them back out, which costs it ~1e-5 relative when they
# outnumber the data
N, D, C = 30000, 6, 5
# potential: sum of ~N log-likelihood terms; JAX sums in f32, the port in f64
PE_RTOL = 1e-5
G_RTOL, G_ATOL = 1e-3, 1e-3  # as in tests/test_ops_glm.py:35-36


def _data(mode):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, D)))).astype(np.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y),
                               dtype="split" if mode == "split" else jnp.float32)
    td = glm.from_numpy_glm_data(np.asarray(jd.x_t), np.asarray(jd.y_row), N, D,
                                 "split" if mode == "split" else torch.float32)
    return jd, td


def jax_model(data):  # bench.py:125-127
    w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    numpyro_tpu.factor("lik", jglm.bernoulli_logits_loglik(w, data))


def torch_model(data):
    w = npt.sample("w", dist.Normal(torch.zeros(D, device=data.device), 1.0).to_event(1))
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


@pytest.mark.parametrize("mode", ["f32", "split"])
def test_bench_model_potential_and_grad_match_jax(mode):
    jd, td = _data(mode)
    W = (0.5 * np.random.default_rng(1).standard_normal((C, D))).astype(np.float32)
    pe_j, g_j = jax.vmap(
        jax.value_and_grad(partial(jutil.potential_energy, jax_model, (jd,), {}))
    )({"w": jnp.asarray(W)})
    pe_t, g_t = util.batched_value_and_grad(
        partial(util.potential_energy, torch_model, (td,), {})
    )({"w": torch.from_numpy(W)})
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=PE_RTOL)
    np.testing.assert_allclose(g_t["w"].numpy(), np.asarray(g_j["w"]), rtol=G_RTOL, atol=G_ATOL)


def test_log_density_matches_jax():
    jd, td = _data("f32")
    w = (0.3 * np.random.default_rng(2).standard_normal(D)).astype(np.float32)
    lj_j, tr_j = jutil.log_density(jax_model, (jd,), {}, {"w": jnp.asarray(w)})
    lj_t, tr_t = util.log_density(torch_model, (td,), {}, {"w": torch.from_numpy(w)})
    assert list(tr_t) == list(tr_j)
    np.testing.assert_allclose(lj_t.item(), float(lj_j), rtol=PE_RTOL)


def test_initialize_model_batched():
    _, td = _data("split")
    evals = util.potential_evals
    info = util.initialize_model(
        torch.Generator().manual_seed(0), torch_model, num_chains=C,
        dynamic_args=True, model_args=(td,),
    )
    z, pe, grad = info.param_info
    assert z["w"].shape == grad["w"].shape == (C, D) and pe.shape == (C,)
    assert util.potential_evals == evals + 1  # all chains scored at once
    assert bool((z["w"].abs() <= 2.0).all()) and bool(torch.isfinite(pe).all())
    pe_fn = info.potential_fn(td)
    pe_again, _ = util.batched_value_and_grad(pe_fn)(z)
    np.testing.assert_allclose(pe_again.numpy(), pe.numpy(), rtol=1e-6)
    assert info.postprocess_fn(td)(z)["w"] is z["w"]


def test_find_valid_initial_params_retries_invalid_chains():
    def model():
        w = npt.sample("w", dist.Normal(torch.zeros(3), 1.0).to_event(1))
        npt.factor("gate", torch.where(w[0] > 1.0, 0.0, -torch.inf))

    (params, pe, grad), ok = util.find_valid_initial_params(
        torch.Generator().manual_seed(0), model, num_chains=64,
        prototype_params={"w": torch.zeros(3)},
    )
    # a chain is valid only with w[0] > 1 (a quarter of the init box): the
    # masked loop redraws just the invalid chains until all are valid
    assert bool(ok.all()) and bool((params["w"][:, 0] > 1.0).all())
    assert bool(torch.isfinite(pe).all()) and grad["w"].shape == (64, 3)
