"""The port on a CUDA GPU: each hand-written kernel against its plain
PyTorch version, the one-launch vmap rule, and a short NUTS run.

Every test here carries ``requires_cuda`` and skips without a GPU.  The file
imports no JAX, so it also runs where JAX is not installed:
``python -m pytest tests/test_torch_cuda.py -m requires_cuda``.
"""

import numpy as np
import pytest
import torch

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.infer import MCMC, NUTS
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)

# kernel against plain: the same products summed in another order
LL_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-3, 1e-3
MODES = {"f32": torch.float32, "split": "split", "bf16": torch.bfloat16}
KERNEL = {"f32": "glm_fused_f32", "split": "glm_split", "bf16": "glm_fused_bf16"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, n=70000, d=70, c=40, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    true_w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ true_w))).astype(np.float32)
    W = (true_w + 0.05 * rng.standard_normal((c, d))).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(X), to(y), to(W), true_w


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_matches_plain(cuda, mode):
    X, y, W, _ = _problem(cuda)
    data = glm.prepare_glm_data(X, y, dtype=MODES[mode])
    before = glm.launch_counts[KERNEL[mode]]
    ll_k, g_k = glm.glm_value_and_grad(W, data)
    ll_p, g_p = glm.plain_value_and_grad(W, data)
    torch.cuda.synchronize()
    assert glm.launch_counts[KERNEL[mode]] == before + 1
    torch.testing.assert_close(ll_k, ll_p, rtol=LL_RTOL, atol=0)
    torch.testing.assert_close(g_k, g_p, rtol=G_RTOL, atol=G_ATOL)
    # no float atomics: a second call gives the same bits
    ll_2, g_2 = glm.glm_value_and_grad(W, data)
    assert torch.equal(ll_k, ll_2) and torch.equal(g_k, g_2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c", [1, 33])  # a partial chain tile is masked
def test_vmap_makes_one_launch(cuda, c):
    X, y, W, _ = _problem(cuda, n=40000, d=9, c=c)
    data = glm.prepare_glm_data(X, y, dtype="split")
    before = glm.launch_counts["glm_split"]
    g, ll = torch.func.vmap(
        torch.func.grad_and_value(glm.bernoulli_logits_loglik), in_dims=(0, None)
    )(W, data)
    assert glm.launch_counts["glm_split"] == before + 1
    ll_p, g_p = glm.plain_value_and_grad(W, data)
    torch.testing.assert_close(ll, ll_p, rtol=LL_RTOL, atol=0)
    torch.testing.assert_close(g, g_p, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.requires_cuda
def test_short_nuts_run_on_gpu(cuda):
    X, y, _, true_w = _problem(cuda, n=20000, d=5, c=1)
    data = glm.prepare_glm_data(X, y, dtype="split")

    def model(data):
        w = npt.sample("w", dist.Normal(torch.zeros(5, device=data.device), 1.0).to_event(1))
        npt.factor("lik", glm.bernoulli_logits_loglik(w, data))

    mcmc = MCMC(NUTS(model), num_warmup=150, num_samples=150, num_chains=16)
    before = glm.launch_counts["glm_split"]
    mcmc.run(torch.Generator(device=cuda).manual_seed(0), data)
    stats = mcmc.last_run_stats
    w = mcmc.get_samples()["w"]
    assert w.device.type == "cuda" and w.shape == (16 * 150, 5)
    assert glm.launch_counts["glm_split"] - before == stats["potential_evals"] + 1
    assert (w.mean(0).cpu() - torch.from_numpy(true_w)).abs().max() < 0.05
