"""The port on a CUDA GPU: each hand-written kernel against its plain
PyTorch version, the one-launch vmap rule, a short NUTS run, HMCECS in
every panel mode, dense mass, SVI through the split kernel, 8-schools
and stochastic volatility (``Predictive``, the new samplers on a CUDA
generator and ``soft_vmap`` over a model replay), and the HMM slice
(``Categorical`` and ``Dirichlet`` draws, the enumerated density of both
forms of ``examples/hmm_enum.py`` against a numpy forward algorithm, the
error past 25 dims), one step of SMC, the Gibbs sweep, BarkerMH, SA,
AIES and ESS against the CPU on the same draws, and the flow guides:
the GLM op's raise on a second derivative, and an IAF's NeuTra potential
through ``glm_split`` against the CPU; the discrete, conjugate and
directional families on the card against the CPU, their draws through the
port's ``gof``, and a Gamma draw's exact derivative in both modes; and the
structured and matrix families and transforms on the card against the CPU,
their draws through ``gof``, a Wishart gradient on the same draws, and
phase 17's two potentials; ``Vindex``, a validated ``log_prob`` and
``cond`` on the card against the CPU, and phase 18b's host syncs against
its twin's; the HSGP potentials on the card against the CPU without host
syncs, the nested sampler, and DCC and SDVI on the card; one SVGD and one
SteinVI step on the card against the CPU from the same particles and draws;
a checkpoint saved from the card restored onto the card and onto the CPU,
``torch_module``'s ELBO on the card against the CPU's, and the compat
``SVI`` on the card by default; a one-rank mesh that leaves ``glm_split``'s
bits as they are, and whose data shard ``subsample`` takes from as from the
data; an enumerated ``scan`` whose carry moves beside its state, and one
given a series shorter than itself, on the card against the CPU; phase
23g's model with a latent a row over two thread ranks of a data group on
the card against one process.

Every test here carries ``requires_cuda`` and skips without a GPU, but the
check that SteinVI and SVGD raise without one, which runs everywhere.  The file
imports no JAX, so it also runs where JAX is not installed:
``python -m pytest tests/test_torch_cuda.py -m requires_cuda``.
"""

import numpy as np
import pytest
import torch

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.control_flow import scan
from numpyro_tpu_torch.contrib.enum import config_enumerate, enum, log_density, markov
from numpyro_tpu_torch.infer import (
    HMCECS, MCMC, NUTS, SVI, Predictive, Trace_ELBO, log_likelihood, reparam,
)
from numpyro_tpu_torch.infer import autoguide
from numpyro_tpu_torch.util import soft_vmap
from numpyro_tpu_torch.optim import Adam
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)


def _assert_matches_plain(got, want, mode, n):
    """Kernel against plain version within ``glm.kernel_tolerances``."""
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances(mode, n)
    torch.testing.assert_close(got[0], want[0], rtol=ll_rtol, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=g_rtol, atol=g_atol)


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


def _same_bits(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", list(MODES))
# (n, d, chains): a partial 128-chain tile over two d-blocks; five 64-chain
# tiles whose warpgroups split the columns; four d-blocks; one small tile
@pytest.mark.parametrize("shape", [(70000, 70, 100), (50000, 55, 300), (33000, 200, 70),
                                   (5000, 7, 5)])
def test_kernel_matches_plain_at_ragged_shapes(cuda, mode, shape):
    n, d, c = shape
    X, y, W, _ = _problem(cuda, n=n, d=d, c=c, seed=1)
    data = glm.prepare_glm_data(X, y, dtype=MODES[mode])
    first = glm.glm_value_and_grad(W, data)
    second = glm.glm_value_and_grad(W, data)
    plain = glm.plain_value_and_grad(W, data)
    torch.cuda.synchronize()
    assert _same_bits(first, second)  # no float atomics, a fixed order of sums
    _assert_matches_plain(first, plain, mode, n)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_matches_plain(cuda, mode):
    X, y, W, _ = _problem(cuda)
    data = glm.prepare_glm_data(X, y, dtype=MODES[mode])
    before = glm.launch_counts[KERNEL[mode]]
    got = glm.glm_value_and_grad(W, data)
    plain = glm.plain_value_and_grad(W, data)
    torch.cuda.synchronize()
    assert glm.launch_counts[KERNEL[mode]] == before + 1
    _assert_matches_plain(got, plain, mode, X.shape[0])
    # no float atomics: a second call gives the same bits
    assert _same_bits(got, glm.glm_value_and_grad(W, data))


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
    _assert_matches_plain((ll, g), glm.plain_value_and_grad(W, data), "split", X.shape[0])


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


def _ecs_model(X, y):
    w = npt.sample("w", dist.Normal(torch.zeros(5, device=X.device), 1.0).to_event(1))
    with npt.plate("N", X.shape[0], subsample_size=500):
        xb = npt.subsample(X, event_dim=1)
        yb = npt.subsample(y, event_dim=0)
        npt.sample("obs", dist.Bernoulli(logits=xb @ w), obs=yb)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("panel_mode", ["carry", "bf16", "lean"])
def test_hmcecs_runs_on_gpu(cuda, panel_mode):
    """64 chains, 10 + 10 transitions, N = 20,000, with no ``device`` given:
    the run is on the card, the draws are finite and near the generating
    coefficients, and the subsampling path launches no GLM kernel."""
    X, y, _, true_w = _problem(cuda, n=20000, d=5, c=1)
    kernel = HMCECS(NUTS(_ecs_model, max_tree_depth=5), num_blocks=20,
                    proxy=HMCECS.taylor_proxy({"w": true_w}), panel_mode=panel_mode)
    mcmc = MCMC(kernel, num_warmup=10, num_samples=10, num_chains=64)
    assert mcmc.device == torch.device("cuda")
    before = dict(glm.launch_counts)
    mcmc.run(0, X, y)
    w = mcmc.get_samples(group_by_chain=True)["w"]
    assert w.device.type == "cuda" and w.shape == (64, 10, 5)
    assert bool(torch.isfinite(w).all())
    assert (w.mean((0, 1)).cpu() - torch.from_numpy(true_w)).abs().max() < 0.2
    assert kernel.resolved_modes == {"proxy": "stats", "panel": panel_mode}
    last = mcmc.last_state
    assert last.z["N"].device.type == "cuda" and not torch.equal(last.z["N"][0], last.z["N"][1])
    assert dict(glm.launch_counts) == before


@pytest.mark.requires_cuda
def test_carry_and_lean_give_the_same_potential_on_gpu(cuda):
    """From generators in the same state, three transitions with carried
    panels and with gathers inside every evaluation (potential to rtol 1e-5)."""
    X, y, _, true_w = _problem(cuda, n=20000, d=5, c=1)
    out = {}
    for mode in ("carry", "lean"):
        kernel = HMCECS(NUTS(_ecs_model, max_tree_depth=3), num_blocks=20,
                        proxy=HMCECS.taylor_proxy({"w": true_w}), panel_mode=mode)
        gen = torch.Generator(device=cuda).manual_seed(3)
        state = kernel.init(gen, 5, None, (X, y), {}, num_chains=64)
        for _ in range(3):
            state = kernel.sample(state, (X, y), {})
        out[mode] = state
    assert torch.equal(out["carry"].z["N"], out["lean"].z["N"])
    torch.testing.assert_close(
        out["carry"].hmc_state.potential_energy, out["lean"].hmc_state.potential_energy,
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.requires_cuda
def test_generator_of_another_device_raises_on_gpu(cuda):
    mcmc = MCMC(NUTS(_ecs_model), num_warmup=1, num_samples=1, num_chains=2)
    with pytest.raises(ValueError, match="lives on cpu and the run on cuda"):
        mcmc.run(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# Dense and structured mass matrices on the card

def _mass_problem(structure, c=64):
    """Sites "a" (3,), "b" () and "w" (40,): the blocks of ``structure``, a
    random exposed mass (SPD dense blocks, positive diagonals) and a
    ``(C, K, D)`` panel, all on the CPU."""
    from numpyro_tpu_torch.infer import hmc_core as core

    layout = core.FlatLayout({"a": torch.zeros(3), "b": torch.zeros(()), "w": torch.zeros(40)})
    blocks = core.build_mass_blocks(layout, structure)
    gen = torch.Generator().manual_seed(0)
    parts = []
    for idx, dense in zip(blocks.indices, blocks.dense):
        b = len(idx)
        if dense:
            a = torch.randn((c, b, b), generator=gen)
            parts.append(a @ a.transpose(1, 2) / b + 0.5 * torch.eye(b))
        else:
            parts.append(torch.rand((c, b), generator=gen) + 0.5)
    r = torch.randn((c, 4, layout.dim), generator=gen)
    return core, blocks, core._expose(blocks, parts), r


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: v.to(device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("structure", [True, [("w", "a")]], ids=["dense", "structured"])
def test_dense_and_structured_mass_on_gpu_match_the_cpu(cuda, structure):
    """``apply_inv_mass`` on ``(C, K, D)`` panels, ``draw_momentum`` and the
    precision factors of every dense block, on the card against the same calls
    on the CPU (rtol 1e-5; the factors of 40 x 40 blocks to atol 1e-4)."""
    core, blocks, inv, r = _mass_problem(structure)
    got = core.apply_inv_mass(blocks, _to(inv, cuda), r.to(cuda))
    torch.testing.assert_close(got.cpu(), core.apply_inv_mass(blocks, inv, r), rtol=1e-5,
                               atol=1e-5)
    eps = r[:, 0]
    torch.testing.assert_close(core.draw_momentum(blocks, _to(inv, cuda), eps.to(cuda)).cpu(),
                               core.draw_momentum(blocks, inv, eps), rtol=1e-5, atol=1e-5)
    for m in core._as_parts(blocks, inv):
        if m.dim() == 3:
            for g, w in zip(core._precision_factors(m.to(cuda)), core._precision_factors(m)):
                torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_precision_factors_make_no_host_sync(cuda):
    """``cholesky_ex`` reports a matrix that is not positive definite on the
    device: the factors come back NaN there, with no synchronization."""
    from numpyro_tpu_torch.infer import hmc_core as core

    _, _, inv, _ = _mass_problem(True, c=8)
    cov = inv.to(cuda)
    cov[3] = -cov[3]  # not positive definite
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sqrt, sqrt_inv = core._precision_factors(cov)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isnan(sqrt[3]).all()) and bool(torch.isfinite(sqrt[:3]).all())
    assert bool(torch.isfinite(sqrt_inv[4:]).all())


@pytest.mark.requires_cuda
def test_dense_mass_nuts_on_a_correlated_gaussian_on_gpu(cuda):
    """The target of tests/infer/test_mcmc.py:36-58 under a dense mass with
    64 chains on the card: means within 0.3, stds within 15%."""
    a = np.random.RandomState(0).randn(5, 5)
    cov = a @ a.T + 0.1 * np.eye(5)
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32)).to(cuda)
    mcmc = MCMC(NUTS(potential_fn=lambda z: 0.5 * z["z"] @ prec @ z["z"], dense_mass=True,
                     max_tree_depth=(6, 10)), num_warmup=150, num_samples=100, num_chains=64)
    mcmc.run(0, init_params={"z": torch.zeros((64, 5), device=cuda)})
    draws = mcmc.get_samples()["z"]
    assert draws.device.type == "cuda"
    inv = mcmc.last_state.adapt_state.inverse_mass_matrix
    assert inv.shape == (64, 5, 5) and inv.device.type == "cuda"
    draws = draws.double().cpu().numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(5), atol=0.3)
    np.testing.assert_allclose(draws.std(0), np.sqrt(np.diag(cov)), rtol=0.15)


def _svi_model(loglik):
    def model(data):
        w = npt.sample("w", dist.Normal(torch.zeros(data.d, device=data.device), 1.0).to_event(1))
        npt.factor("lik", loglik(w, data))

    return model


@pytest.mark.requires_cuda
def test_svi_runs_on_cuda_by_default_with_one_launch_per_step(cuda):
    X, y, _, true_w = _problem(cuda, n=40000, d=6, c=1)
    data = glm.prepare_glm_data(X, y, dtype="split")
    model = _svi_model(glm.bernoulli_logits_loglik)
    svi = SVI(model, autoguide.AutoDiagonalNormal(model), Adam(0.02), Trace_ELBO(16))
    assert svi.device == torch.device("cuda")
    state = svi.init(0, data)
    before = glm.launch_counts["glm_split"]
    torch.backends.cuda.matmul.allow_tf32 = True
    res = svi.run(None, 300, data, init_state=state)
    # the TF32 pin holds through the run; 16 particles, one launch a step
    assert not torch.backends.cuda.matmul.allow_tf32
    assert glm.launch_counts["glm_split"] - before == 300
    assert res.losses.device.type == "cuda" and res.params["auto_loc"].device.type == "cuda"
    loc = res.params["auto_loc"].cpu()
    assert (loc - torch.from_numpy(true_w)).abs().max() < 0.1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("particles", [1, 16])
def test_one_elbo_gradient_through_the_kernel_matches_plain(cuda, particles):
    """AutoDelta at one particle (B = 1), AutoDiagonalNormal at 16 (B = 16):
    the loss and its gradient through ``glm_split`` against the same through
    the plain version, on the same draws."""
    X, y, _, _ = _problem(cuda, n=70000, d=8, c=1)
    data = glm.prepare_glm_data(X, y, dtype="split")
    name = "AutoDelta" if particles == 1 else "AutoDiagonalNormal"
    guide = getattr(autoguide, name)(_svi_model(glm.bernoulli_logits_loglik))
    svi = SVI(_svi_model(glm.bernoulli_logits_loglik), guide, Adam(0.02), Trace_ELBO(particles))
    state = svi.init(0, data)
    u = svi.optim.get_params(state.optim_state)
    loss = Trace_ELBO(particles)
    got = {}
    for tag, loglik in (("kernel", glm.bernoulli_logits_loglik),
                        ("plain", glm.plain_bernoulli_logits_loglik)):
        before = dict(glm.launch_counts)

        def fn(v, loglik=loglik):
            gen = torch.Generator(device=cuda).manual_seed(3)
            return loss.loss(gen, svi.constrain_fn(v), _svi_model(loglik), guide, data)

        got[tag] = torch.func.grad_and_value(fn)(u)
        launched = {k: glm.launch_counts[k] - before[k] for k in before}
        assert launched["glm_split" if tag == "kernel" else "plain"] == 1
    (g_k, l_k), (g_p, l_p) = got["kernel"], got["plain"]
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances("split", X.shape[0])
    torch.testing.assert_close(l_k, l_p, rtol=ll_rtol, atol=0)
    for k in g_p:
        torch.testing.assert_close(g_k[k], g_p[k], rtol=g_rtol, atol=g_atol)


def _eight_schools(y, sigma):
    mu = npt.sample("mu", dist.Normal(0.0, 5.0))
    tau = npt.sample("tau", dist.HalfCauchy(5.0))
    with npt.plate("J", 8):
        theta = npt.sample("theta", dist.Normal(mu, tau))
        npt.sample("obs", dist.Normal(theta, sigma), obs=y)


_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)


@pytest.mark.requires_cuda
def test_eight_schools_predictive_on_a_cuda_generator(cuda):
    """A non-centred run on the card, its deterministic ``theta`` replayed,
    then ``Predictive`` and ``log_likelihood``: every result on the card
    and finite."""
    y, sigma = torch.tensor(_Y, device=cuda), torch.tensor(_SIGMA, device=cuda)
    model = handlers.reparam(_eight_schools, config={"theta": reparam.LocScaleReparam(0)})
    mcmc = MCMC(NUTS(model, max_tree_depth=(4, 6)), num_warmup=30, num_samples=20,
                num_chains=8)
    mcmc.run(0, y, sigma)
    z = mcmc.get_samples()
    assert z["theta"].shape == (160, 8) and z["theta"].device.type == "cuda"
    pred = Predictive(model, z)(torch.Generator(device=cuda).manual_seed(1), None, sigma)
    assert pred["obs"].device.type == "cuda" and pred["obs"].shape == (160, 8)
    assert torch.isfinite(pred["obs"]).all()
    assert len(torch.unique(pred["obs"][:, 0])) == 160
    ll = log_likelihood(model, z, y, sigma)["obs"]
    torch.testing.assert_close(ll, dist.Normal(z["theta"], sigma).log_prob(y),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.requires_cuda
def test_student_t_and_exponential_draws_on_a_cuda_generator(cuda):
    """The gamma draw of ``StudentT`` takes a CUDA generator, also under
    ``vmap(randomness="different")``, where every element draws anew."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    df = torch.full((4096,), 4.0, device=cuda)
    t = dist.StudentT(df, 0.0, 1.0).sample(gen)
    e = dist.Exponential(df).sample(gen)
    for x in (t, e):
        assert x.device.type == "cuda" and torch.isfinite(x).all()
    # the mean of Exponential(4) is 0.25, its std 0.25: within 4 standard errors
    assert abs(e.mean().item() - 0.25) < 4 * 0.25 / 64

    def one(d):
        return dist.StudentT(d, 0.0, 1.0).sample(gen) + dist.Exponential(d).sample(gen)

    out = torch.func.vmap(one, randomness="different")(df[:256])
    assert out.device.type == "cuda" and torch.isfinite(out).all()
    assert len(torch.unique(out)) == 256


@pytest.mark.requires_cuda
def test_soft_vmap_over_a_replay_on_the_card(cuda):
    """A replay of the model in chunks that do not divide the batch, on the
    card: the recomputed deterministic site is exact and the draws differ."""
    sigma = torch.tensor(_SIGMA, device=cuda)
    model = handlers.reparam(_eight_schools, config={"theta": reparam.LocScaleReparam(0)})
    gen = torch.Generator(device=cuda).manual_seed(2)
    samples = {"mu": torch.randn(50, device=cuda, generator=gen),
               "tau": torch.rand(50, device=cuda, generator=gen) + 0.5,
               "theta_decentered": torch.randn(50, 8, device=cuda, generator=gen)}

    def one(s):
        tr = handlers.trace(handlers.seed(handlers.substitute(model, s), gen)).get_trace(
            None, sigma)
        return {"theta": tr["theta"]["value"], "obs": tr["obs"]["value"]}

    out = soft_vmap(one, samples, 1, 16)
    want = samples["mu"][:, None] + samples["tau"][:, None] * samples["theta_decentered"]
    torch.testing.assert_close(out["theta"], want, rtol=1e-6, atol=1e-6)
    assert out["obs"].shape == (50, 8) and out["obs"].device.type == "cuda"
    assert len(torch.unique(out["obs"][:, 0])) == 50


@pytest.mark.requires_cuda
def test_categorical_and_dirichlet_draws_on_a_cuda_generator(cuda):
    """Gumbel-max and gamma draws take a CUDA generator; under
    ``vmap(randomness="different")`` every element draws anew."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    probs = torch.tensor([0.2, 0.5, 0.3], device=cuda)
    c = dist.Categorical(probs).sample(gen, (20000,))
    freq = torch.bincount(c, minlength=3).double().cpu().numpy() / 20000
    assert c.device.type == cuda.type
    assert np.all(np.abs(freq - [0.2, 0.5, 0.3]) < 4 * np.sqrt(0.25 / 20000))
    conc = torch.tensor([1.0, 2.0, 3.0], device=cuda)
    d = dist.Dirichlet(conc).sample(gen, (20000,))
    assert d.device.type == cuda.type and torch.allclose(d.sum(-1), torch.ones((), device=cuda))
    assert np.all(np.abs(d.mean(0).cpu().numpy() - [1 / 6, 2 / 6, 3 / 6]) < 0.01)

    def one(p):
        return dist.Categorical(p).sample(gen, (8,)).float() + dist.Dirichlet(conc).sample(gen)[0]

    out = torch.func.vmap(one, randomness="different")(probs.expand(256, 3))
    assert out.device.type == cuda.type and len(torch.unique(out[:, 0])) == 256


def _hmm_data(T=30):
    rng = np.random.RandomState(0)
    trans = np.array([[0.85, 0.15], [0.25, 0.75]])
    z = [rng.choice(2, p=[0.6, 0.4])]
    for _ in range(1, T):
        z.append(rng.choice(2, p=trans[z[-1]]))
    return (np.array([-1.0, 1.0])[z] + 0.3 * rng.randn(T)).astype(np.float32)


def _hmm_markov(ys):
    locs = torch.tensor([-1.0, 1.0], device=ys.device)
    probs = npt.sample("trans", dist.Dirichlet(torch.ones((2, 2), device=ys.device)).to_event(1))
    sigma = npt.sample("sigma", dist.HalfNormal(torch.tensor(1.0, device=ys.device)))
    z = npt.sample("z_0", dist.Categorical(torch.tensor([0.5, 0.5], device=ys.device)),
                   infer={"enumerate": "parallel"})
    npt.sample("y_0", dist.Normal(locs[z], sigma), obs=ys[0])
    for t in markov(range(1, ys.shape[0])):
        z = npt.sample(f"z_{t}", dist.Categorical(probs[z]), infer={"enumerate": "parallel"})
        npt.sample(f"y_{t}", dist.Normal(locs[z], sigma), obs=ys[t])


def _hmm_scan(ys):
    locs = torch.tensor([-1.0, 1.0], device=ys.device)
    probs = npt.sample("trans", dist.Dirichlet(torch.ones((2, 2), device=ys.device)).to_event(1))
    sigma = npt.sample("sigma", dist.HalfNormal(torch.tensor(1.0, device=ys.device)))

    def transition(z_prev, y):
        z = npt.sample("z", dist.Categorical(probs[z_prev]), infer={"enumerate": "parallel"})
        npt.sample("y", dist.Normal(locs[z], sigma), obs=y)
        return z, None

    scan(transition, 0, ys)


def _forward(ys, trans, sigma, init):
    """log p(ys) by the forward algorithm in float64 numpy."""
    emit = -0.5 * ((ys[:, None] - np.array([-1.0, 1.0])) / sigma) ** 2 - np.log(
        sigma * np.sqrt(2 * np.pi))
    alpha = np.log(init) + emit[0]
    for t in range(1, len(ys)):
        a = alpha[:, None] + np.log(trans)
        alpha = np.log(np.exp(a - a.max(0)).sum(0)) + a.max(0) + emit[t]
    return np.log(np.exp(alpha - alpha.max()).sum()) + alpha.max()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("form", ["markov", "scan"])
def test_enumerated_hmm_density_on_the_card_matches_numpy(cuda, form):
    """The enumerated log joint of both forms of ``examples/hmm_enum.py``
    on the card, batched over 16 chains as a run evaluates it: the forward
    algorithm plus the HalfNormal(1) prior (the Dirichlet(1, 1) rows have
    density 1), to 1e-5 relative."""
    ys_np = _hmm_data()
    ys = torch.from_numpy(ys_np).to(cuda)
    model = _hmm_markov if form == "markov" else _hmm_scan
    gen = torch.Generator(device=cuda).manual_seed(5)
    trans = dist.Dirichlet(torch.ones(2, device=cuda)).sample(gen, (16, 2))
    sigma = 0.2 + torch.rand(16, device=cuda, generator=gen)
    wrapped = enum(config_enumerate(model), first_available_dim=-1)
    got = torch.func.vmap(
        lambda t, s: log_density(wrapped, (ys,), {}, {"trans": t, "sigma": s})[0]
    )(trans, sigma)
    assert got.device.type == cuda.type
    for i in range(16):
        tr = trans[i].double().cpu().numpy()
        s = sigma[i].item()
        init = tr[0] if form == "scan" else np.array([0.5, 0.5])
        want = _forward(ys_np.astype(np.float64), tr, s, init) + (
            0.5 * np.log(2 / np.pi) - 0.5 * s * s)
        np.testing.assert_allclose(got[i].item(), want, rtol=1e-5)


def _many_bernoullis(n, device):
    def model():
        x = npt.sample("x", dist.Normal(torch.tensor(0.0, device=device), 1.0))
        for i in range(n):
            npt.sample(f"b{i}", dist.Bernoulli(logits=x), infer={"enumerate": "parallel"})
    return model


@pytest.mark.requires_cuda
def test_more_than_25_dims_raise_clearly_on_the_card(cuda):
    """24 enumeration dims under the chain vmap make 25 dims, which the
    card takes; 25 make 26, which raise before any kernel is launched."""
    xs = torch.linspace(-1.0, 1.0, 3, device=cuda)

    def density(n):
        wrapped = enum(config_enumerate(_many_bernoullis(n, cuda)), first_available_dim=-1)
        return torch.func.vmap(lambda x: log_density(wrapped, (), {}, {"x": x})[0])(xs)

    got = density(24)
    # each enumerated Bernoulli sums out to 1: only the Normal prior is left
    want = -0.5 * xs**2 - 0.5 * np.log(2 * np.pi)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="more than the 25"):
        density(25)


# ---------------------------------------------------------------------------
# SMC, the Gibbs sweep and the gradient-free and ensemble kernels: one step
# on the card against the CPU, on the same draws (this file imports no JAX,
# so the draws come from numpy)


class NumpyDraws:
    """The port's draw-source protocol, drawn by numpy from a seed and put on
    the device of ``like``: two sources made from one seed give the CPU and
    the card the same numbers."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def _put(self, x, like, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=like.device)

    def normals(self, shape, like):
        return self._put(self.rng.standard_normal(shape), like)

    def uniforms(self, shape, like):
        return self._put(self.rng.random(shape), like)

    def exponentials(self, shape, like):
        return self._put(self.rng.exponential(size=shape), like)

    def gumbels(self, shape, like):
        return self._put(self.rng.gumbel(size=shape), like)

    def randints(self, low, high, shape, like):
        high = torch.as_tensor(high).cpu().numpy()
        return self._put(self.rng.integers(low, high, size=shape), like, torch.int64)

    def permutations(self, shape, like):
        return self._put(self.rng.random(shape).argsort(-1), like, torch.int64)

    def choice(self, weights):
        w = weights.cpu().numpy()
        return int(self.rng.choice(len(w), p=w / w.sum()))

    def categorical(self, weights, shape):
        w = weights.cpu().numpy().astype(np.float64)
        return self._put(self.rng.choice(len(w), size=shape, p=w / w.sum()), weights,
                         torch.int64)

    def fork(self):
        return self


def _assert_trees_close(a, b, rtol=1e-5, atol=1e-5):
    """Two states (namedtuples of tensors, numbers and draw sources), one of
    them on the card, equal within the tolerance: float32 arithmetic in
    another order on the card."""
    if isinstance(a, torch.Tensor):
        b = b.to(a.device)
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        else:
            assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_close(a[k], b[k], rtol, atol)
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _assert_trees_close(x, y, rtol, atol)
    elif isinstance(a, (int, float)):
        assert a == b


def _schools(y, sigma):
    mu = npt.sample("mu", dist.Normal(0.0, 5.0))
    tau = npt.sample("tau", dist.HalfCauchy(5.0))
    with npt.plate("J", 8):
        theta = npt.sample("theta", dist.Normal(mu, tau))
        npt.sample("obs", dist.Normal(theta, sigma), obs=y)


@pytest.mark.requires_cuda
def test_one_smc_stage_on_the_card_matches_the_cpu(cuda):
    """8-schools non-centred, 1,024 particles: the initial cloud from numpy,
    then one tempering stage (bisection, reweighting, resampling, 5 MH steps)
    on each device from the same particles and draws."""
    from numpyro_tpu_torch.infer import SMC
    from numpyro_tpu_torch.infer.reparam import LocScaleReparam

    model = handlers.reparam(_schools, config={"theta": LocScaleReparam(0)})
    y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
    sigma = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
    p = 1024
    cloud = np.random.default_rng(0).standard_normal((p, 10)).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), cuda):
        smc = SMC(model, num_particles=p, device=device)
        args = (torch.tensor(y, device=device), torch.tensor(sigma, device=device))
        smc._setup(torch.Generator(device=device).manual_seed(0), args, {})
        particles = torch.from_numpy(cloud).to(device)
        _, log_lik = smc._split_log_probs(particles)
        out[device.type] = smc._stage(NumpyDraws(1), particles, torch.zeros(p, device=device),
                                      log_lik, 0.0, torch.zeros((), device=device))
    got, want = out["cuda"], out["cpu"]
    assert abs(got[4] - want[4]) <= 1e-6 * max(abs(want[4]), 1e-3)  # the next temperature
    _assert_trees_close(want[:4], got[:4], rtol=1e-4, atol=1e-4)
    assert got[0].device.type == "cuda"


@pytest.mark.requires_cuda
def test_one_gibbs_sweep_on_the_card_matches_the_cpu(cuda):
    """``_discrete_sweep`` over two discrete sites of 64 chains, every
    candidate of every chain in one batched evaluation of the model."""
    from numpyro_tpu_torch.infer import DiscreteHMCGibbs
    from numpyro_tpu_torch.infer.hmc_gibbs import _discrete_sweep, _site_element_layout

    def make_model(device):
        locs = torch.tensor([-1.0, 0.0, 1.0, 2.0], device=device)

        def model():
            c = npt.sample("c", dist.Categorical(torch.tensor([0.1, 0.4, 0.3, 0.2],
                                                              device=device)))
            d = npt.sample("d", dist.Bernoulli(torch.tensor(0.3, device=device)))
            npt.sample("x", dist.Normal(locs[c] + d, 0.5))

        return model

    c_chains = 64
    rng = np.random.default_rng(2)
    c0, d0 = rng.integers(0, 4, c_chains), rng.integers(0, 2, c_chains)
    x0 = (1.5 * rng.standard_normal(c_chains)).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), cuda):
        kernel = DiscreteHMCGibbs(NUTS(make_model(device), max_tree_depth=2))
        kernel.init(torch.Generator(device=device).manual_seed(0), 2, None, (), {},
                    num_chains=c_chains)
        z_hmc = {"x": torch.from_numpy(x0).to(device)}
        pe_cand, pe_one = kernel._candidate_potentials((), {}, z_hmc)
        flat = kernel._gibbs_layout.ravel_batch({
            "c": torch.from_numpy(c0).to(device),
            "d": torch.from_numpy(d0).to(device, torch.float32)})
        _, sizes = _site_element_layout(kernel._support_sizes)
        pe = pe_one(flat)
        out[device.type] = _discrete_sweep(
            pe_cand, pe_one, NumpyDraws(3), flat, pe, torch.as_tensor(sizes, device=device).long(),
            mode="gibbs", smax=4)
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1].cpu(), out["cpu"][1], rtol=1e-5, atol=1e-5)


def _gauss_pe(z):
    return 0.5 * (((z - 1.0) / 2.0) ** 2).sum()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel", ["barker", "sa", "aies", "ess"])
def test_one_step_of_each_gradient_free_or_ensemble_kernel_on_the_card(cuda, kernel):
    """``init`` and two ``sample`` calls of BarkerMH, SA, AIES and ESS, 16
    chains of a 3-d Gaussian, on each device from the same params and
    draws."""
    from numpyro_tpu_torch.infer import AIES, ESS, SA, BarkerMH

    make = {"barker": lambda: BarkerMH(potential_fn=_gauss_pe),
            "sa": lambda: SA(potential_fn=_gauss_pe, adapt_state_size=8),
            "aies": lambda: AIES(potential_fn=_gauss_pe, moves={AIES.DEMove(): 0.5,
                                                                AIES.StretchMove(): 0.5}),
            "ess": lambda: ESS(potential_fn=_gauss_pe)}[kernel]
    z0 = np.random.default_rng(4).standard_normal((16, 3)).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), cuda):
        k = make()
        draws = NumpyDraws(5)
        state = k.init(draws, 5, torch.from_numpy(z0).to(device), (), {}, num_chains=16)
        for _ in range(2):
            state = k.sample(state, (), {})
        out[device.type] = state
    assert out["cuda"].z.device.type == "cuda"
    _assert_trees_close(out["cpu"], out["cuda"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# ChEES, the low-rank Normal, BFGS and TraceGraph_ELBO against the CPU


def _chees_glm_model(data):
    w = npt.sample("w", dist.Normal(torch.zeros(data.d, device=data.device), 1.0).to_event(1))
    npt.factor("lik", glm.bernoulli_logits_loglik(w, data))


@pytest.mark.requires_cuda
def test_one_chees_transition_on_the_card_matches_the_cpu(cuda):
    """32 chains on a 20,000 x 10 logistic regression in split mode, two
    transitions after warmup from the same state on numpy draws: every
    leapfrog step is one ``glm_split`` launch on the card (the plain version
    on the CPU).  Positions and potentials at rtol 1e-4; the accept
    probabilities at atol 1e-3, since each is the exponential of a difference
    of two Hamiltonians of about 1.2e4, whose float32 rounding in another
    order is about 1e-3."""
    from numpyro_tpu_torch.infer import CheesHMC

    rng = np.random.default_rng(6)
    X = rng.standard_normal((20000, 10)).astype(np.float32)
    true_w = (0.3 * rng.standard_normal(10)).astype(np.float32)
    y = (rng.random(20000) < 1 / (1 + np.exp(-X @ true_w))).astype(np.float32)
    w0 = (true_w + 0.01 * rng.standard_normal((32, 10))).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), cuda):
        data = glm.prepare_glm_data(torch.from_numpy(X).to(device), torch.from_numpy(y).to(device),
                                    dtype="split")
        kernel = CheesHMC(_chees_glm_model, step_size=0.01, trajectory_length=0.08,
                          max_num_steps=16)
        state = kernel.init(torch.Generator(device=device).manual_seed(0), 0,
                            {"w": torch.from_numpy(w0).to(device)}, (data,), {}, num_chains=32)
        state = state._replace(rng_key=NumpyDraws(7))
        counter = "glm_split" if device.type == "cuda" else "plain"
        for _ in range(2):
            before = glm.launch_counts[counter]
            state = kernel.sample(state, (data,), {})
            # the first gradient and one launch a leapfrog step
            assert glm.launch_counts[counter] - before == int(state.num_steps) + 1
        out[device.type] = state
    got, want = out["cuda"], out["cpu"]
    assert got.z["w"].device.type == "cuda" and got.i == want.i == 2
    assert int(got.num_steps) == int(want.num_steps)
    assert torch.equal(got.diverging.cpu(), want.diverging)
    _assert_trees_close((want.z, want.potential_energy, want.adapt_state),
                        (got.z, got.potential_energy, got.adapt_state), rtol=1e-4, atol=1e-5)
    _assert_trees_close((want.accept_prob, want.mean_accept_prob),
                        (got.accept_prob, got.mean_accept_prob), rtol=0, atol=1e-3)


@pytest.mark.requires_cuda
def test_low_rank_normal_log_prob_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(8)
    loc = rng.standard_normal((4, 30)).astype(np.float32)
    factor = (0.3 * rng.standard_normal((30, 5))).astype(np.float32)
    diag = (0.5 + rng.random(30)).astype(np.float32)
    value = rng.standard_normal((6, 4, 30)).astype(np.float32)
    out = {}
    for device in (torch.device("cpu"), cuda):
        d = dist.LowRankMultivariateNormal(*(torch.from_numpy(a).to(device)
                                             for a in (loc, factor, diag)))
        out[device.type] = (d.log_prob(torch.from_numpy(value).to(device)), d.variance,
                            d.entropy())
    _assert_trees_close(out["cpu"], out["cuda"], rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_a_minimize_fit_on_the_card_matches_the_cpu(cuda):
    """BFGS on a logistic regression's negative log likelihood (2,000 x 6) in
    float64, where the gradient's rounding is far below gtol and both devices
    take the same iterations, and one ``Minimize`` step of ``AutoDelta`` on
    a conjugate model in float32."""
    from numpyro_tpu_torch.infer import SVI, Trace_ELBO
    from numpyro_tpu_torch.optim import Minimize
    from numpyro_tpu_torch.optimize import minimize

    rng = np.random.default_rng(9)
    X = rng.standard_normal((2000, 6)).astype(np.float32)
    y = (rng.random(2000) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, 6)))).astype(np.float32)
    ys = rng.normal(2.0, 1.0, 40).astype(np.float32)

    def model(ys):
        mu = npt.sample("mu", dist.Normal(0.0, 5.0))
        with npt.plate("N", ys.shape[0]):
            npt.sample("y", dist.Normal(mu, 1.0), obs=ys)

    out = {}
    for device in (torch.device("cpu"), cuda):
        Xd = torch.from_numpy(X).to(device, torch.float64)
        yd = torch.from_numpy(y).to(device, torch.float64)

        def nll(w):
            logits = Xd @ w
            return (torch.nn.functional.softplus(logits) - yd * logits).mean()

        res = minimize(nll, torch.zeros(6, device=device, dtype=torch.float64), method="BFGS")
        guide = autoguide.AutoDelta(model)
        svi = SVI(model, guide, Minimize(), Trace_ELBO(), device=device)
        fit = svi.run(0, 1, torch.from_numpy(ys).to(device))
        out[device.type] = (res.x, res.fun, res.nit, fit.params["auto_mu_loc"], fit.losses)
    assert out["cuda"][0].device.type == "cuda" and out["cuda"][2] == out["cpu"][2]
    _assert_trees_close(out["cpu"], out["cuda"], rtol=1e-4, atol=1e-5)


class _GivenDraw(dist.Distribution):
    """``base`` whose draw is the given value (a site's value from numpy)."""

    def __init__(self, base, value):
        self.base, self.value = base, value
        self.support, self.has_rsample = base.support, base.has_rsample
        super().__init__(base.batch_shape, base.event_shape)

    def sample(self, key, sample_shape=()):
        return self.value

    def log_prob(self, value):
        return self.base.log_prob(value)


@pytest.mark.requires_cuda
def test_the_tracegraph_surrogate_gradient_on_the_card_matches_the_cpu(cuda):
    """A plate of 64 Bernoulli latents with a reparameterised global, at the
    same latents (numpy) on both devices: the provenance pass, the
    Rao-Blackwellized costs and the surrogate's gradient."""
    from numpyro_tpu_torch.infer import TraceGraph_ELBO

    rng = np.random.default_rng(10)
    data = rng.standard_normal(64).astype(np.float32)
    z = (rng.random(64) < 0.5).astype(np.int64)
    phi = rng.standard_normal(64).astype(np.float32)
    eps = np.float32(0.3)
    out = {}
    for device in (torch.device("cpu"), cuda):
        zd, dd = torch.from_numpy(z).to(device), torch.from_numpy(data).to(device)

        def model():
            loc = npt.sample("loc", dist.Normal(torch.zeros((), device=device), 1.0))
            with npt.plate("N", 64):
                zz = npt.sample("z", dist.Bernoulli(torch.full((), 0.4, device=device)))
                npt.sample("x", dist.Normal(loc + zz, 1.0), obs=dd)

        def loss(p):
            def guide():
                base = dist.Normal(p["m"], 0.5)
                npt.sample("loc", _GivenDraw(base, base.loc + base.scale * eps))
                with npt.plate("N", 64):
                    npt.sample("z", _GivenDraw(dist.Bernoulli(logits=p["phi"]), zd))

            return TraceGraph_ELBO().loss(torch.Generator(device=device).manual_seed(0), {},
                                          model, guide)

        params = {"m": torch.tensor(0.2, device=device),
                  "phi": torch.from_numpy(phi).to(device)}
        out[device.type] = torch.func.grad_and_value(loss)(params)
    assert out["cuda"][1].device.type == "cuda"
    _assert_trees_close(out["cpu"], out["cuda"], rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
def test_reverse_over_reverse_through_glm_split_raises_on_the_card(cuda):
    """The Hessian through the split kernel raises, where marking the saved
    gradient non-differentiable gave zeros; the gradient stays one launch."""
    X, y, W, _ = _problem(cuda, n=20000, d=12, c=8)
    data = glm.prepare_glm_data(X, y, dtype="split")
    f = lambda w: glm.bernoulli_logits_loglik(w, data)  # noqa: E731
    glm.reset_launch_counts()
    g = torch.func.vmap(torch.func.grad(f))(W)
    assert glm.launch_counts["glm_split"] == 1 and torch.isfinite(g).all()
    with pytest.raises(NotImplementedError, match="no second derivative"):
        torch.func.jacrev(torch.func.grad(f))(W[0])
    with pytest.raises(NotImplementedError, match="no second derivative"):
        torch.func.hessian(f)(W[0])


@pytest.mark.requires_cuda
def test_flow_guides_and_neutra_on_the_card_match_the_cpu(cuda):
    """An IAF guide's params made on the CPU, moved to the card: the flow,
    its log-Jacobian and the NeuTra potential's gradient through
    ``glm_split`` (one launch for the chains) against the CPU's plain
    version; then an ``AutoBNAFNormal`` and an ``AutoDAIS`` step and draw on
    a CUDA generator."""
    from numpyro_tpu_torch.infer.reparam import NeuTraReparam
    from numpyro_tpu_torch.util import tree_map

    rng = np.random.default_rng(11)
    d = 6
    X = np.concatenate([rng.standard_normal((30000, d - 1)), np.ones((30000, 1))], 1)
    X = X.astype(np.float32)
    y = (rng.random(30000) < 0.5).astype(np.float32)
    z = rng.standard_normal((16, d)).astype(np.float32)
    out = {}
    cpu_params = None
    for device in (torch.device("cpu"), cuda):
        data = glm.prepare_glm_data(torch.from_numpy(X).to(device),
                                    torch.from_numpy(y).to(device), dtype="split")

        def model(data):
            w = npt.sample("w", dist.Normal(torch.zeros(d, device=data.device), 1.0).to_event(1))
            npt.factor("lik", glm.bernoulli_logits_loglik(w, data))

        guide = autoguide.AutoIAFNormal(model, num_flows=2)
        svi = SVI(model, guide, Adam(0.01), Trace_ELBO(), device=device)
        state = svi.init(0, data)
        params = svi.get_params(state)
        if cpu_params is None:
            cpu_params = params
        params = tree_map(lambda t: t.to(device), cpu_params)
        neutra = NeuTraReparam(guide, params)
        reparamed = neutra.reparam(model)
        pe = lambda v: infer_potential(reparamed, data, v)  # noqa: E731
        glm.reset_launch_counts()
        g, v = torch.func.vmap(torch.func.grad_and_value(pe))(torch.from_numpy(z).to(device))
        if device.type == "cuda":
            assert glm.launch_counts["glm_split"] == 1
        out[device.type] = (v, g, neutra.transform_sample(torch.from_numpy(z).to(device))["w"])
    ll_rtol, g_rtol, g_atol = glm.kernel_tolerances("split", 30000)
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], rtol=ll_rtol, atol=0)
    torch.testing.assert_close(out["cuda"][1].cpu(), out["cpu"][1], rtol=g_rtol, atol=g_atol)
    torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-5, atol=1e-6)

    def small(yy):
        x = npt.sample("x", dist.Normal(torch.zeros(2, device=cuda), 1.0).to_event(1))
        npt.sample("y", dist.Normal(x.sum(), 0.5), obs=yy)

    yy = torch.tensor(2.0, device=cuda)
    for guide in (autoguide.AutoBNAFNormal(small), autoguide.AutoDAIS(small, K=2)):
        res = SVI(small, guide, Adam(0.01), Trace_ELBO(num_particles=4)).run(0, 5, yy)
        draws = guide.sample_posterior(torch.Generator(device=cuda).manual_seed(1), res.params,
                                       sample_shape=(10,))
        assert res.losses.device.type == "cuda" and torch.isfinite(res.losses).all()
        assert draws["x"].device.type == "cuda" and draws["x"].shape == (10, 2)


def infer_potential(model, data, z):
    from numpyro_tpu_torch.infer.util import potential_energy

    return potential_energy(model, (data,), {}, {"w_shared_latent": z})


# ---------------------------------------------------------------------------
# the continuous families, the truncated family and AutoSemiDAIS (phase 15c)


def _phase15():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


@pytest.mark.requires_cuda
def test_new_families_on_the_card_match_the_cpu(cuda):
    """Every new class's ``log_prob``, ``cdf`` and ``icdf`` on CUDA tensors
    against the same calls on CPU tensors, to ``chip_smoke.FAMILY_RTOL`` and
    ``FAMILY_ATOL`` (the card's special functions round differently in the
    last bits), and its draws on a CUDA generator inside its support."""
    cs = _phase15()
    q = torch.linspace(0.05, 0.95, 12).reshape(4, 3)
    for name, params in cs.FAMILIES.items():
        d_cpu, d_dev = cs._family(name, params, torch.device("cpu")), cs._family(name, params, cuda)
        x = d_cpu.sample(torch.Generator().manual_seed(0), (4,))
        for method, arg in (("log_prob", x), ("cdf", x), ("icdf", q)):
            try:
                want = getattr(d_cpu, method)(arg)
            except NotImplementedError:
                with pytest.raises(NotImplementedError):
                    getattr(d_dev, method)(arg.to(cuda))
                continue
            got = getattr(d_dev, method)(arg.to(cuda))
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.cpu(), want, rtol=cs.FAMILY_RTOL, atol=cs.FAMILY_ATOL,
                                       msg=f"{name}.{method}")
        draw = d_dev.sample(torch.Generator(device=cuda).manual_seed(1), (8,))
        assert draw.device.type == "cuda" and bool(d_dev.support(draw).all()), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["Gamma", "Beta"])
def test_gamma_and_beta_draws_on_a_cuda_generator_match_their_moments(cuda, name):
    cs = _phase15()
    d = cs._family(name, cs.FAMILIES[name], cuda)
    n = 20_000
    x = d.sample(torch.Generator(device=cuda).manual_seed(2), (n,)).double()
    mean, var = d.mean.double(), d.variance.double()
    assert ((x.mean(0) - mean).abs() < 4 * torch.sqrt(var / n)).all()
    se_var = torch.sqrt(((x - x.mean(0)) ** 4).mean(0) / n)
    assert ((x.var(0) - var).abs() < 4 * se_var).all()


@pytest.mark.requires_cuda
def test_mvn_not_positive_definite_gives_nan_on_the_card(cuda):
    cov = torch.tensor([[[2.0, 0.5], [0.5, 1.0]], [[1.0, 2.0], [2.0, 1.0]]], device=cuda)
    lp = dist.MultivariateNormal(torch.zeros(2, device=cuda), covariance_matrix=cov).log_prob(
        torch.zeros(2, device=cuda))
    assert torch.isfinite(lp[0]) and torch.isnan(lp[1])


@pytest.mark.requires_cuda
def test_semi_dais_steps_on_the_card(cuda):
    cs = _phase15()
    model, local_model, global_model = cs.semi_models(cuda)
    guide = autoguide.AutoSemiDAIS(model, local_model, autoguide.AutoNormal(global_model), K=3)
    res = SVI(model, guide, Adam(5e-3), Trace_ELBO()).run(0, 20)
    assert res.losses.device.type == "cuda" and torch.isfinite(res.losses).all()
    assert res.params["auto_eta0"].shape == (16,) and res.params["auto_eta0"].device.type == "cuda"


# ---------------------------------------------------------------------------
# the discrete, conjugate and directional families (phase 16c)


@pytest.mark.requires_cuda
def test_discrete_and_directional_families_on_the_card_match_the_cpu(cuda):
    """Every class of ``chip_smoke.NEW_FAMILIES``: ``log_prob``, ``cdf`` and
    ``icdf`` on CUDA tensors against the same calls on CPU tensors, to
    ``FAMILY_RTOL`` and ``FAMILY_ATOL``, and its draws on a CUDA generator
    inside its support."""
    cs = _phase15()
    q = torch.linspace(0.05, 0.95, 12).reshape(4, 3)
    for name, params in cs.NEW_FAMILIES.items():
        d_cpu = cs.new_family(name, params, torch.device("cpu"))
        d_dev = cs.new_family(name, params, cuda)
        x = d_cpu.sample(torch.Generator().manual_seed(0), (4,))
        for method, arg in (("log_prob", x), ("cdf", x), ("icdf", q)):
            try:
                want = getattr(d_cpu, method)(arg)
            except NotImplementedError:
                with pytest.raises(NotImplementedError):
                    getattr(d_dev, method)(arg.to(cuda))
                continue
            got = getattr(d_dev, method)(arg.to(cuda))
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.cpu(), want, rtol=cs.FAMILY_RTOL, atol=cs.FAMILY_ATOL,
                                       msg=f"{name}.{method}")
        draw = d_dev.sample(torch.Generator(device=cuda).manual_seed(1), (8,))
        assert draw.device.type == "cuda" and bool(d_dev.support(draw).all()), name
    flat = dist.ImproperUniform(dist.constraints.positive, (3,), ())
    assert bool((flat.log_prob(torch.rand(4, 3, device=cuda)) == 0).all())
    with pytest.raises(NotImplementedError):
        flat.sample(torch.Generator(device=cuda))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("label", ["binomial n p = 2.4", "binomial n p = 30", "Poisson",
                                   "Multinomial", "VonMises", "SineBivariateVonMises", "Gamma"])
def test_draws_on_a_cuda_generator_pass_the_gof_test(cuda, label):
    cs = _phase15()
    name, params = cs.GOF_CASES[label]
    d = cs.new_family(name, params, cuda)
    x = d.sample(torch.Generator(device=cuda).manual_seed(3), (cs.GOF_DRAWS,))
    assert x.device.type == "cuda" and not torch.isnan(x.double()).any()
    assert cs._gof_of(name, d, x) > cs.GOF_FAILURE_RATE


@pytest.mark.requires_cuda
def test_gamma_draw_gradient_and_forward_mode_on_the_card(cuda):
    """The reparameterised derivative of a Gamma draw on the card, in reverse
    and forward mode, against the CPU's exact derivative of the same draw, at
    shapes through the series, the continued fraction and Temme's expansion."""
    from numpyro_tpu_torch.distributions.util import _gamma_draw_derivative

    alpha = torch.tensor([0.3, 2.0, 40.0, 5e3, 1e5], device=cuda, requires_grad=True)
    g = dist.Gamma(alpha, 1.0).sample(torch.Generator(device=cuda).manual_seed(4), (64,))
    g.sum().backward()
    want = _gamma_draw_derivative(alpha.detach().cpu().expand(64, 5), g.detach().cpu())
    torch.testing.assert_close(alpha.grad.cpu(), want.sum(0).float(), rtol=1e-5, atol=0)
    _, tangent = torch.func.jvp(
        lambda a: dist.Gamma(a, 1.0).sample(torch.Generator(device=cuda).manual_seed(4), (64,)),
        (alpha.detach(),), (torch.ones(5, device=cuda),))
    torch.testing.assert_close(tangent.cpu(), want.float(), rtol=1e-5, atol=0)


@pytest.mark.requires_cuda
def test_binomial_and_von_mises_draws_under_soft_vmap_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    counts = torch.tensor([825.0, 108.0, 25.0], device=cuda)
    x = soft_vmap(lambda p: dist.Binomial(counts, probs=p).sample(gen),
                  torch.rand(64, 3, device=cuda))
    assert x.device.type == "cuda" and x.shape == (64, 3) and bool((x <= counts).all())
    y = soft_vmap(lambda k: dist.VonMises(0.0, k).sample(gen),
                  torch.full((64,), 5.0, device=cuda))
    assert not torch.isnan(y).any() and len(torch.unique(y)) == 64


# ---------------------------------------------------------------------------
# the structured and matrix families (phase 17c)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["MultivariateStudentT", "LKJCholesky", "LKJ", "Wishart",
                                  "WishartCholesky", "ZeroSumNormal", "MatrixNormal", "CAR",
                                  "EulerMaruyama", "GaussianStateSpace", "CirculantNormal",
                                  "FoldedDistribution", "MixtureSameFamily", "MixtureGeneral",
                                  "GaussianCopula", "GaussianCopulaBeta"])
def test_structured_families_on_the_card_match_the_cpu(cuda, name):
    """Each class of ``chip_smoke.STRUCTURED``: ``log_prob`` on CUDA tensors
    against CPU tensors, to ``FAMILY_RTOL`` and ``FAMILY_ATOL``, and finite
    densities of its draws on a CUDA generator."""
    cs = _phase15()
    d_cpu, d_dev = cs.structured_family(name, torch.device("cpu")), cs.structured_family(name,
                                                                                          cuda)
    x = d_cpu.sample(torch.Generator().manual_seed(0), (4,))
    got = d_dev.log_prob(x.to(cuda))
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), d_cpu.log_prob(x), rtol=cs.FAMILY_RTOL,
                               atol=cs.FAMILY_ATOL)
    draw = d_dev.sample(torch.Generator(device=cuda).manual_seed(1), (8,))
    assert draw.device.type == "cuda" and bool(torch.isfinite(d_dev.log_prob(draw)).all())


@pytest.mark.requires_cuda
def test_structured_transforms_on_the_card_match_the_cpu(cuda):
    cs = _phase15()
    on_cpu, on_dev = cs.structured_transforms(torch.device("cpu")), cs.structured_transforms(cuda)
    for name, (t_cpu, x_cpu) in on_cpu.items():
        t_dev, x_dev = on_dev[name]
        y_cpu, y_dev = t_cpu(x_cpu), t_dev(x_dev)
        for got, want in ((y_dev, y_cpu), (t_dev.inv(y_dev), t_cpu.inv(y_cpu)),
                          (t_dev.log_abs_det_jacobian(x_dev, y_dev),
                           t_cpu.log_abs_det_jacobian(x_cpu, y_cpu))):
            assert got.device.type == "cuda", name
            assert cs._close_on(got, want) <= 1.0, name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["MultivariateStudentT", "ZeroSumNormal", "LKJCholesky",
                                  "Wishart", "MatrixNormal", "CirculantNormal",
                                  "MixtureSameFamily"])
def test_structured_draws_on_a_cuda_generator_pass_the_gof_test(cuda, name):
    from numpyro_tpu_torch.distributions.gof import auto_goodness_of_fit

    cs = _phase15()
    d = cs.gof_family(name, cuda)
    x = d.sample(torch.Generator(device=cuda).manual_seed(3), (cs.GOF_DRAWS // 4,))
    assert x.device.type == "cuda" and bool(torch.isfinite(x).all())
    for label, (stat, density) in cs.gof_statistics(name, d, x).items():
        assert auto_goodness_of_fit(stat, density) > cs.GOF_FAILURE_RATE, label


@pytest.mark.requires_cuda
def test_wishart_gradient_on_the_card_matches_the_cpu_on_the_same_draws(cuda):
    cs = _phase15()
    recorded = cs.RecordedDraws(torch.Generator(device=cuda).manual_seed(4))
    g_dev = cs.wishart_gradient(cuda, recorded)
    g_cpu = cs.wishart_gradient(torch.device("cpu"), cs.ReplayedDraws(recorded.items, "cpu"))
    for a, b in zip(g_dev, g_cpu):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=cs.FAMILY_RTOL, atol=cs.FAMILY_ATOL)


@pytest.mark.requires_cuda
def test_structured_models_potential_on_the_card_matches_the_cpu(cuda):
    """Phase 17's two models: the potential and its gradient at 256 points
    on the card against the CPU (``chip_smoke.potential_check`` raises
    where they differ), and no host sync from the corr-Cholesky map or the
    mixture's density."""
    cs = _phase15()
    for model, data in ((cs.lkj_model, cs.lkj_data()), (cs.mix_model, cs.mix_data())):
        y = torch.from_numpy(data).to(cuda)
        _, _, sites, constrained = cs.potential_check(
            "card test", model, y, cs.STRUCTURED_POINTS, cs.STRUCTURED_RTOL, 174, scale=0.5)
        assert not any("transforms.py" in s or "mixtures.py" in s for s in sites), sites
    assert bool((constrained["mu"][:, 1:] > constrained["mu"][:, :-1]).all())


@pytest.mark.requires_cuda
def test_wishart_and_student_t_not_positive_definite_give_nan_on_the_card(cuda):
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], device=cuda)
    good = torch.tensor([[2.0, 0.5], [0.5, 1.0]], device=cuda)
    w = dist.Wishart(torch.tensor(5.0, device=cuda), scale_matrix=torch.stack([good, bad]))
    lp = w.log_prob(2.0 * good)
    assert torch.isfinite(lp[0]) and torch.isnan(lp[1])
    from numpyro_tpu_torch.distributions.util import cholesky

    t = dist.MultivariateStudentT(torch.tensor(4.0, device=cuda), torch.zeros(2, device=cuda),
                                  cholesky(torch.stack([good, bad])))
    lp = t.log_prob(torch.ones(2, device=cuda))
    assert torch.isfinite(lp[0]) and torch.isnan(lp[1])


@pytest.mark.requires_cuda
def test_vindex_on_the_card_matches_the_cpu(cuda):
    """``examples/annotation.py``'s enumerated index, and a slice between two
    batched keys, on CUDA tensors against CPU tensors (exactly)."""
    from numpyro_tpu_torch.ops.indexing import Vindex, vindex

    beta = torch.randn(5, 3, 3, generator=torch.Generator().manual_seed(0))
    positions, c = torch.arange(5), torch.arange(3).reshape(3, 1, 1)
    want = Vindex(beta)[positions, c, :]
    got = Vindex(beta.to(cuda))[positions.to(cuda), c.to(cuda), :]
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    keys = (torch.tensor([0, 2, 4]), slice(None), torch.tensor([1, 0, 2]))
    got = vindex(beta.to(cuda), tuple(k.to(cuda) if torch.is_tensor(k) else k for k in keys))
    assert torch.equal(got.cpu(), vindex(beta, keys))


@pytest.mark.requires_cuda
def test_validated_log_prob_on_the_card_matches_the_cpu(cuda):
    """With validation on, an out-of-support value's ``-inf`` and an
    in-support value's density on the card are the CPU's, and under
    ``vmap`` nothing is read on the host (no sync)."""
    cs = _phase15()
    values = torch.tensor([[0.2, 0.3, 0.5], [0.5, 0.6, -0.1]])
    with dist.validation_enabled():
        d_cpu = dist.Dirichlet(torch.tensor([1.0, 2.0, 3.0]))
        d_dev = dist.Dirichlet(torch.tensor([1.0, 2.0, 3.0], device=cuda))
        with pytest.warns(UserWarning, match="Out-of-support"):
            want = d_cpu.log_prob(values)
        on_card = values.to(cuda)
        with pytest.warns(UserWarning, match="Out-of-support"):
            got = d_dev.log_prob(on_card)
        lp, sites = cs.count_syncs(lambda: torch.func.vmap(d_dev.log_prob)(on_card))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    assert want[1].item() == -float("inf") and torch.equal(lp.cpu(), got.cpu())
    assert sites == {}, sites


@pytest.mark.requires_cuda
def test_cond_on_the_card_matches_the_cpu(cuda):
    """A tensor predicate on the card selects the taken branch's value and
    sites as on the CPU, with no host sync."""
    from numpyro_tpu_torch.contrib.control_flow import cond

    cs = _phase15()

    def model(u):
        return cond(u > 0, lambda s: npt.sample("x", dist.Normal(s, 1.0 * s)),
                    lambda s: npt.sample("x", dist.Normal(-s, 2.0 * s)), u.new_full((), 1.5))

    out = {}
    for device in (cuda, torch.device("cpu")):
        u = torch.tensor([-0.5, 0.5], device=device)
        x = torch.tensor([0.3, -0.2], device=device)

        def run():
            return torch.func.vmap(lambda ui, xi: handlers.trace(handlers.substitute(
                model, data={"x": xi})).get_trace(ui)["x"]["fn"].log_prob(xi))(u, x)

        run()
        out[device.type], sites = cs.count_syncs(run)
        if device.type == "cuda":
            assert sites == {}, sites
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=1e-6, atol=0)


@pytest.mark.requires_cuda
def test_dsl_model_on_the_card_makes_no_host_sync_more_than_its_twin(cuda):
    """Phase 18b: the potential on the card against the CPU's and its twin's;
    a NUTS evaluation makes no host sync more than the twin's, with
    validation off and on."""
    cs = _phase15()
    walls, syncs = cs.phase_dsl(cuda)
    assert syncs["off"] <= syncs["twin"] and syncs["on"] <= syncs["twin"], syncs


def _init_model(y):
    a = npt.sample("a", dist.Normal(y.new_full((), 0.5), y.new_full((), 2.0)))
    b = npt.sample("b", dist.LogNormal(y.new_full((), 0.2), y.new_full((), 0.5)))
    npt.sample("d", dist.Dirichlet(y.new_tensor([1.0, 2.0, 3.0])))
    npt.sample("obs", dist.Normal(a, b), obs=y)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["mean", "feasible", "value", "median", "sample", "uniform"])
def test_batched_init_strategies_on_the_card(cuda, name):
    """``initialize_model`` at 8 chains on the card under every strategy:
    finite potentials; the strategies that draw nothing give the CPU's
    params and potentials; under those that draw, chain ``i`` is the
    single-chain search on chain ``i``'s generator."""
    from numpyro_tpu_torch.infer import initialization, util as infer_util

    strategy = {
        "mean": initialization.init_to_mean, "feasible": initialization.init_to_feasible,
        "value": initialization.init_to_value(values={
            "a": torch.tensor(0.3), "b": torch.tensor(1.5), "d": torch.tensor([0.2, 0.3, 0.5])}),
        "median": initialization.init_to_median, "sample": initialization.init_to_sample,
        "uniform": initialization.init_to_uniform,
    }[name]
    y = torch.tensor([0.3, -0.2, 1.1])
    out = {}
    for device in (cuda, torch.device("cpu")):
        if name == "value" and device.type == "cuda":
            values = {k: v.to(cuda) for k, v in strategy.keywords["values"].items()}
            strategy_here = initialization.init_to_value(values=values)
        else:
            strategy_here = strategy
        out[device.type] = infer_util.initialize_model(
            torch.Generator(device=device).manual_seed(0), _init_model, num_chains=8,
            init_strategy=strategy_here, model_args=(y.to(device),)).param_info
    z, pe, _ = out["cuda"]
    assert bool(torch.isfinite(pe).all()) and all(v.device.type == "cuda" for v in z.values())
    if name in ("mean", "feasible", "value"):
        for k in z:
            torch.testing.assert_close(z[k].cpu(), out["cpu"].z[k], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(pe.cpu(), out["cpu"].potential_energy, rtol=1e-5, atol=0)
    elif name in ("median", "sample"):
        (z, _, _), _ = infer_util.find_valid_initial_params(
            torch.Generator(device=cuda).manual_seed(1), _init_model, num_chains=8,
            init_strategy=strategy, model_args=(y.to(cuda),))
        gens = infer_util.chain_generators(torch.Generator(device=cuda).manual_seed(1), cuda, 8)
        (z3, _, _), _ = infer_util.find_valid_initial_params(
            gens[3], _init_model, init_strategy=strategy, model_args=(y.to(cuda),))
        for k in z:
            assert torch.equal(z[k][3], z3[k]), k


@pytest.mark.requires_cuda
def test_provenance_through_the_glm_op_launches_the_kernel(cuda):
    """A provenance pass reaches ``glm_split`` with a plain tensor: the
    kernel launches once, the plain version not at all, and the result
    carries ``w``'s name; the covtype-shape model's dependencies on the card
    are the CPU's."""
    from numpyro_tpu_torch.infer.inspect import get_dependencies
    from numpyro_tpu_torch.ops.provenance import eval_provenance

    X, y, W, _ = _problem(cuda, n=40000, d=9, c=1)
    data = glm.prepare_glm_data(X, y, dtype="split")
    before = dict(glm.launch_counts)
    out = eval_provenance(lambda w: glm.bernoulli_logits_loglik(w, data), w=W[0])
    assert out == frozenset({"w"})
    assert glm.launch_counts["glm_split"] == before["glm_split"] + 1
    assert glm.launch_counts["plain"] == before["plain"]

    def model(data):
        w = npt.sample("w", dist.Normal(torch.zeros(9, device=data.device), 1.0).to_event(1))
        npt.factor("lik", glm.bernoulli_logits_loglik(w, data))

    cpu_data = glm.prepare_glm_data(X.cpu(), y.cpu(), dtype="split")
    assert get_dependencies(model, (data,)) == get_dependencies(model, (cpu_data,), device="cpu")


@pytest.mark.requires_cuda
def test_transfer_states_to_host_and_cross_chain_diagnostics(cuda):
    """The draws moved to the host equal the card's bit for bit; the
    cross-chain diagnostics on the card are the CPU's on autocorrelated
    draws (an AR(1) series from numpy; a chain that never moves would give
    0/0 autocorrelations, NaN on the card, where the CPU's mean of a
    constant rounds off it)."""
    from numpyro_tpu_torch.diagnostics import effective_sample_size, split_gelman_rubin
    from numpyro_tpu_torch.parallel import cross_chain_diagnostics

    def model():
        a = npt.sample("a", dist.Normal(0.0, 1.0))
        npt.sample("b", dist.Normal(a, 0.5).expand([2]).to_event(1))

    mcmc = MCMC(NUTS(model, max_tree_depth=3), num_warmup=20, num_samples=30, num_chains=8)
    mcmc.run(0)
    on_card = mcmc.get_samples(group_by_chain=True)
    mcmc.transfer_states_to_host()
    on_host = mcmc.get_samples(group_by_chain=True)
    for k, v in on_card.items():
        assert v.device.type == "cuda" and on_host[k].device.type == "cpu"
        assert torch.equal(v.cpu(), on_host[k])
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(8, 50, 3)).astype(np.float32)
    series = np.zeros_like(noise)
    for t in range(1, 50):
        series[:, t] = 0.8 * series[:, t - 1] + noise[:, t]
    draws = {"a": torch.from_numpy(series[..., 0]), "b": torch.from_numpy(series[..., 1:])}
    got = cross_chain_diagnostics({k: v.to(cuda) for k, v in draws.items()})
    for k, v in draws.items():
        torch.testing.assert_close(got[k][0].cpu(), split_gelman_rubin(v), rtol=1e-5, atol=0)
        torch.testing.assert_close(got[k][1].cpu(), effective_sample_size(v), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# contrib: HSGP, the nested sampler and DCC/SDVI (phase 20)


@pytest.mark.requires_cuda
def test_hsgp_potentials_on_the_card_match_the_cpu_without_host_syncs(cuda):
    """``examples/hsgp_example.py``'s model and the Matérn and periodic
    fragments: the potential and gradient at 64 points on the card against
    the CPU's (``chip_smoke.potential_check``), with no host sync in an
    evaluation (every constant of ``contrib.hsgp`` is made on the device);
    the periodic density at length 0.05 finite and the CPU's."""
    from numpyro_tpu_torch.contrib.hsgp.spectral_densities import diag_spectral_density_periodic

    cs = _phase15()
    x, y = (torch.from_numpy(a).to(cuda) for a in cs.hsgp_data())
    for k, model in enumerate([cs.hsgp_model, *cs.FRAGMENTS.values()]):
        pe_err, g_err, sites, _ = cs.potential_check("hsgp", model, (x, y), 64, cs.HSGP_RTOL,
                                                     300 + k, scale=0.5)
        assert pe_err <= cs.HSGP_RTOL and g_err <= 1.0 and not sites
    short = torch.tensor(0.05, device=cuda)
    on_card = diag_spectral_density_periodic(1.0, short, 8)
    assert torch.isfinite(on_card).all()
    torch.testing.assert_close(on_card.cpu(), diag_spectral_density_periodic(1.0, short.cpu(), 8),
                               rtol=1e-5, atol=0)


@pytest.mark.requires_cuda
def test_nested_sampler_on_the_card(cuda):
    """The conjugate model's log Z against the analytic one, and the
    shells' uniform prior, whose bijection carries 0-dim scales made on the
    host, through a short run with its draws on the card."""
    from numpyro_tpu_torch.contrib.nested_sampling import NestedSampler

    cs = _phase15()
    ns = NestedSampler(cs.conjugate_model, constructor_kwargs=cs.NS_CONJ_RUN)
    ns.run(0, torch.tensor(cs.NS_Y, device=cuda))
    res = ns.diagnostics()
    assert res.samples.device.type == "cuda"
    assert abs(float(res.log_Z) - cs.conjugate_log_evidence()) <= 3 * float(res.log_Z_err) + 0.05
    centers = [torch.tensor(c, device=cuda) for c in cs.SHELLS_CENTERS]
    ns = NestedSampler(cs.shells_model, constructor_kwargs=dict(cs.SHELLS_RUN, max_samples=240))
    ns.run(1, *centers, cs.SHELLS_RADIUS, cs.SHELLS_WIDTH)
    draws = ns.get_samples(2, 100)["x"]
    assert draws.device.type == "cuda" and draws.shape == (100, 2)
    assert bool(((draws >= -6) & (draws <= 6)).all())


@pytest.mark.requires_cuda
def test_dcc_and_sdvi_on_the_card(cuda):
    """Short DCC and SDVI runs on the card (their default device): the
    weights sum to 1 and each branch's is within 0.1 of the exact one; a
    branch's model keeps its branch value a Python int."""
    import functools

    from numpyro_tpu_torch.contrib.stochastic_support import DCC, SDVI

    cs = _phase15()
    chains, warmup, samples, depths = cs.DCC_RUN
    dcc = DCC(cs.branch_model, mcmc_kwargs=dict(num_warmup=warmup, num_samples=samples,
                                                num_chains=chains),
              kernel_cls=functools.partial(NUTS, max_tree_depth=depths),
              num_slp_samples=cs.DCC_SLP_SAMPLES)
    lr, steps, particles = cs.SDVI_RUN
    sdvi = SDVI(cs.branch_model, Adam(lr), svi_num_steps=steps,
                num_slp_samples=cs.DCC_SLP_SAMPLES, combine_elbo_particles=particles)
    exact = cs.branch_weights()
    for res in (dcc.run(0), sdvi.run(1)):
        weights = {k: float(v) for k, v in res.slp_weights.items()}
        assert abs(sum(weights.values()) - 1) < 1e-4
        assert max(abs(v - exact[k]) for k, v in weights.items()) < cs.SS_GATE
    slp = handlers.condition(cs.branch_model, data={"m": 1})
    tr = handlers.trace(handlers.seed(slp, torch.Generator(device=cuda).manual_seed(0))).get_trace()
    assert isinstance(tr["m"]["value"], int) and tr["a2"]["value"].device.type == "cuda"


@pytest.mark.requires_cuda
def test_svgd_and_steinvi_steps_on_the_card_match_the_cpu(cuda):
    """One SVGD step (its objective draws nothing) and one SteinVI step
    (the same draws through a draw source) from the same particles: the
    loss and the particles' gradients within rtol 1e-4 of the CPU's."""
    from numpyro_tpu_torch.contrib.einstein import SVGD, RBFKernel, SteinVI
    from numpyro_tpu_torch.optim import Adagrad

    cs = _phase15()
    rng = np.random.default_rng(0)
    cpu = torch.device("cpu")
    svgd_particles = {"auto_a_loc": torch.tensor(rng.normal(size=(10, 2)), dtype=torch.float32),
                      "auto_b_loc": torch.tensor(rng.normal(size=(10,)), dtype=torch.float32)}
    tables = [rng.standard_normal((6, 2) + s).astype(np.float32) for s in ((2,), ())]
    out = {}
    for dev in (cuda, cpu):
        svgd = SVGD(cs.stein_two, Adagrad(0.5), RBFKernel(), num_stein_particles=10,
                    device=dev)
        svgd.init(0, *cs.stein_args(dev))
        u = {k: v.to(dev) for k, v in svgd_particles.items()}
        loss, grads = svgd._loss_and_grads(torch.Generator(device=dev), u,
                                           *cs.stein_args(dev))
        out[("svgd", dev.type)] = {"loss": loss, **grads}
        stein = SteinVI(cs.stein_two, autoguide.AutoNormal(cs.stein_two), Adagrad(0.5),
                        RBFKernel(), num_stein_particles=6, num_elbo_particles=2, device=dev)
        state = stein.init(1, *cs.stein_args(dev))
        if dev == cuda:
            start = {k: v.cpu() for k, v in stein.optim.get_params(state.optim_state).items()}
        u = {k: v.to(dev) for k, v in start.items()}
        source = cs.TableDraws([torch.from_numpy(t).to(dev) for t in tables],
                               generator=torch.Generator(device=dev))
        loss, grads = stein._loss_and_grads(source, u, *cs.stein_args(dev))
        out[("steinvi", dev.type)] = {"loss": loss, **grads}
    for kind in ("svgd", "steinvi"):
        got, want = out[(kind, "cuda")], out[(kind, "cpu")]
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cuda"
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                       atol=1e-4 * want[k].abs().max().item())


def test_stein_methods_raise_without_a_card_at_their_default_device(monkeypatch):
    """Runs everywhere: with no CUDA device, the default device raises."""
    from numpyro_tpu_torch.contrib.einstein import SVGD, RBFKernel
    from numpyro_tpu_torch.optim import Adagrad

    cs = _phase15()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svgd = SVGD(cs.stein_gauss, Adagrad(0.5), RBFKernel(), num_stein_particles=4)
    assert svgd.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svgd.run(0, 2, *cs.stein_args("cpu"))


def _resume_model(y):
    mu = npt.sample("mu", dist.Normal(torch.zeros((), device=y.device), 5.0))
    npt.sample("y", dist.Normal(mu, 1.0), obs=y)


@pytest.mark.requires_cuda
def test_checkpoint_from_the_card_restores_onto_the_card_and_the_cpu(cuda, tmp_path):
    """A warmed-up state of four chains saved from the card: restored onto
    the card it equals the saved one leaf for leaf (its CUDA generator's
    state too) and resumes bit for bit; restored onto a CPU target its
    tensors are the card's on the host and its generator, which cannot carry
    a CUDA state, is seeded from it with a warning; a CUDA target on a
    machine without CUDA raises."""
    import warnings

    from numpyro_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from numpyro_tpu_torch.util import tree_leaves, tree_map

    y = torch.tensor(2.0, device=cuda)
    m = MCMC(NUTS(_resume_model), num_warmup=20, num_samples=5, num_chains=4, device=cuda)
    m.warmup(0, y)
    warm = m.post_warmup_state
    path = save_checkpoint(tmp_path / "card.pt", warm)
    saved_rng = warm.rng_key.get_state()
    on_card = restore_checkpoint(path, warm)
    assert on_card.rng_key.device.type == "cuda"
    assert torch.equal(on_card.rng_key.get_state(), saved_rng)
    for a, b in zip(tree_leaves(warm), tree_leaves(on_card)):
        assert b.device == a.device and torch.equal(a, b)
    m.run(1, y)
    from_memory = m.get_samples()["mu"]
    m.post_warmup_state = on_card
    m.run(1, y)
    assert torch.equal(m.get_samples()["mu"], from_memory)

    cpu_target = tree_map(lambda x: x.cpu(), warm)._replace(rng_key=torch.Generator())
    with pytest.warns(UserWarning, match="does not carry across device types"):
        on_cpu = restore_checkpoint(path, cpu_target)
    for a, b in zip(tree_leaves(on_card), tree_leaves(on_cpu)):
        assert b.device.type == "cpu" and torch.equal(a.cpu(), b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        again = restore_checkpoint(path, cpu_target)
    assert torch.equal(again.rng_key.get_state(), on_cpu.rng_key.get_state())

    real = torch.cuda.is_available
    try:
        torch.cuda.is_available = lambda: False
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_checkpoint(path, warm)
    finally:
        torch.cuda.is_available = real


@pytest.mark.requires_cuda
def test_torch_module_on_the_card_gives_the_cpu_s_loss(cuda):
    """``examples/vae.py`` through ``torch_module``: the ELBO at the same
    weights and draws on the card and on the CPU (rtol 1e-4), then three
    SVI steps on the card with finite losses and the networks' parameters
    on the card."""
    cs = _phase15()
    from numpyro_tpu_torch.optim import Adam as TAdam

    _, batch_of = cs.vae_batches()
    batch = batch_of(0)
    eps = np.random.default_rng(0).standard_normal((cs.VAE_BATCH, cs.VAE_Z)).astype(np.float32)
    losses = {}
    for dev in (cuda, torch.device("cpu")):
        encoder, decoder = cs.vae_networks(dev)
        params = {"encoder$params": {k: v.detach() for k, v in encoder.named_parameters()},
                  "decoder$params": {k: v.detach() for k, v in decoder.named_parameters()}}
        draws = cs.TableDraws([torch.from_numpy(eps).to(dev)])
        losses[dev.type] = Trace_ELBO().loss(draws, params, cs.vae_model, cs.vae_guide,
                                             torch.from_numpy(batch).to(dev), encoder, decoder)
    assert losses["cuda"].device.type == "cuda"
    torch.testing.assert_close(losses["cuda"].cpu(), losses["cpu"], rtol=1e-4, atol=0)
    encoder, decoder = cs.vae_networks(cuda)
    svi = SVI(cs.vae_model, cs.vae_guide, TAdam(1e-3), Trace_ELBO())
    res = svi.run(0, 3, torch.from_numpy(batch).to(cuda), encoder, decoder)
    assert torch.isfinite(res.losses).all() and res.losses.device.type == "cuda"
    assert all(v.device.type == "cuda" for v in res.params["decoder$params"].values())


@pytest.mark.requires_cuda
def test_compat_svi_runs_on_the_card_by_default(cuda):
    """``examples/minipyro.py`` through ``compat`` with no device given runs
    on the card, and its trajectory of ``loc_q`` equals the CPU's (rtol
    1e-5)."""
    cs = _phase15()
    from numpyro_tpu_torch.compat import infer as cinfer
    from numpyro_tpu_torch.compat import optim as coptim

    data = torch.tensor(cs.minipyro_data(), dtype=torch.float32, device=cuda)
    svi = cinfer.SVI(cs.minipyro_model, cs.minipyro_guide, coptim.Adam({"lr": 0.05}),
                     cinfer.Trace_ELBO())
    locs = []
    for i in range(20):
        loss = svi.step(data, rng_key=0 if i == 0 else None)
        locs.append(svi.get_params()["loc_q"])
    assert svi.device.type == "cuda" and loss.device.type == "cuda"
    _, want, _ = cs.minipyro_trajectory(torch.device("cpu"), steps=20)
    torch.testing.assert_close(torch.stack(locs).cpu(), want, rtol=1e-5, atol=0)


@pytest.mark.requires_cuda
def test_one_rank_mesh_gives_glm_split_the_same_bits(cuda):
    """``shard_data`` over a one-rank ``chain_data_mesh`` on ``cuda:0`` keeps
    every row and no data group, so the GLM op launches ``glm_split`` once
    and gives the bits of the call without a mesh."""
    from numpyro_tpu_torch.parallel import chain_data_mesh, shard_data
    from numpyro_tpu_torch.parallel import mesh as mesh_lib

    X, y, W, _ = _problem(cuda, n=40000, d=9, c=33)
    mesh = chain_data_mesh(device="cuda:0")
    assert mesh.shape == {"chains": 1, "data": 1} and mesh.device == torch.device("cuda", 0)
    rows = glm.prepare_glm_data(shard_data(X, mesh), shard_data(y, mesh), dtype="split")
    whole = glm.prepare_glm_data(X, y, dtype="split")
    assert rows.group is None and rows.n == whole.n
    assert torch.equal(rows.x_t.view(torch.int16), whole.x_t.view(torch.int16))

    def value_and_grad(data):
        return torch.func.vmap(torch.func.grad_and_value(glm.bernoulli_logits_loglik),
                               in_dims=(0, None))(W, data)

    mesh_lib.reset_collective_counts()
    before = glm.launch_counts["glm_split"]
    got = value_and_grad(rows)
    assert glm.launch_counts["glm_split"] == before + 1
    assert mesh_lib.collective_counts["all_reduce"] == 0
    assert _same_bits(got, value_and_grad(whole))


@pytest.mark.requires_cuda
def test_subsample_of_a_one_rank_data_shard_on_gpu_is_the_plain_take(cuda):
    """A one-rank mesh's data shard holds every row: ``subsample`` under a
    subsampled plate gives the rows at the indices, bit for bit, and makes
    no collective."""
    from numpyro_tpu_torch.parallel import chain_data_mesh, shard_data
    from numpyro_tpu_torch.parallel import mesh as mesh_lib

    X, y, _, _ = _problem(cuda, n=5000, d=9, c=1)
    mesh = chain_data_mesh(device="cuda:0")
    Xs, ys = shard_data(X, mesh), shard_data(y, mesh)
    idx = torch.randperm(5000, generator=torch.Generator().manual_seed(0))[:300].to(cuda)

    def take(X, y):
        with npt.plate("N", 5000, subsample_size=300):
            return npt.subsample(X, event_dim=1), npt.subsample(y, event_dim=0)

    mesh_lib.reset_collective_counts()
    xb, yb = handlers.substitute(take, data={"N": idx})(Xs, ys)
    assert torch.equal(xb, X[idx]) and torch.equal(yb, y[idx])
    assert mesh_lib.collective_counts["all_reduce"] == 0


SCAN_P = ((0.8, 0.2), (0.3, 0.7))
SCAN_LOCS = (-2.0, 0.0)


def _scan_density(model, *args):
    return float(log_density(enum(config_enumerate(model), first_available_dim=-1), args, {},
                             {})[0])


def _counter_hmm(device):
    P, locs = torch.tensor(SCAN_P, device=device), torch.tensor(SCAN_LOCS, device=device)

    def model(ys):
        def transition(carry, y):
            x_prev, t = carry
            x = npt.sample("x", dist.Categorical(P[x_prev]))
            npt.sample("y", dist.Normal(locs[x] + 0.3 * t, 1.0), obs=y)
            return (x, t + 1.0), None

        scan(transition, (0, torch.zeros((), device=device)), ys)

    return model


def _latent_hmm(device, out):
    P, locs = torch.tensor(SCAN_P, device=device), torch.tensor(SCAN_LOCS, device=device)

    def model(ys):
        def transition(x_prev, y):
            x = npt.sample("x", dist.Categorical(P[x_prev]))
            z = npt.sample("z", dist.Normal(torch.zeros((), device=device), 1.0))
            npt.sample("y", dist.Normal(locs[x] + z, 1.0), obs=y)
            return x, z

        _, zs = scan(transition, 0, ys)
        out.append(zs)

    return model


@pytest.mark.requires_cuda
def test_enumerated_scan_cases_on_gpu_match_the_cpu(cuda):
    """A carry that moves beside the enumerated state (its steps one at a
    time) and a substituted series shorter than the scan (its last steps
    drawn on the card's generator): the card's densities equal the CPU's
    on the same values, to ``rtol=1e-5``."""
    ys = torch.from_numpy(np.random.default_rng(9).standard_normal(7).astype(np.float32))
    got = _scan_density(_counter_hmm(cuda), ys.to(cuda))
    want = _scan_density(_counter_hmm(torch.device("cpu")), ys)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    z_short = torch.from_numpy(np.random.default_rng(10).standard_normal(3).astype(np.float32))
    out = []
    seeded = handlers.seed(_latent_hmm(cuda, out), torch.Generator(device=cuda).manual_seed(3))
    got = _scan_density(handlers.substitute(seeded, data={"z": z_short.to(cuda)}), ys.to(cuda))
    zs = out[-1]
    assert zs.device.type == "cuda" and torch.equal(zs[:3].cpu(), z_short)
    whole = handlers.substitute(_latent_hmm(torch.device("cpu"), []), data={"z": zs.cpu()})
    np.testing.assert_allclose(got, _scan_density(whole, ys), rtol=1e-5)


def _row_latent_model(size, check):
    """Phase 23g's model (``chip_smoke.model_row_latent``): a latent ``e``
    for each row, with a logsumexp and the columns' maxima over the rows
    where ``check``."""

    def model(X, y):
        one = torch.ones((), device=X.device)
        w = npt.sample("w", dist.Normal(torch.zeros(X.shape[-1], device=X.device), one)
                       .to_event(1))
        tau = npt.sample("tau", dist.HalfNormal(one))
        with npt.plate("N", size):
            e = npt.sample("e", dist.Normal(torch.zeros((), device=X.device), one))
            npt.sample("y", dist.Bernoulli(logits=X @ w + tau * e), obs=y)
        if check:
            npt.factor("rows_lse", -1e-3 * torch.logsumexp((X / X.abs().amax(0)) @ w, 0))

    return model


@pytest.mark.requires_cuda
def test_a_latent_a_row_over_two_thread_ranks_on_gpu(cuda, monkeypatch):
    """Phase 23g's rules on the card without a second process: the 3,001
    rows held by two thread ranks of a data group (1,500 and 1,501 rows;
    ``torch_thread_ranks.py``).  The potential at 4 points of the model
    with a latent a row (cut to each rank's rows), a logsumexp and column
    maxima over the rows (``MAX`` and sum ``all_reduce``s) equals the
    one-process model's on all rows on the card (rtol 1e-5); ``Predictive``
    of 4 draws of ``y`` (a gather of the logits under ``vmap``) returns each
    rank's rows of the one-process draws from the same generator, bit for
    bit.  The gradients cross the ranks in phase 23g (a CUDA backward pass
    runs on autograd's own thread, where thread ranks cannot meet)."""
    from numpyro_tpu_torch.infer import util as infer_util
    from numpyro_tpu_torch.parallel.data_shard import DataShard, DataShardTensor, local_rows
    from torch_thread_ranks import patch_all_reduce

    n, d, c = 3001, 8, 4
    X, y, W, _ = _problem(cuda, n=n, d=d, c=c, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    z = {"w": W, "tau": torch.linspace(-2.0, 0.0, c, device=cuda),
         "e": torch.randn((c, n), generator=gen, device=cuda)}
    group = patch_all_reduce(monkeypatch)
    halves = ((0, 1500), (1500, n))

    def evaluate(data):
        model = _row_latent_model(n, True)
        value = infer_util.batched_value(
            lambda z: infer_util.potential_energy(model, data, {}, z))(z)
        samples = {"w": W, "tau": torch.linspace(0.2, 1.0, c, device=cuda), "e": z["e"]}
        draws = Predictive(_row_latent_model(n, False), samples, return_sites=["y"],
                           device=cuda)(torch.Generator(device=cuda).manual_seed(5),
                                        data[0], None)["y"]
        return value, draws

    def rank(r):
        start, stop = halves[r]
        shard = DataShard(start, stop, 0, group, n)
        return evaluate((DataShardTensor(X[start:stop], shard, -2),
                         DataShardTensor(y[start:stop], shard, -1)))

    want = evaluate((X, y))
    for r, (value, draws) in enumerate(group.run(rank)):
        assert value.device == want[0].device
        torch.testing.assert_close(value, want[0], rtol=1e-5, atol=0.0)
        start, stop = halves[r]
        assert isinstance(draws, DataShardTensor) and draws._axis == -1
        assert torch.equal(local_rows(draws), want[1][:, start:stop])
