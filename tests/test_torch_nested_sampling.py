"""The port's ``contrib.nested_sampling`` against the JAX package's.

- **Three iterations on JAX's draws.** The JAX sampler's draws are rebuilt
  from its keys (the prior draws of the live set, then per iteration the
  clone indices and per slice pass the directions, the level and the ten
  shrink uniforms) and handed to the port through its draw source; both
  run three iterations (``max_samples = 3 * num_delete``).  The dead buffer
  and the live set (the results' ``samples``), their log-likelihoods and
  log weights, and log Z match within float32 rounding (rtol 1e-4, atol
  1e-5; log Z atol 1e-4); ``num_likelihood_evals`` and the iterations
  match exactly.  ``get_samples`` on JAX's categorical draws gives JAX's
  samples.
- **A whole small run** of the conjugate model of
  ``tests/contrib/test_nested_sampling.py``: log Z within ``3 log_Z_err +
  0.05`` of the analytic one and within ``3`` combined errors of the JAX
  package's run, the posterior moments within that file's 0.08 and 0.06.
- The discrete-site ``ValueError``, the ``RuntimeError`` before ``run``, and
  the card by default (a raise where there is none).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.contrib.nested_sampling import NestedSampler as JNestedSampler

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.contrib.nested_sampling import NestedSampler, NestedSamplerResults

from test_torch_kernels import QueueDraws

torch.set_num_threads(1)

SP, SO = 2.0, 0.5
Y = np.array([0.7, 1.1, 0.9, 1.3, 0.8, 1.0, 1.2, 0.95, 1.05, 0.85], np.float32)
RTOL, ATOL, LOGZ_ATOL = 1e-4, 1e-5, 1e-4


def jax_conjugate(y):
    mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, SP))
    with numpyro_tpu.plate("N", len(y)):
        numpyro_tpu.sample("y", jdist.Normal(mu, SO), obs=y)


def torch_conjugate(y):
    mu = npt.sample("mu", dist.Normal(0.0, SP))
    with npt.plate("N", len(y)):
        npt.sample("y", dist.Normal(mu, SO), obs=y)


def jax_scale_model(y):
    """Two latent sites, one on a half-line (an exp transform and its
    log-Jacobian in the prior term)."""
    mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, SP))
    sigma = numpyro_tpu.sample("sigma", jdist.HalfNormal(1.0))
    with numpyro_tpu.plate("N", len(y)):
        numpyro_tpu.sample("y", jdist.Normal(mu, sigma), obs=y)


def torch_scale_model(y):
    mu = npt.sample("mu", dist.Normal(0.0, SP))
    sigma = npt.sample("sigma", dist.HalfNormal(1.0))
    with npt.plate("N", len(y)):
        npt.sample("y", dist.Normal(mu, sigma), obs=y)


MODELS = {"conjugate": (jax_conjugate, torch_conjugate, ["mu"]),
          "scale": (jax_scale_model, torch_scale_model, ["mu", "sigma"])}


def analytic():
    n = len(Y)
    cov = SO**2 * np.eye(n) + SP**2 * np.ones((n, n))
    _, logdet = np.linalg.slogdet(2 * np.pi * cov)
    logz = -0.5 * (logdet + Y @ np.linalg.solve(cov, Y))
    post_var = 1.0 / (1.0 / SP**2 + n / SO**2)
    return logz, post_var * Y.sum() / SO**2, np.sqrt(post_var)


class FedDraws(QueueDraws):
    """``QueueDraws`` with the live set's prior draws."""

    def prior(self, draw_fn, num):
        kind, values = self.items.pop(0)
        assert kind == "prior", kind
        assert all(v.shape[0] == num for v in values.values())
        return values


def jax_draws(model, key, args, sites, num_live, num_delete, num_slices, iters):
    """JAX's draws of ``iters`` iterations in the port's order."""
    key_init, key = random.split(key)

    def one(k):
        tr = jhandlers.trace(jhandlers.seed(model, k)).get_trace(*args)
        return {name: tr[name]["value"] for name in sites}

    prior = jax.vmap(one)(random.split(key_init, num_live))
    draws = FedDraws().push("prior", {k: torch.from_numpy(np.array(v)) for k, v in prior.items()})
    dim = sum(int(np.prod(np.shape(v)[1:])) for v in prior.values())
    for _ in range(iters):
        key, kpick, kslice = random.split(key, 3)
        draws.push("randints", random.randint(kpick, (num_delete,), 0, num_live - num_delete))
        for _ in range(num_slices):
            kslice, kp = random.split(kslice)
            kdir, klevel, keys = random.split(kp, 3)
            draws.push("normals", random.normal(kdir, (num_delete, dim)))
            draws.push("uniforms", random.uniform(klevel, (num_delete,)))
            for _ in range(10):
                keys, kt = random.split(keys)
                draws.push("uniforms", random.uniform(kt, (num_delete,)))
    return draws


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("name, num_live, num_delete, num_slices, seed", [
    ("conjugate", 40, 4, None, 0),
    ("scale", 30, 5, 3, 1),
])
def test_three_iterations_on_jax_draws_match_jax(name, num_live, num_delete, num_slices, seed):
    jmodel, tmodel, sites = MODELS[name]
    ck = {"num_live_points": num_live, "num_delete": num_delete,
          "max_samples": 3 * num_delete}
    if num_slices is not None:
        ck["num_slices"] = num_slices
    key = random.PRNGKey(seed)
    jns = JNestedSampler(jmodel, constructor_kwargs=ck)
    jns.run(key, jnp.asarray(Y))
    jres = jns.diagnostics()
    slices = num_slices if num_slices is not None else 5 * len(sites)
    draws = jax_draws(jmodel, key, (jnp.asarray(Y),), sites, num_live, num_delete, slices, 3)
    ns = NestedSampler(tmodel, constructor_kwargs=ck, device="cpu")
    ns.run(draws, torch.from_numpy(Y))
    assert draws.done()
    res = ns.diagnostics()
    assert isinstance(res, NestedSamplerResults)
    assert res.num_iterations == int(jres.num_iterations) == 3
    assert res.num_likelihood_evals == int(jres.num_likelihood_evals) \
        == 3 * slices * 18 * num_delete
    # 3 iterations, 14 batched evaluations a slice pass, the live set's one
    assert ns.last_run_stats["evaluations"] == 3 * slices * 14 + 1
    assert res.samples.shape == tuple(jres.samples.shape)
    _close(res.samples, jres.samples, msg="dead buffer and live set")
    _close(res.log_likelihoods, jres.log_likelihoods, msg="log-likelihoods")
    _close(res.log_weights, jres.log_weights, atol=LOGZ_ATOL, msg="log weights")
    _close(res.log_Z, jres.log_Z, atol=LOGZ_ATOL, msg="log Z")
    for field in ("log_Z_err", "ess", "h"):
        _close(getattr(res, field), getattr(jres, field), rtol=1e-3, msg=field)

    # equal-weight draws on JAX's categorical draws
    kdraw = random.PRNGKey(7)
    jsamples = jns.get_samples(kdraw, 50)
    idx = random.categorical(kdraw, jres.log_weights, shape=(50,))
    got = ns.get_samples(QueueDraws().push("categorical", idx), 50)
    for site in sites:
        _close(got[site], jsamples[site], msg=site)
    weighted, logw = ns.get_weighted_samples()
    jweighted, _ = jns.get_weighted_samples()
    for site in sites:
        _close(weighted[site], jweighted[site], msg=site)


@pytest.fixture(scope="module")
def whole_runs():
    ck = {"num_live_points": 100, "max_samples": 8000}
    jns = JNestedSampler(jax_conjugate, constructor_kwargs=ck)
    jns.run(random.PRNGKey(0), jnp.asarray(Y))
    ns = NestedSampler(torch_conjugate, constructor_kwargs=ck, device="cpu")
    ns.run(0, torch.from_numpy(Y))
    return jns, ns


def test_whole_run_matches_the_analytic_evidence_and_jax(whole_runs, capsys):
    jns, ns = whole_runs
    logz_true, post_mean, post_std = analytic()
    res, jres = ns.diagnostics(), jns.diagnostics()
    logz, err = float(res.log_Z), float(res.log_Z_err)
    assert abs(logz - logz_true) <= 3 * err + 0.05
    assert abs(logz - float(jres.log_Z)) <= 3 * np.hypot(err, float(jres.log_Z_err))
    assert 0.0 < err < 0.5 and float(res.ess) > 100
    s = ns.get_samples(1, 2000)
    assert abs(float(s["mu"].mean()) - post_mean) < 0.08
    assert abs(float(s["mu"].std()) - post_std) < 0.06
    samples, logw = ns.get_weighted_samples()
    w = torch.exp(logw)
    assert abs(float(w.sum()) - 1.0) < 1e-3
    assert abs(float((w * samples["mu"]).sum()) - post_mean) < 0.08
    ns.print_summary()
    out = capsys.readouterr().out
    assert out.startswith(f"logZ = {logz:.4f} +/- {err:.4f}") and "  mu: mean [" in out


def test_requires_run():
    ns = NestedSampler(torch_conjugate, device="cpu")
    with pytest.raises(RuntimeError):
        ns.get_samples(0, 10)
    with pytest.raises(RuntimeError):
        ns.diagnostics()


def test_rejects_discrete():
    def m():
        z = npt.sample("z", dist.Bernoulli(0.3))
        npt.sample("x", dist.Normal(z.to(torch.float32), 1.0), obs=torch.tensor(0.5))

    ns = NestedSampler(m, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        ns.run(0)


def test_runs_on_the_card_by_default_and_never_falls_back():
    ns = NestedSampler(torch_conjugate)
    assert ns.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ns.run(0, torch.from_numpy(Y))


def test_uniform_prior_log_jacobian_stays_on_the_value_s_device():
    """The shells' prior, ``Uniform(-6., 6.)`` expanded: its bijection holds
    0-dim scales made on the host, and the log-Jacobian lands on the value's
    device (shown on the ``meta`` device, which, as a card does, refuses a
    host tensor that is not 0-dim); on the CPU it is JAX's."""
    from numpyro_tpu.distributions.transforms import biject_to as jbiject_to
    from numpyro_tpu_torch.distributions.transforms import biject_to

    t = biject_to(dist.Uniform(-6.0, 6.0).expand([2]).to_event(1).support)
    z = torch.zeros(2, device="meta")
    assert t.log_abs_det_jacobian(z, t(z)).device.type == "meta"
    jt = jbiject_to(jdist.Uniform(-6.0, 6.0).expand([2]).to_event(1).support)
    u = np.float32([0.3, -1.2])
    _close(t.log_abs_det_jacobian(torch.from_numpy(u), t(torch.from_numpy(u))),
           jt.log_abs_det_jacobian(jnp.asarray(u), jt(jnp.asarray(u))), rtol=1e-6)
