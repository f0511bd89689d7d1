"""The port's ``contrib.stochastic_support`` (DCC and SDVI) against the JAX
package's.

- ``_find_slps`` on JAX's forward simulations (each simulation's branch
  values handed to the port's model): the same signatures in the same
  order, ``max_slps`` stopping both at the same place.
- ``_estimate_log_z`` on the same posterior draws and the same proposal
  noise (JAX's, recovered from its ``AutoNormal``), on an unconstrained and
  a constrained branch: within float32 rounding (rtol 1e-5).
- SDVI's combination of two branches' guides at the same params on JAX's
  particle noise: the weights within float32 rounding (rtol 1e-5, atol
  1e-6).
- Short whole runs of both on the CPU: each branch's weight within 0.1 of
  the exact one (the gate of ``tests/contrib/test_stochastic_support.py``).
- A branch's model conditioned on a Python int, its density with an
  observed Python number against JAX's; the raises (a continuous branching
  site, a loss outside the whitelist) and the card by default.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.optim as joptim
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.contrib.stochastic_support import DCC as JDCC
from numpyro_tpu.contrib.stochastic_support import SDVI as JSDVI
from numpyro_tpu.infer import RenyiELBO as JRenyiELBO
from numpyro_tpu.infer.autoguide import AutoNormal as JAutoNormal
from numpyro_tpu.infer.initialization import init_to_value as jinit_to_value
from numpyro_tpu.infer.util import log_density as jlog_density

import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib.stochastic_support import DCC, SDVI, DCCResult, SDVIResult
from numpyro_tpu_torch.contrib.stochastic_support import sdvi as sdvi_module
from numpyro_tpu_torch.infer import NUTS, RenyiELBO
from numpyro_tpu_torch.infer.autoguide import AutoNormal
from numpyro_tpu_torch.infer.util import log_density
from numpyro_tpu_torch.optim import Adam

from test_torch_kernels import QueueDraws
from test_torch_svi import _fake_randn, _guide_seeds, fed_particles, jax_noise

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-5


def jax_branch_model():
    m = numpyro_tpu.sample("m", jdist.Bernoulli(0.5), infer={"branching": True})
    if m == 0:
        mean = numpyro_tpu.sample("a1", jdist.Normal(0.0, 1.0))
    else:
        mean = numpyro_tpu.sample("a2", jdist.Normal(1.0, 1.0))
    numpyro_tpu.sample("obs", jdist.Normal(mean, 1.0), obs=cs.SS_OBS)


def jax_two_sites():
    """Two branching sites, six signatures; a constrained latent on one
    branch."""
    m = numpyro_tpu.sample("m", jdist.Bernoulli(0.4), infer={"branching": True})
    k = numpyro_tpu.sample("k", jdist.Categorical(jnp.array([0.2, 0.3, 0.5])),
                           infer={"branching": True})
    if m == 0:
        s = numpyro_tpu.sample("s", jdist.HalfNormal(1.0))
        numpyro_tpu.sample("obs", jdist.Normal(0.3 * k, s), obs=0.4)
    else:
        a = numpyro_tpu.sample("a", jdist.Normal(0.0, 1.0))
        numpyro_tpu.sample("obs", jdist.Normal(a + k, 1.0), obs=0.4)


def two_sites():
    m = npt.sample("m", dist.Bernoulli(0.4), infer={"branching": True})
    k = npt.sample("k", dist.Categorical(torch.tensor([0.2, 0.3, 0.5])),
                   infer={"branching": True})
    if m == 0:
        s = npt.sample("s", dist.HalfNormal(1.0))
        npt.sample("obs", dist.Normal(0.3 * k, s), obs=0.4)
    else:
        a = npt.sample("a", dist.Normal(0.0, 1.0))
        npt.sample("obs", dist.Normal(a + k, 1.0), obs=0.4)


def _fed(model, values):
    """``model`` with each run's branching values taken in turn from
    ``values`` (dicts of ints), as JAX's simulations drew them."""
    it = iter(values)

    def fed(*args, **kwargs):
        data = {k: torch.tensor(v) for k, v in next(it).items()}
        return handlers.substitute(model, data=data)(*args, **kwargs)

    return fed


@pytest.mark.parametrize("jmodel, tmodel, sites, n, max_slps", [
    (jax_branch_model, cs.branch_model, ("m",), 12, 124),
    (jax_two_sites, two_sites, ("m", "k"), 40, 124),
    (jax_two_sites, two_sites, ("m", "k"), 40, 3),
])
def test_find_slps_on_jax_draws_matches_jax(jmodel, tmodel, sites, n, max_slps):
    key = random.PRNGKey(3)
    want = JDCC(jmodel, mcmc_kwargs={}, num_slp_samples=n, max_slps=max_slps)._find_slps(key)
    values = []
    for k in random.split(key, n):
        tr = jhandlers.trace(jhandlers.seed(jmodel, k)).get_trace()
        values.append({s: int(tr[s]["value"]) for s in sites})
    dcc = DCC(_fed(tmodel, values), mcmc_kwargs={"device": "cpu"}, num_slp_samples=n,
              max_slps=max_slps)
    got = dcc._find_slps(torch.Generator().manual_seed(0))
    assert list(got) == list(want)
    assert got == {k: {s: int(v) for s, v in d.items()} for k, d in want.items()}
    assert all(isinstance(v, int) for d in got.values() for v in d.values())


def _jax_eps(slp, anchor, key, scale):
    """JAX's standard normals of its proposal at ``key``, per latent site in
    the model's order, recovered from the draw of the proposal centred on
    ``anchor`` (each site's unconstrained value, less the anchor, over the
    scale)."""
    proposal = JAutoNormal(slp, init_loc_fn=jinit_to_value(values=anchor), init_scale=scale)
    tr = jhandlers.trace(jhandlers.seed(proposal, key)).get_trace()
    eps = []
    for name, site in tr.items():
        if site["type"] != "sample":
            continue
        u = site["intermediates"][0][0] if site["intermediates"] else site["value"]
        base = jnp.log(anchor[name]) if name == "s" else anchor[name]
        eps.append(np.asarray((u - base) / scale))
    return eps


@pytest.mark.parametrize("branch, site, scale", [
    ({"m": 0, "k": 2}, "s", 1.0), ({"m": 1, "k": 1}, "a", 0.7),
])
def test_estimate_log_z_on_jax_noise_matches_jax(branch, site, scale):
    rng = np.random.default_rng(4)
    draws = rng.normal(0.5, 0.4, (20,)).astype(np.float32)
    if site == "s":
        draws = np.abs(draws) + np.float32(0.1)
    key = random.PRNGKey(5)
    jslp = jhandlers.condition(jax_two_sites, data=branch)
    jdcc = JDCC(jax_two_sites, mcmc_kwargs={}, proposal_scale=scale)
    want = jdcc._estimate_log_z(key, jslp, {site: jnp.asarray(draws)}, (), {})
    eps = _jax_eps(jslp, {site: jnp.asarray(draws[0])}, key, scale)
    source = QueueDraws()
    for e in eps:
        source.push("normals", e)
    dcc = DCC(two_sites, mcmc_kwargs={"device": "cpu"}, proposal_scale=scale)
    got = dcc._estimate_log_z(source, handlers.condition(two_sites, data=branch),
                              {site: torch.from_numpy(draws)}, (), {})
    assert source.done()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def _guides(model, tmodel, branches, loc, scale):
    """Each branch's JAX and port ``AutoNormal``, set up, with the same
    params."""
    jguides, tguides = {}, {}
    for tag, branch in branches.items():
        name = "a1" if branch["m"] == 0 else "a2"
        params = {f"auto_{name}_loc": np.float32(loc[tag]),
                  f"auto_{name}_scale": np.float32(scale[tag])}
        jg = JAutoNormal(jhandlers.condition(model, data=branch))
        jhandlers.seed(jg, 0)()
        tg = AutoNormal(handlers.condition(tmodel, data=branch))
        handlers.seed(tg, torch.Generator().manual_seed(0))()
        jguides[tag] = (jg, {k: jnp.asarray(v) for k, v in params.items()})
        tguides[tag] = (tg, {k: torch.tensor(v) for k, v in params.items()})
    return jguides, tguides


def test_sdvi_combination_on_jax_noise_matches_jax(monkeypatch):
    branches = {"0": {"m": 0}, "1": {"m": 1}}
    particles = 8
    jguides, tguides = _guides(jax_branch_model, cs.branch_model, branches,
                               {"0": 0.1, "1": 0.55}, {"0": 0.7, "1": 0.65})
    key = random.PRNGKey(6)
    jsdvi = JSDVI(jax_branch_model, joptim.Adam(0.1), combine_elbo_particles=particles)
    want = jsdvi._combine_inferences(key, jguides, branches)
    seeds = _guide_seeds(key, particles, True)
    jg, jp = jguides["0"]
    tables = [torch.from_numpy(t) for t in jax_noise(jg, "AutoNormal", jp, seeds, ())]
    # the second branch's guide draws the same normals from the same key (as
    # recovered through its own loc and scale, to float32 rounding)
    jg1, jp1 = jguides["1"]
    other = jax_noise(jg1, "AutoNormal", jp1, seeds, ())
    np.testing.assert_allclose(other[0], tables[0].numpy(), rtol=0, atol=1e-6)
    sdvi = SDVI(cs.branch_model, Adam(0.1), combine_elbo_particles=particles, device="cpu")
    monkeypatch.setattr(sdvi_module.infer, "Trace_ELBO", functools.partial(
        sdvi_module.infer.Trace_ELBO, vectorize_particles=fed_particles(tables)))
    monkeypatch.setattr(torch, "randn", _fake_randn)
    got = sdvi._combine_inferences(torch.Generator().manual_seed(0), tguides, branches)
    assert isinstance(got, SDVIResult) and list(got.slp_weights) == list(want.slp_weights)
    for tag in want.slp_weights:
        np.testing.assert_allclose(got.slp_weights[tag].item(), float(want.slp_weights[tag]),
                                   rtol=RTOL, atol=1e-6)


def _exact_gaps(weights):
    exact = cs.branch_weights()
    assert abs(sum(float(v) for v in weights.values()) - 1) < 1e-4
    assert set(weights) == set(exact)
    return max(abs(float(v) - exact[k]) for k, v in weights.items())


def test_short_dcc_run_gives_the_exact_weights():
    chains, warmup, samples, depths = cs.DCC_RUN
    dcc = DCC(cs.branch_model, mcmc_kwargs=dict(num_warmup=warmup, num_samples=samples,
                                                num_chains=chains, device="cpu"),
              kernel_cls=functools.partial(NUTS, max_tree_depth=depths),
              num_slp_samples=cs.DCC_SLP_SAMPLES)
    res = dcc.run(0)
    assert isinstance(res, DCCResult)
    assert res.samples["0"]["a1"].shape == (chains * samples,)
    assert _exact_gaps(res.slp_weights) < cs.SS_GATE


def test_short_sdvi_run_gives_the_exact_weights():
    lr, steps, particles = cs.SDVI_RUN
    sdvi = SDVI(cs.branch_model, Adam(lr), svi_num_steps=steps, num_slp_samples=cs.DCC_SLP_SAMPLES,
                combine_elbo_particles=particles, device="cpu")
    res = sdvi.run(1)
    assert all(isinstance(g, AutoNormal) for g, _ in res.guides.values())
    assert _exact_gaps(res.slp_weights) < cs.SS_GATE


def test_conditioned_branch_stays_an_int_and_its_density_matches_jax():
    slp = handlers.condition(cs.branch_model, data={"m": 0})
    tr = handlers.trace(handlers.seed(slp, torch.Generator().manual_seed(0))).get_trace()
    assert isinstance(tr["m"]["value"], int) and isinstance(tr["obs"]["value"], float)
    got, _ = log_density(slp, (), {}, {"a1": torch.tensor(0.3)})
    want, _ = jlog_density(jhandlers.condition(jax_branch_model, data={"m": 0}), (), {},
                           {"a1": jnp.float32(0.3)})
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_the_raises_match_jax():
    def continuous_branch():
        npt.sample("x", dist.Normal(0.0, 1.0), infer={"branching": True})

    def jax_continuous_branch():
        numpyro_tpu.sample("x", jdist.Normal(0.0, 1.0), infer={"branching": True})

    with pytest.raises(RuntimeError, match="discrete"):
        DCC(continuous_branch, mcmc_kwargs={"device": "cpu"})._find_slps(torch.Generator())
    with pytest.raises(RuntimeError, match="discrete"):
        JDCC(jax_continuous_branch, mcmc_kwargs={})._find_slps(random.PRNGKey(0))
    with pytest.raises(ValueError, match="loss must be an instance of"):
        SDVI(cs.branch_model, Adam(0.1), loss=RenyiELBO())
    with pytest.raises(ValueError, match="loss must be an instance of"):
        JSDVI(jax_branch_model, joptim.Adam(0.1), loss=JRenyiELBO())


def test_both_run_on_the_card_by_default_and_never_fall_back():
    dcc = DCC(cs.branch_model, mcmc_kwargs={"num_warmup": 1, "num_samples": 1})
    sdvi = SDVI(cs.branch_model, Adam(0.1))
    assert dcc.device == sdvi.device == torch.device("cuda")
    if not torch.cuda.is_available():
        for inference in (dcc, sdvi):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                inference.run(0)


@pytest.mark.parametrize("family, params, value", [
    ("Categorical", {"probs": [0.2, 0.3, 0.5]}, 2),
    ("Bernoulli", {"probs": 0.3}, 1),
    ("Poisson", {"rate": 2.5}, 3),
    ("Normal", {"loc": 0.5, "scale": 2.0}, 0.2),
    ("Normal", {"loc": 0.5, "scale": 2.0}, 1),
])
def test_log_prob_takes_a_python_number_as_jax_does(family, params, value):
    """A branch conditioned on a Python int, or ``obs=0.2``: the value is
    taken as a 0-dim tensor (filled on the parameters' device)."""
    got = getattr(dist, family)(**{k: torch.tensor(v) for k, v in params.items()}).log_prob(value)
    want = getattr(jdist, family)(**{k: jnp.asarray(v) for k, v in params.items()}).log_prob(value)
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
