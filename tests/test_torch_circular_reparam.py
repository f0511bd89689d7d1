"""``ImproperUniform``, the init strategies on it, and the reparameterizers
``ProjectedNormalReparam`` and ``CircularReparam`` of the port against the
JAX package's, on ``tests/infer/test_reparam.py``'s models: the potential
and its gradient at the same unconstrained points (rtol 1e-5, atol 1e-6),
the deterministic site, ``CircularReparam`` with an observation, and a
short NUTS run under the JAX test's criterion."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.distributions import constraints as jconstraints
from numpyro_tpu.infer import initialization as jinit
from numpyro_tpu.infer import reparam as jreparam
from numpyro_tpu.infer import util as jutil
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.infer import MCMC, NUTS, initialization, reparam
from numpyro_tpu_torch.infer import util

from test_torch_discrete_families import _close, _t

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# ImproperUniform and the init strategies


def _improper_site(pkg):
    d = (jdist, dist)[pkg == "torch"]
    c = (jconstraints, constraints)[pkg == "torch"]
    return d.ImproperUniform(c.positive, (3,), (2,))


def test_improper_uniform_matches_jax():
    d_j, d_t = _improper_site("jax"), _improper_site("torch")
    assert d_t.batch_shape == d_j.batch_shape and d_t.event_shape == d_j.event_shape
    assert d_t.support.event_dim == d_j.support.event_dim == 1
    x = np.abs(np.random.default_rng(0).normal(size=(4, 3, 2))).astype(np.float32)
    np.testing.assert_array_equal(d_t.log_prob(_t(x)).numpy(), np.asarray(d_j.log_prob(x)))
    for d in (d_j, d_t):
        with pytest.raises(NotImplementedError, match="no sampler"):
            d.sample(torch.Generator() if d is d_t else random.PRNGKey(0))
    assert d_t.has_rsample and d_j.has_rsample


def _improper_model(pkg):
    sample, d, c, arr = ((numpyro_tpu.sample, jdist, jconstraints, jnp.asarray) if pkg == "jax"
                         else (npt.sample, dist, constraints, torch.tensor))
    x = sample("x", d.ImproperUniform(c.positive, (), (2,)))
    sample("y", d.Normal(x.sum(), 1.0), obs=arr(1.5))


def _site(pkg):
    """The site dict of ``x`` of ``_improper_model`` as an init strategy sees it."""
    d = (jdist, dist)[pkg == "torch"]
    c = (jconstraints, constraints)[pkg == "torch"]
    key = torch.Generator().manual_seed(0) if pkg == "torch" else random.PRNGKey(0)
    return {"type": "sample", "name": "x", "fn": d.ImproperUniform(c.positive, (), (2,)),
            "value": None, "is_observed": False, "args": (),
            "kwargs": {"rng_key": key, "sample_shape": ()}}


def test_init_strategies_on_an_improper_site_match_jax():
    """``init_to_uniform`` and ``init_to_value`` place the site without
    drawing from it, inside its support; ``init_to_median`` and
    ``init_to_sample`` (the median of one draw) find no sampler and fall back
    to ``init_to_uniform``, in both packages; the model itself cannot be
    run without a value for the site."""
    with pytest.raises(NotImplementedError):
        jhandlers.trace(jhandlers.seed(lambda: _improper_model("jax"),
                                       random.PRNGKey(0))).get_trace()
    for strategy, jstrategy in ((initialization.init_to_uniform, jinit.init_to_uniform),
                                (initialization.init_to_median, jinit.init_to_median),
                                (initialization.init_to_sample, jinit.init_to_sample)):
        site = _site("torch")
        value, jvalue = strategy(site), jstrategy(_site("jax"))
        assert value.shape == jvalue.shape == (2,) and bool((value > 0).all())
        # the same box in unconstrained space on the same generator state
        again = initialization.init_to_uniform(_site("torch"))
        np.testing.assert_array_equal(value.numpy(), again.numpy())
    got = initialization.init_to_value(site, values={"x": torch.tensor([0.5, 2.0])})
    np.testing.assert_array_equal(got.numpy(), [0.5, 2.0])
    with pytest.raises(NotImplementedError, match="no sampler"):
        handlers.seed(lambda: _improper_model("torch"), 0)()
    # a whole initialization: every chain's point lies in the support
    info = util.initialize_model(torch.Generator().manual_seed(0),
                                 lambda: _improper_model("torch"), num_chains=4)
    assert info.param_info.z["x"].shape == (4, 2)
    assert torch.isfinite(info.param_info.potential_energy).all()


# ---------------------------------------------------------------------------
# the reparameterizers (tests/infer/test_reparam.py's models)


def _projected_model(pkg):
    sample, d, rp, hd = ((numpyro_tpu.sample, jdist, jreparam, jhandlers) if pkg == "jax"
                         else (npt.sample, dist, reparam, handlers))
    arr = jnp.array if pkg == "jax" else torch.tensor
    with hd.reparam(config={"d": rp.ProjectedNormalReparam()}):
        sample("d", d.ProjectedNormal(arr([2.0, 0.0, 0.0])))


def _circular_model(pkg, obs=None):
    sample, d, rp, hd = ((numpyro_tpu.sample, jdist, jreparam, jhandlers) if pkg == "jax"
                         else (npt.sample, dist, reparam, handlers))
    with hd.reparam(config={"phi": rp.CircularReparam()}):
        sample("phi", d.VonMises(0.5, 3.0), obs=obs)


@pytest.mark.parametrize("which", ["projected", "circular"])
def test_reparameterized_potential_matches_jax(which):
    model = {"projected": _projected_model, "circular": _circular_model}[which]
    name, shape = {"projected": ("d_normal", (3,)), "circular": ("phi_unwrapped", ())}[which]
    jvg = jax.jit(jax.value_and_grad(
        lambda p: jutil.potential_energy(lambda: model("jax"), (), {}, p)))
    rng = np.random.default_rng(0)
    for _ in range(4):
        u = {name: (3.0 * rng.standard_normal(shape)).astype(np.float32)}
        jpe, jg = jvg({k: jnp.asarray(v) for k, v in u.items()})
        tg, tpe = torch.func.grad_and_value(
            lambda p: util.potential_energy(lambda: model("torch"), (), {}, p))(
            {k: torch.as_tensor(v) for k, v in u.items()})
        np.testing.assert_allclose(tpe.item(), float(jpe), rtol=1e-5)
        np.testing.assert_allclose(tg[name].numpy(), np.asarray(jg[name]), rtol=1e-5, atol=1e-6)
    tr = handlers.trace(handlers.seed(
        handlers.substitute(lambda: model("torch"), data={k: torch.as_tensor(v)
                                                          for k, v in u.items()}), 0)).get_trace()
    jtr = jhandlers.trace(jhandlers.seed(
        jhandlers.substitute(lambda: model("jax"), data={k: jnp.asarray(v)
                                                         for k, v in u.items()}),
        random.PRNGKey(0))).get_trace()
    site = "d" if which == "projected" else "phi"
    assert tr[site]["type"] == jtr[site]["type"] == "deterministic"
    _close(tr[site]["value"], jtr[site]["value"], atol=1e-6)


def test_circular_reparam_takes_an_observation_and_runs_under_nuts():
    obs = np.float32(2.9)
    lp_t = util.log_density(lambda: _circular_model("torch", torch.tensor(obs)), (), {}, {})[0]
    lp_j = jutil.log_density(lambda: _circular_model("jax", jnp.asarray(obs)), (), {}, {})[0]
    np.testing.assert_allclose(lp_t.item(), float(lp_j), rtol=1e-5)
    mcmc = MCMC(NUTS(lambda: _circular_model("torch")), num_warmup=150, num_samples=150,
                num_chains=2, device="cpu")
    mcmc.run(0)
    phi = mcmc.get_samples()["phi"].numpy()
    assert (phi >= -np.pi - 1e-6).all() and (phi <= np.pi + 1e-6).all()
    # the circular mean near 0.5, the JAX package's criterion
    assert abs(np.angle(np.exp(1j * phi).mean()) - 0.5) < 0.15
