"""``numpyro_tpu_torch.contrib.module`` (``torch_module``,
``random_torch_module``, ``params_from_linen``) against the JAX package's
flax bridges.

- ``tests/contrib/test_module.py::test_nnx_module_svi``'s fit: the same
  linear network (JAX's initial weights carried across) under 500 steps of
  ``Adam(0.05)``, which draw nothing: the losses agree to rtol 1e-4.
- ``examples/vae.py``'s model and guide at the example's widths (784 -> 64
  -> 16, batch 64 of the MNIST surrogate), the linen weights carried by
  ``params_from_linen``: the ELBO on JAX's draws agrees to rtol 1e-5, and so
  do the losses of three ``Adam(1e-3)`` steps on JAX's draws; the parameters
  after them to rtol 1e-4 (atol 1e-4 of each tensor's largest entry: Adam
  divides a near-zero gradient by its own size).
- ``random_torch_module``'s log density equals ``random_flax_module``'s at
  the mapped sites (``bnn/0.weight`` is the first layer's kernel transposed),
  rtol 1e-5; a short batched NUTS run recovers ``w[0] ~ 2`` within 0.3, as
  ``test_random_nnx_module_bnn`` does.
- A ``BatchNorm`` module's buffers after two SVI steps equal what the module
  itself holds after the same forward passes; under ``vmap`` its update in
  place raises a clear error.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import chip_smoke as cs
import numpyro_tpu as jnpt
import numpyro_tpu.distributions as jdist
import numpyro_tpu.examples.datasets as jds
from examples import vae as jvae
from numpyro_tpu.contrib.module import nnx_module, random_flax_module
from numpyro_tpu.infer import SVI as JSVI
from numpyro_tpu.infer import Trace_ELBO as JTrace_ELBO
from numpyro_tpu.infer.util import log_density as jlog_density
from numpyro_tpu.optim import Adam as JAdam
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.contrib.module import (
    ParamShape, params_from_linen, random_torch_module, torch_module,
)
from numpyro_tpu_torch.infer import MCMC, NUTS, SVI, Trace_ELBO
from numpyro_tpu_torch.infer.util import log_density
from numpyro_tpu_torch.optim import Adam
from torch_draws import FedDraws

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """The JAX package's loaders download a missing file: refuse instead, so
    that both packages serve the MNIST surrogate."""

    def refuse(dset):
        for url in dset.urls:
            if not os.path.exists(jds._local_path(url)):
                raise RuntimeError("no network")

    monkeypatch.setattr(jds, "_download", refuse)


def _data():
    X = random.normal(random.PRNGKey(0), (50, 3))
    y = (X[:, 0] * 2).reshape(-1, 1)
    return X, y


class TorchLinear(torch.nn.Module):
    """The nnx ``Linear`` of ``tests/contrib/test_module.py`` in PyTorch:
    ``x @ w + b`` with the same parameter names and shapes."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(np.asarray(w)))
        self.b = torch.nn.Parameter(torch.tensor(np.asarray(b)))

    def forward(self, x):
        return x @ self.w + self.b


def test_nnx_module_svi_losses_match_jax():
    from flax import nnx

    class Linear(nnx.Module):
        def __init__(self, din, dout, *, rngs):
            self.w = nnx.Param(random.uniform(rngs.params(), (din, dout)))
            self.b = nnx.Param(jnp.zeros((dout,)))

        def __call__(self, x):
            return x @ self.w + self.b

    X, y = _data()
    linear = Linear(3, 1, rngs=nnx.Rngs(params=random.PRNGKey(0)))

    def jmodel(X, y=None):
        net = nnx_module("net", linear)
        jnpt.sample("y", jdist.Normal(net(X), 0.2).to_event(2), obs=y)

    jres = JSVI(jmodel, lambda X, y=None: None, JAdam(0.05), JTrace_ELBO()).run(
        random.PRNGKey(1), 500, X, y, progress_bar=False)

    tlinear = TorchLinear(linear.w[...], linear.b[...])

    def tmodel(X, y=None):
        net = torch_module("net", tlinear)
        npt.sample("y", dist.Normal(net(X), 0.2).to_event(2), obs=y)

    tres = SVI(tmodel, lambda X, y=None: None, Adam(0.05), Trace_ELBO(), device="cpu").run(
        1, 500, torch.tensor(np.asarray(X)), torch.tensor(np.asarray(y)))
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-4)
    assert set(tres.params["net$params"]) == {"w", "b"}
    assert tres.state.mutable_state is None  # no buffers, no mutable site
    w = tres.params["net$params"]["w"].ravel()
    assert abs(w[0].item() - 2.0) < 0.3
    # the module itself is left as it was
    torch.testing.assert_close(tlinear.w.detach(), torch.tensor(np.asarray(linear.w[...])))


# ---------------------------------------------------------------------------
# examples/vae.py


@pytest.fixture(scope="module")
def vae():
    """JAX's SVI of the example at its widths, initialized, and the port's
    networks carrying its weights."""
    _, batch_of = cs.vae_batches()
    batch = batch_of(0)
    jsvi = JSVI(jvae.model, jvae.guide, JAdam(1e-3), JTrace_ELBO())
    jstate = jsvi.init(random.PRNGKey(0), jnp.asarray(batch))
    jparams = jsvi.get_params(jstate)
    encoder, decoder = cs.vae_networks(torch.device("cpu"))
    for net, name in ((encoder, "encoder$params"), (decoder, "decoder$params")):
        linen = jax.tree.map(np.asarray, jparams[name])
        net.load_state_dict(params_from_linen(linen, net), strict=True)
    return {"jsvi": jsvi, "jstate": jstate, "batch": batch, "nets": (encoder, decoder)}


def _jax_eps(params, seed, batch):
    """The standard normals of JAX's guide draw of ``z`` at ``seed``."""
    from numpyro_tpu import handlers as jhandlers

    tr = jhandlers.trace(jhandlers.substitute(jhandlers.seed(jvae.guide, seed), data=params)
                         ).get_trace(jnp.asarray(batch))
    base = tr["z"]["fn"].base_dist
    return np.asarray((tr["z"]["value"] - base.loc) / base.scale)


def _port_params(jparams, nets):
    encoder, decoder = nets
    return {"encoder$params": params_from_linen(jax.tree.map(np.asarray,
                                                             jparams["encoder$params"]), encoder),
            "decoder$params": params_from_linen(jax.tree.map(np.asarray,
                                                             jparams["decoder$params"]), decoder)}


def test_vae_elbo_on_jax_s_draws_matches_jax(vae):
    jsvi, batch = vae["jsvi"], vae["batch"]
    jparams = jsvi.get_params(vae["jstate"])
    key = random.PRNGKey(7)
    want = float(JTrace_ELBO().loss(key, jparams, jvae.model, jvae.guide, jnp.asarray(batch)))
    eps = _jax_eps(jparams, random.split(key)[1], batch)
    got = Trace_ELBO().loss(FedDraws([("normals", eps)]), _port_params(jparams, vae["nets"]),
                            cs.vae_model, cs.vae_guide, torch.tensor(batch), *vae["nets"])
    assert eps.shape == (cs.VAE_BATCH, cs.VAE_Z)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_vae_three_adam_steps_on_jax_s_draws_match_jax(vae):
    jsvi, batch = vae["jsvi"], vae["batch"]
    update = jax.jit(jsvi.update)
    jstate, draws, jlosses = vae["jstate"], [], []
    for _ in range(3):
        step_key = random.split(jstate.rng_key)[1]
        eps = _jax_eps(jsvi.get_params(jstate), random.split(step_key)[1], batch)
        draws.append(("normals", eps))
        jstate, loss = update(jstate, jnp.asarray(batch))
        jlosses.append(float(loss))
    encoder, decoder = (copy.deepcopy(n) for n in vae["nets"])
    svi = SVI(cs.vae_model, cs.vae_guide, Adam(1e-3), Trace_ELBO(), device="cpu")
    tbatch = torch.tensor(batch)
    state = svi.init(0, tbatch, encoder, decoder)
    state = state._replace(rng_key=FedDraws(draws))
    losses = []
    for _ in range(3):
        state, loss = svi.update(state, tbatch, encoder, decoder)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = _port_params(jsvi.get_params(jstate), (encoder, decoder))
    got = svi.get_params(state)
    for site in want:
        assert set(got[site]) == set(want[site])
        for k, w in want[site].items():
            torch.testing.assert_close(got[site][k], w, rtol=1e-4,
                                       atol=1e-4 * w.abs().max().item())


def test_params_from_linen_maps_dense_layers_in_order():
    rng = np.random.default_rng(0)
    linen = {"params": {f"Dense_{i}": {"kernel": rng.normal(size=s), "bias": rng.normal(size=s[1])}
                        for i, s in enumerate([(3, 5), (5, 2)])}}
    net = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.Tanh(), torch.nn.Linear(5, 2))
    out = params_from_linen(linen, net)
    assert set(out) == {"0.weight", "0.bias", "2.weight", "2.bias"}
    np.testing.assert_allclose(out["2.weight"].numpy(), linen["params"]["Dense_1"]["kernel"].T,
                               rtol=1e-6)
    assert out["0.weight"].dtype == torch.float32
    with pytest.raises(ValueError, match="Linear layers"):
        params_from_linen(linen, torch.nn.Linear(3, 5))
    with pytest.raises(ValueError, match="transposed"):
        params_from_linen(linen, torch.nn.Sequential(torch.nn.Linear(5, 3),
                                                     torch.nn.Linear(5, 2)))
    # linen numbers Dense_10 after Dense_9
    many = {f"Dense_{i}": {"kernel": np.full((1, 1), i), "bias": np.zeros(1)} for i in range(11)}
    chain = torch.nn.Sequential(*[torch.nn.Linear(1, 1) for _ in range(11)])
    assert params_from_linen(many, chain)["10.weight"].item() == 10


# ---------------------------------------------------------------------------
# random_torch_module


def test_random_torch_module_log_density_matches_random_flax_module():
    import flax.linen as nn

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(1)(nn.relu(nn.Dense(4)(x)))

    X, y = _data()
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(), torch.nn.Linear(4, 1))

    def jmodel(X, y=None):
        f = random_flax_module("bnn", MLP(), jdist.Normal(0, 1), input_shape=(1, 3))
        jnpt.sample("y", jdist.Normal(f(X), 0.2).to_event(2), obs=y)

    def tmodel(X, y=None):
        f = random_torch_module("bnn", net, dist.Normal(0, 1))
        npt.sample("y", dist.Normal(f(X), 0.2).to_event(2), obs=y)

    rng = np.random.default_rng(3)
    # linen numbers a compact module's layers in the order they are made:
    # Dense(1) first, so Dense_0 is the output layer
    kernels = {"Dense_1": (rng.normal(size=(3, 4)), rng.normal(size=4)),
               "Dense_0": (rng.normal(size=(4, 1)), rng.normal(size=1))}
    jvalues = {f"bnn/{k}.{p}": jnp.asarray(v, jnp.float32)
               for k, (kern, bias) in kernels.items() for p, v in (("kernel", kern), ("bias", bias))}
    names = {"Dense_1": "0", "Dense_0": "2"}
    tvalues = {}
    for k, (kern, bias) in kernels.items():
        tvalues[f"bnn/{names[k]}.weight"] = torch.tensor(kern.T, dtype=torch.float32)
        tvalues[f"bnn/{names[k]}.bias"] = torch.tensor(bias, dtype=torch.float32)
    want, jtr = jlog_density(jmodel, (X, y), {}, jvalues)
    got, ttr = log_density(tmodel, (torch.tensor(np.asarray(X)), torch.tensor(np.asarray(y))),
                           {}, tvalues)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert {k for k, s in ttr.items() if s["type"] == "sample"} == set(tvalues) | {"y"}
    assert all(isinstance(v, ParamShape) for v in ttr["bnn$params"]["value"].values())
    # a dict prior lifts the parameters it names and leaves the rest
    sub = log_density(
        lambda X: random_torch_module("bnn", net, {"2.bias": dist.Normal(0.0, 5.0)})(X),
        (torch.zeros(2, 3),), {}, {"bnn/2.bias": torch.zeros(1)})[1]
    held = sub["bnn$params"]["value"]
    assert isinstance(held["2.bias"], ParamShape) and isinstance(held["0.weight"], torch.Tensor)


def test_random_torch_module_under_batched_nuts_recovers_the_weight():
    X, y = (torch.tensor(np.asarray(a)) for a in _data())
    lin = TorchLinear(np.zeros((3, 1), np.float32), np.zeros(1, np.float32))

    def model(X, y=None):
        net = random_torch_module("net", lin, prior=dist.Normal(0, 3.0))
        npt.sample("y", dist.Normal(net(X), 0.2).to_event(2), obs=y)

    m = MCMC(NUTS(model), num_warmup=100, num_samples=100, num_chains=2, device="cpu")
    m.run(2, X, y)
    w = m.get_samples()["net/w"]
    assert w.shape == (200, 3, 1)
    assert abs(w[:, 0, 0].mean().item() - 2.0) < 0.3


# ---------------------------------------------------------------------------
# buffers


def _bn_net():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4),
                               torch.nn.Linear(4, 1))


def test_batchnorm_buffers_after_two_svi_steps_equal_the_module_s_own():
    X, y = (torch.tensor(np.asarray(a)) for a in _data())
    net = _bn_net()
    mirror = copy.deepcopy(net)

    def model(X, y=None):
        out = torch_module("bn", net)(X)
        npt.sample("y", dist.Normal(out, 0.2).to_event(2), obs=y)

    svi = SVI(model, lambda X, y=None: None, Adam(0.05), Trace_ELBO(), device="cpu")
    state = svi.init(0, X, y)
    params = [svi.get_params(state)["bn$params"]]
    held = state.mutable_state["bn$state"]
    before = {k: v.clone() for k, v in held.items()}
    for _ in range(2):
        state, _ = svi.update(state, X, y)
        params.append(svi.get_params(state)["bn$params"])
    # a step leaves the state it started from as it was, holding no tensor
    # of the gradient transform
    for k, v in before.items():
        assert torch.equal(held[k], v)
        assert not torch._C._functorch.is_functorch_wrapped_tensor(held[k])
    # the init trace's pass and the two steps' passes, each at that step's params
    with torch.no_grad():
        for p in (params[0], params[0], params[1]):
            mirror.load_state_dict(p, strict=False)
            mirror(X)
    got = state.mutable_state["bn$state"]
    assert set(got) == {"1.running_mean", "1.running_var", "1.num_batches_tracked"}
    for k, v in mirror.named_buffers():
        torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-7)
    assert got["1.num_batches_tracked"].item() == 3
    assert not any(t.requires_grad for t in got.values())
    # the module's own buffers are untouched
    assert net[1].num_batches_tracked.item() == 0


def test_batchnorm_in_train_mode_raises_under_vmap():
    X, y = (torch.tensor(np.asarray(a)) for a in _data())
    net = _bn_net()

    def model(X, y=None):
        out = random_torch_module("bn", net, dist.Normal(0.0, 1.0))(X)
        npt.sample("y", dist.Normal(out, 0.2).to_event(2), obs=y)

    m = MCMC(NUTS(model), num_warmup=2, num_samples=2, num_chains=2, device="cpu")
    with pytest.raises(RuntimeError, match=r"torch_module\('bn'\).*eval"):
        m.run(0, X, y)
    net.eval()
    m.run(0, X, y)
    assert m.get_samples()["bn/0.weight"].shape == (4, 4, 3)
