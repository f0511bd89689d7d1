"""``TraceGraph_ELBO`` and ``ops.provenance`` of the port against the JAX
package's: the dependency sets of every log-prob on three models (the
model of ``tests/infer/test_gradient.py``, a plated one and one that indexes
with its latents), the surrogate loss and its gradient on the same latents
(rtol 1e-5), and the port alone against the closed-form gradient of
``test_gradient``'s case (its gate, 0.05)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.infer import TraceGraph_ELBO as JTraceGraph_ELBO
from numpyro_tpu.infer.elbo import get_nonreparam_deps as jget_nonreparam_deps
from numpyro_tpu_torch.infer import TraceGraph_ELBO
from numpyro_tpu_torch.infer.elbo import MultiFrameTensor, get_nonreparam_deps
from numpyro_tpu_torch.ops.provenance import ProvenanceTensor, eval_provenance, get_provenance

torch.set_num_threads(1)

MUS = np.array([-1.0, 1.0], np.float32)
LOCS = np.array([-2.0, 0.0, 1.5], np.float32)
DATA = np.array([0.3, -1.2, 2.0, 0.8, 1.1], np.float32)


class _GivenDraw(dist.Distribution):
    """``base`` whose draw is ``draw(base)``: JAX's value of a discrete site,
    or ``loc + scale * eps`` with JAX's ``eps`` for a reparameterised one (the
    path of the gradient stays)."""

    def __init__(self, base, draw):
        self.base, self.draw = base, draw
        self.support, self.has_rsample = base.support, base.has_rsample
        super().__init__(base.batch_shape, base.event_shape)

    def sample(self, key, sample_shape=()):
        return self.draw(self.base)

    def log_prob(self, value):
        return self.base.log_prob(value)


def _drawn(base, name, draws):
    return base if draws is None else _GivenDraw(base, draws[name])


def _jax_draws(guide_j, p):
    """The port's draws of JAX's latents at the guide seed of JAX's one
    particle (``random.split(PRNGKey(0))[1]``)."""
    tr = jhandlers.trace(jhandlers.seed(lambda: guide_j(p), random.split(random.PRNGKey(0))[1])
                         ).get_trace()
    draws = {}
    for name, site in tr.items():
        if site["type"] != "sample":
            continue
        value = np.asarray(site["value"])
        if site["fn"].has_rsample:
            eps = (value - np.asarray(site["fn"].loc)) / np.asarray(site["fn"].scale)
            eps = torch.from_numpy(np.asarray(eps, np.float32))
            draws[name] = lambda d, eps=eps: d.loc + d.scale * eps
        else:
            draws[name] = lambda d, v=torch.from_numpy(value.astype(np.int64)): v
    return draws


# the model of tests/infer/test_gradient.py:70-108, then a plated model and a
# chain of indexing latents, each in both packages


def gradient_model_j():
    z = numpyro_tpu.sample("z", jdist.Bernoulli(0.3))
    numpyro_tpu.sample("x", jdist.Normal(jnp.asarray(MUS)[z], 1.0), obs=1.0)


def gradient_model_t():
    z = npt.sample("z", dist.Bernoulli(0.3))
    npt.sample("x", dist.Normal(torch.from_numpy(MUS)[z.long()], 1.0), obs=torch.tensor(1.0))


def gradient_guide_j(p):
    numpyro_tpu.sample("z", jdist.Bernoulli(logits=p["phi"]))


def gradient_guide_t(p, draws=None):
    npt.sample("z", _drawn(dist.Bernoulli(logits=p["phi"]), "z", draws))


def plated_model_j():
    loc = numpyro_tpu.sample("loc", jdist.Normal(0.0, 1.0))
    with numpyro_tpu.plate("N", 5):
        z = numpyro_tpu.sample("z", jdist.Bernoulli(0.4))
        numpyro_tpu.sample("x", jdist.Normal(loc + z, 1.0), obs=jnp.asarray(DATA))


def plated_model_t():
    loc = npt.sample("loc", dist.Normal(0.0, 1.0))
    with npt.plate("N", 5):
        z = npt.sample("z", dist.Bernoulli(0.4))
        npt.sample("x", dist.Normal(loc + z, 1.0), obs=torch.from_numpy(DATA))


def plated_guide_j(p):
    numpyro_tpu.sample("loc", jdist.Normal(p["m"], 0.5))
    with numpyro_tpu.plate("N", 5):
        numpyro_tpu.sample("z", jdist.Bernoulli(logits=p["phi"]))


def plated_guide_t(p, draws=None):
    npt.sample("loc", _drawn(dist.Normal(p["m"], 0.5), "loc", draws))
    with npt.plate("N", 5):
        npt.sample("z", _drawn(dist.Bernoulli(logits=p["phi"]), "z", draws))


def indexed_model_j():
    c = numpyro_tpu.sample("c", jdist.Categorical(jnp.array([0.2, 0.5, 0.3])))
    b = numpyro_tpu.sample("b", jdist.Bernoulli(jnp.array([0.1, 0.6, 0.9])[c]))
    w = numpyro_tpu.sample("w", jdist.Normal(0.0, 1.0))
    numpyro_tpu.sample("x", jdist.Normal(jnp.asarray(LOCS)[(c,)] + w, 1.0), obs=0.5)
    numpyro_tpu.sample("y", jdist.Normal(jnp.asarray(MUS)[b] * w, 1.0), obs=-0.2)


def indexed_model_t():
    c = npt.sample("c", dist.Categorical(torch.tensor([0.2, 0.5, 0.3])))
    b = npt.sample("b", dist.Bernoulli(torch.tensor([0.1, 0.6, 0.9])[c]))
    w = npt.sample("w", dist.Normal(0.0, 1.0))
    npt.sample("x", dist.Normal(torch.from_numpy(LOCS)[(c,)] + w, 1.0), obs=torch.tensor(0.5))
    npt.sample("y", dist.Normal(torch.from_numpy(MUS)[b.long()] * w, 1.0),
               obs=torch.tensor(-0.2))


def indexed_guide_j(p):
    numpyro_tpu.sample("c", jdist.Categorical(logits=p["lc"]))
    numpyro_tpu.sample("b", jdist.Bernoulli(logits=p["phi"]))
    numpyro_tpu.sample("w", jdist.Normal(p["m"], 1.0))


def indexed_guide_t(p, draws=None):
    npt.sample("c", _drawn(dist.Categorical(logits=p["lc"]), "c", draws))
    npt.sample("b", _drawn(dist.Bernoulli(logits=p["phi"]), "b", draws))
    npt.sample("w", _drawn(dist.Normal(p["m"], 1.0), "w", draws))


CASES = {
    "gradient": (gradient_model_j, gradient_guide_j, gradient_model_t, gradient_guide_t,
                 {"phi": np.float32(0.2)}),
    "plated": (plated_model_j, plated_guide_j, plated_model_t, plated_guide_t,
               {"m": np.float32(0.4), "phi": np.linspace(-1, 1, 5).astype(np.float32)}),
    "indexed": (indexed_model_j, indexed_guide_j, indexed_model_t, indexed_guide_t,
                {"lc": np.array([0.1, -0.3, 0.2], np.float32), "phi": np.float32(-0.4),
                 "m": np.float32(0.3)}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dependency_sets_equal_jax(case):
    model_j, guide_j, model_t, guide_t, params = CASES[case]
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    want = jget_nonreparam_deps(model_j, lambda: guide_j(pj), (), {}, {})
    got = get_nonreparam_deps(model_t, lambda: guide_t(pt), (), {}, {}, device=torch.device("cpu"))
    assert got == want, (got, want)
    if case == "indexed":
        # the scale of x depends on c only through an index, y on b likewise
        assert got[0]["x"] == {"c"} and got[0]["y"] == {"b"} and got[0]["b"] == {"b", "c"}


@pytest.mark.parametrize("case", list(CASES))
def test_surrogate_loss_and_gradient_equal_jax_on_the_same_latents(case):
    model_j, guide_j, model_t, guide_t, params = CASES[case]
    draws = _jax_draws(guide_j, {k: jnp.asarray(v) for k, v in params.items()})

    def loss_j(p):
        return JTraceGraph_ELBO().loss(random.PRNGKey(0), {}, model_j, lambda: guide_j(p))

    def loss_t(p):
        return TraceGraph_ELBO().loss(torch.Generator().manual_seed(0), {}, model_t,
                                      lambda: guide_t(p, draws))

    val_j, grad_j = jax.value_and_grad(loss_j)({k: jnp.asarray(v) for k, v in params.items()})
    grad_t, val_t = torch.func.grad_and_value(loss_t)(
        {k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(grad_t[k].numpy(), np.asarray(grad_j[k]), rtol=1e-5, atol=1e-6)


def test_gradient_within_the_jax_tests_gate_of_the_closed_form():
    p0, data = 0.3, 1.0
    mus = torch.from_numpy(MUS)

    def exact_loss(phi):
        q = torch.sigmoid(phi)
        terms = [dist.Bernoulli(p0).log_prob(torch.tensor(float(z)))
                 + dist.Normal(mus[z], 1.0).log_prob(torch.tensor(data))
                 - dist.Bernoulli(logits=phi).log_prob(torch.tensor(float(z))) for z in (0, 1)]
        return -((1 - q) * terms[0] + q * terms[1])

    elbo = TraceGraph_ELBO(num_particles=20000)

    def loss(phi):
        return elbo.loss(torch.Generator().manual_seed(0), {}, gradient_model_t,
                         lambda: gradient_guide_t({"phi": phi}))

    phi = torch.tensor(0.2)
    got, want = torch.func.grad(loss)(phi).item(), torch.func.grad(exact_loss)(phi).item()
    assert abs(got - want) < 0.05, (got, want)


def test_provenance_tensor_tracks_nested_inputs_and_indices():
    out = eval_provenance(
        lambda a, b, i: {"sum": a + 1.0, "cat": torch.cat([a, b]), "index": torch.ones(3)[i],
                         "both": torch.stack((a, b)).sum(), "free": torch.zeros(2)},
        a=torch.ones(2), b=torch.zeros(2), i=torch.tensor(1))
    assert out == {"sum": {"a"}, "cat": {"a", "b"}, "index": {"i"}, "both": {"a", "b"},
                   "free": frozenset()}
    x = ProvenanceTensor(torch.arange(4.0), frozenset({"x"}))
    values, indices = x.max(0)
    assert get_provenance(values) == get_provenance(indices) == {"x"}
    assert get_provenance(x.detach()) == {"x"}


def test_multi_frame_tensor_sums_onto_the_target_plates_as_jax():
    from numpyro_tpu.infer.elbo import MultiFrameTensor as JMultiFrameTensor
    from numpyro_tpu.primitives import CondIndepStackFrame as JFrame
    from numpyro_tpu_torch.primitives import CondIndepStackFrame

    frames_t = [CondIndepStackFrame("outer", -2, 3, 3), CondIndepStackFrame("inner", -1, 4, 4)]
    frames_j = [JFrame(*f) for f in frames_t]
    value = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    ones = np.ones((3, 1), np.float32)
    got = MultiFrameTensor((frames_t, torch.from_numpy(value)), (frames_t[:1], torch.from_numpy(ones)))
    want = JMultiFrameTensor((frames_j, jnp.asarray(value)), (frames_j[:1], jnp.asarray(ones)))
    for target in ([], [0], [0, 1]):
        g = got.sum_to([frames_t[i] for i in target])
        w = want.sum_to([frames_j[i] for i in target])
        np.testing.assert_allclose(g.numpy(), np.asarray(w))
