"""``infer/inspect.py`` of the port against the JAX package's, on the models
of the JAX package's ``tests/test_inspect.py``: ``get_dependencies``,
``get_model_relations``, ``generate_graph_specification`` and the source of
``render_model``'s graph must be equal, and ``render_model`` without
``graphviz`` raises the same ``ImportError``.  The GLM op carries a
provenance pass through to its result.  Exact comparisons: the outputs are
names, sets and strings."""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu.contrib.control_flow import scan as jscan
from numpyro_tpu.infer import inspect as jinspect
from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch.contrib.control_flow import scan
from numpyro_tpu_torch.infer import inspect
from numpyro_tpu_torch.ops import glm
from numpyro_tpu_torch.ops.provenance import eval_provenance

torch.set_num_threads(1)


# each case: (JAX model, port model, JAX args, port args), the models of
# tests/test_inspect.py written once for each package
def _simple(np_, jnp_, t):
    def model():
        a = np_.sample("a", t.Normal(0, 1))
        np_.sample("b", t.Normal(a, 1), obs=jnp_(0.0))

    return model, ()


def _collider(np_, jnp_, t):
    def model():
        a = np_.sample("a", t.Normal(0, 1))
        b = np_.sample("b", t.LogNormal(0, 1))
        c = np_.sample("c", t.Normal(a, b))
        np_.sample("d", t.Normal(c, 1), obs=jnp_(0.0))

    return model, ()


def _plate_coupling(np_, jnp_, t):
    def model():
        with np_.plate("p", 5):
            a = np_.sample("a", t.Normal(0, 1))
        np_.sample("b", t.Normal(a.sum(), 1), obs=jnp_(0.0))

    return model, ()


def _relations(np_, jnp_, t):
    def model(data):
        m = np_.sample("m", t.Normal(0, 1))
        sd = np_.sample("sd", t.LogNormal(m, 1))
        with np_.plate("N", len(data)):
            np_.sample("obs", t.Normal(m, sd), obs=data)

    return model, (jnp_(np.ones(3, np.float32)),)


def _render(np_, jnp_, t):
    def model(data):
        m = np_.sample("m", t.Normal(0, 1))
        with np_.plate("N", len(data)):
            np_.sample("obs", t.Normal(m, 1), obs=data)

    return model, (jnp_(np.ones(3, np.float32)),)


def _factor_sites(np_, jnp_, t):
    def model():
        a = np_.sample("a", t.Normal(0, 1))
        np_.factor("b", jnp_(0.0))
        np_.factor("c", a)

    return model, ()


def _discrete_chain(np_, jnp_, t):
    exp = jnp.exp if jnp_ is jnp.asarray else torch.exp

    def model():
        a = np_.sample("a", t.Dirichlet(jnp_(np.ones(3, np.float32))))
        b = np_.sample("b", t.Categorical(a))
        c = np_.sample("c", t.Normal(jnp_(np.zeros(3, np.float32)), 1).to_event(1))
        d = np_.sample("d", t.Poisson(exp(c[b])))
        np_.sample("e", t.Normal(d, 1), obs=jnp_(np.ones((), np.float32)))

    return model, ()


def _plate_collider(np_, jnp_, t):
    exp = jnp.exp if jnp_ is jnp.asarray else torch.exp

    def model(data):
        i_plate = np_.plate("i", data.shape[0], dim=-2)
        j_plate = np_.plate("j", data.shape[1], dim=-1)
        with i_plate:
            x = np_.sample("x", t.Normal(0, 1))
        with j_plate:
            y = np_.sample("y", t.Normal(0, 1))
        with i_plate, j_plate:
            np_.sample("z", t.Normal(x, exp(y)), obs=data)

    return model, (jnp_(np.ones((3, 2), np.float32)),)


def _plate_dependency(np_, jnp_, t):
    def model(data):
        w = np_.sample("w", t.Normal(0, 1))
        with np_.plate("p", len(data)):
            x = np_.sample("x", t.Normal(0, 1))
            y = np_.sample("y", t.Normal(0, 1))
            np_.sample("z", t.Normal(w + x + y, 1), obs=data)

    return model, (jnp_(np.ones(2, np.float32)),)


def _nested_plate_collider(np_, jnp_, t):
    def model():
        plate_i = np_.plate("i", 2, dim=-1)
        plate_j = np_.plate("j", 3, dim=-2)
        plate_k = np_.plate("k", 3, dim=-2)
        with plate_i:
            with plate_j:
                a = np_.sample("a", t.Normal(0, 1))
            with plate_k:
                b = np_.sample("b", t.Normal(0, 1))
            c = np_.sample("c", t.Normal(a.sum(0) + b.sum((0, 1)), 1))
        np_.sample("d", t.Normal(c.sum(), 1), obs=jnp_(np.zeros((), np.float32)))

    return model, ()


def _deterministic_and_param(np_, jnp_, t):
    def model():
        w = np_.param("w", jnp_(1.0))
        a = np_.sample("a", t.Normal(w, 1))
        np_.deterministic("a2", a * 2)
        np_.sample("y", t.Normal(a, 1), obs=jnp_(0.0))

    return model, ()


def _scan_model(np_, jnp_, t):
    scan_fn = jscan if jnp_ is jnp.asarray else scan

    def model(T):
        def transition(carry, _):
            z = np_.sample("z", t.Normal(carry, 1.0))
            np_.sample("x", t.Normal(z, 1.0), obs=jnp_(0.0))
            return z, z

        scan_fn(transition, jnp_(0.0), None, length=T)

    return model, (3,)


def _as_tensor(x):
    return torch.as_tensor(x, dtype=torch.float32) if not isinstance(x, torch.Tensor) else x


def _pair(case):
    jax_model, jax_args = case(numpyro_tpu, jnp.asarray, jdist)
    torch_model, torch_args = case(npt, _as_tensor, dist)
    return jax_model, jax_args, torch_model, torch_args


DEPENDENCY_CASES = {
    "simple": _simple, "collider_moralization": _collider, "plate_coupling": _plate_coupling,
    "factor_sites": _factor_sites, "discrete_chain": _discrete_chain,
    "plate_collider": _plate_collider, "plate_dependency": _plate_dependency,
    "nested_plate_collider": _nested_plate_collider,
}
RELATION_CASES = {
    "relations_and_graph_spec": _relations, "render_model": _render,
    "deterministic_and_param": _deterministic_and_param, "scan_model": _scan_model,
}


@pytest.mark.parametrize("name", sorted(DEPENDENCY_CASES))
def test_get_dependencies_matches_jax(name):
    jax_model, jax_args, torch_model, torch_args = _pair(DEPENDENCY_CASES[name])
    want = jinspect.get_dependencies(jax_model, jax_args)
    got = inspect.get_dependencies(torch_model, torch_args, device="cpu")
    assert got == want


def _spec_fields(spec):
    return (spec.membership, spec.parent, {k: (n.observed, n.dist_name, n.constraint)
                                           for k, n in spec.nodes.items()}, spec.edges)


# edges the JAX package draws from its jaxpr rule for ``lax.scan``, which
# tags every output of a scan with every input: the whole series of the
# observed ``x`` enters the scan, so JAX has ``z``'s density depend on it.
# The port runs the steps and finds that it does not (ROADMAP Queue 3).
SCAN_UNION_EDGES = {"scan_model": [("x", "z")]}


@pytest.mark.parametrize("name", sorted(RELATION_CASES) + sorted(DEPENDENCY_CASES))
def test_get_model_relations_and_graph_match_jax(name):
    """The relations, the graph specification with and without params and
    the rendered source (with the distributions' legend) are JAX's, but for
    the edges of ``SCAN_UNION_EDGES``, which JAX has and the port has not."""
    case = {**DEPENDENCY_CASES, **RELATION_CASES}[name]
    jax_model, jax_args, torch_model, torch_args = _pair(case)
    want = jinspect.get_model_relations(jax_model, jax_args)
    for src, dst in SCAN_UNION_EDGES.get(name, ()):
        want["sample_sample"][dst].remove(src)
    got = inspect.get_model_relations(torch_model, torch_args, device="cpu")
    assert got == want
    for render_params in (False, True):
        assert _spec_fields(inspect.generate_graph_specification(got, render_params)) == \
            _spec_fields(jinspect.generate_graph_specification(want, render_params))
    pytest.importorskip("graphviz")
    spec = inspect.generate_graph_specification(got, render_params=True)
    jspec = jinspect.generate_graph_specification(want, render_params=True)
    assert inspect.render_graph(spec, render_distributions=True).source == \
        jinspect.render_graph(jspec, render_distributions=True).source


def test_render_model_source_matches_jax():
    pytest.importorskip("graphviz")
    jax_model, jax_args, torch_model, torch_args = _pair(_render)
    got = npt.render_model(torch_model, torch_args, device="cpu", render_distributions=True)
    want = numpyro_tpu.render_model(jax_model, jax_args, render_distributions=True)
    assert got.source == want.source
    assert "obs" in got.source


def test_render_model_without_graphviz_raises_jax_s_error(monkeypatch):
    jax_model, jax_args, torch_model, torch_args = _pair(_render)
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(ImportError) as jax_error:
        numpyro_tpu.render_model(jax_model, jax_args)
    with pytest.raises(ImportError) as torch_error:
        npt.render_model(torch_model, torch_args, device="cpu")
    assert str(torch_error.value) == str(jax_error.value)


def _glm_data(n=200, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    return X, y


def test_provenance_passes_through_the_glm_op():
    """A provenance pass reaches the op's plain version with a plain tensor
    and the result carries ``w``'s name, beside a value equal to the op's."""
    X, y = _glm_data()
    data = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y), dtype="split")
    w = torch.linspace(-0.5, 0.5, 4)
    glm.reset_launch_counts()
    out = eval_provenance(lambda w, v: {"ll": glm.bernoulli_logits_loglik(w, data), "v": v * 2},
                          w=w, v=torch.ones(()))
    assert out == {"ll": frozenset({"w"}), "v": frozenset({"v"})}
    assert glm.launch_counts["plain"] == 1


def test_glm_model_dependencies_match_jax():
    X, y = _glm_data()
    d = X.shape[1]
    jdata = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype="split")
    tdata = glm.prepare_glm_data(torch.from_numpy(X), torch.from_numpy(y), dtype="split")

    def jax_model(data):
        w = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(d), 1.0).to_event(1))
        numpyro_tpu.factor("lik", jglm.bernoulli_logits_loglik(w, data))

    def torch_model(data):
        w = npt.sample("w", dist.Normal(torch.zeros(d), 1.0).to_event(1))
        npt.factor("lik", glm.bernoulli_logits_loglik(w, data))

    want = jinspect.get_dependencies(jax_model, (jdata,))
    assert inspect.get_dependencies(torch_model, (tdata,), device="cpu") == want
    assert want["posterior_dependencies"] == {"w": {"w": set(), "lik": set()}}
    assert inspect.get_model_relations(torch_model, (tdata,), device="cpu") == \
        jinspect.get_model_relations(jax_model, (jdata,))


def test_inspection_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    jax_model, jax_args, torch_model, torch_args = _pair(_simple)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inspect.get_dependencies(torch_model, torch_args)
