"""The port's network blocks, flow transforms and ``module`` against the JAX
package's, on the same weights: JAX initialises a network, its parameters
are carried across with ``nn.params_from_numpy``, and both run on the same
numpy inputs.  Masks must agree exactly; every other value to ``rtol=1e-5``
in float32 (``atol=1e-6`` beside it for entries near zero), except where a
test says why not.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import numpyro_tpu
import numpyro_tpu.distributions as jdist
import numpyro_tpu.distributions.transforms as jtransforms
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.distributions.flows import (
    BlockNeuralAutoregressiveTransform as JBNAF,
    InverseAutoregressiveTransform as JIAF,
)
from numpyro_tpu.nn import auto_reg_nn as jarn
from numpyro_tpu.nn import block_neural_arn as jbnarn
from numpyro_tpu.nn import masked_dense as jmd
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
import numpyro_tpu_torch.distributions.transforms as transforms
from numpyro_tpu_torch import handlers, nn
from numpyro_tpu_torch.distributions.flows import (
    BlockNeuralAutoregressiveTransform,
    InverseAutoregressiveTransform,
)
from numpyro_tpu_torch.nn import auto_reg_nn, block_neural_arn

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# the network blocks


def test_params_from_numpy_keeps_the_structure():
    tree = [(np.ones((2, 3)), np.zeros(3)), (np.eye(2), None),
            {"w": np.ones(2), "log_scale": np.zeros(2), "b": None}, np.float32(0.5)]
    out = nn.params_from_numpy(tree, "cpu")
    assert isinstance(out, list) and isinstance(out[0], tuple) and out[1][1] is None
    assert out[2]["b"] is None and out[2]["w"].dtype == torch.float32
    assert out[3].shape == () and out[3].item() == 0.5
    assert torch.equal(out[0][0], torch.ones(2, 3))


@pytest.mark.parametrize("bias", [True, False])
def test_masked_dense_matches_jax(bias):
    mask = (np.random.default_rng(0).random((4, 5)) < 0.5).astype(np.float32)
    j_init, j_apply = jmd.MaskedDense(jnp.asarray(mask), bias=bias)
    out_shape, jparams = j_init(random.PRNGKey(0), (3, 4))
    t_init, t_apply = nn.MaskedDense(mask, bias=bias)
    t_shape, t_own = t_init(torch.Generator().manual_seed(0), (3, 4))
    assert tuple(t_shape) == tuple(out_shape) == (3, 5)
    assert jax.tree.map(np.shape, jparams) == (
        tuple(tuple(p.shape) for p in t_own) if bias else tuple(t_own.shape))
    x = _x((3, 4))
    _close(t_apply(nn.params_from_numpy(_np_tree(jparams), "cpu"), torch.from_numpy(x)),
           j_apply(jparams, jnp.asarray(x)))


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("param_dims", [[1, 1], [2]])
def test_autoregressive_nn_matches_jax(skip, param_dims):
    d, hidden = 5, [8, 10]
    perm = np.array([2, 0, 4, 1, 3])
    masks_j, skip_j = jarn._build_masks(d, hidden, perm, sum(param_dims))
    masks_t, skip_t = auto_reg_nn._build_masks(d, hidden, perm, sum(param_dims))
    for a, b in zip(masks_t + [skip_t], masks_j + [skip_j]):
        np.testing.assert_array_equal(a, np.asarray(b))

    j_init, j_apply = jarn.AutoregressiveNN(d, hidden, param_dims=param_dims, permutation=perm,
                                            skip_connections=skip, nonlinearity=jax.nn.elu)
    _, jparams = j_init(random.PRNGKey(1), (d,))
    t_init, t_apply = nn.AutoregressiveNN(d, hidden, param_dims=param_dims, permutation=perm,
                                          skip_connections=skip,
                                          nonlinearity=torch.nn.functional.elu)
    shape, own = t_init(torch.Generator().manual_seed(1), (d,))
    assert shape == (sum(param_dims) * d,)
    assert jax.tree.map(np.shape, jparams) == [
        tuple(None if p is None else tuple(p.shape) for p in layer) for layer in own]
    tparams = nn.params_from_numpy(_np_tree(jparams), "cpu")
    x = _x((3, 4, d))
    want = j_apply(jparams, jnp.asarray(x))
    got = t_apply(tparams, torch.from_numpy(x))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)

    # every output's Jacobian is triangular under the permutation: output
    # block k at position perm[i] depends only on inputs at perm[:i]
    def outputs(v):
        out = t_apply(tparams, v)
        return torch.cat([o.reshape(-1) for o in (out if isinstance(out, tuple) else (out,))])

    jac = torch.func.jacrev(outputs)(torch.from_numpy(x[0, 0])).reshape(-1, d, d)
    rank = np.empty(d, int)
    rank[perm] = np.arange(d)
    allowed = rank[None, :] < rank[:, None]  # [output position, input position]
    for block in jac:
        assert torch.all(block[torch.from_numpy(~allowed)] == 0)


def test_autoregressive_nn_refuses_narrow_layers_and_stax_pairs():
    with pytest.raises(ValueError, match="Hidden dimension"):
        nn.AutoregressiveNN(4, [3])
    with pytest.raises(TypeError, match="stax"):
        nn.AutoregressiveNN(3, [4], nonlinearity=(lambda *a: None, lambda *a: None))


@pytest.mark.parametrize("residual", [None, "normal", "gated"])
def test_block_neural_arn_matches_jax(residual):
    d, hidden = 3, [4, 2]
    for a, b in zip(block_neural_arn._block_masks(d, 2, 3), jbnarn._block_masks(d, 2, 3)):
        np.testing.assert_array_equal(a, b)
    j_init, j_apply = jbnarn.BlockNeuralAutoregressiveNN(d, hidden, residual)
    _, jparams = j_init(random.PRNGKey(2), (d,))
    t_init, t_apply = nn.BlockNeuralAutoregressiveNN(d, hidden, residual)
    _, own = t_init(torch.Generator().manual_seed(2), (d,))
    assert jax.tree.map(np.shape, jparams) == [
        (tuple(p.shape) if isinstance(p, torch.Tensor) else
         {k: None if v is None else tuple(v.shape) for k, v in p.items()} if p else ())
        for p in own]
    tparams = nn.params_from_numpy(_np_tree(jparams), "cpu")
    # a batch of particles and of chains: the diagonal blocks' log-Jacobian
    # keeps its (num_blocks, in, out) layout under both
    x = _x((2, 5, d))
    want_y, want_ld = j_apply(jparams, jnp.asarray(x))
    got_y, got_ld = t_apply(tparams, torch.from_numpy(x))
    assert got_y.shape == got_ld.shape == x.shape
    _close(got_y, want_y)
    _close(got_ld, want_ld)
    got_vmap = torch.func.vmap(lambda v: t_apply(tparams, v)[1])(torch.from_numpy(x))
    _close(got_vmap, want_ld)


# ---------------------------------------------------------------------------
# the flow transforms


def _iaf_pair(d=4, hidden=(8, 8), skip=False, seed=0):
    j_init, j_apply = jarn.AutoregressiveNN(d, list(hidden), permutation=jnp.arange(d),
                                            skip_connections=skip, nonlinearity=jax.nn.elu)
    _, jparams = j_init(random.PRNGKey(seed), (d,))
    t_init, t_apply = nn.AutoregressiveNN(d, list(hidden), skip_connections=skip,
                                          nonlinearity=torch.nn.functional.elu)
    tparams = nn.params_from_numpy(_np_tree(jparams), "cpu")
    return (JIAF(lambda x: j_apply(jparams, x)),
            InverseAutoregressiveTransform(lambda x: t_apply(tparams, x)))


def _bnaf_pair(d=3, hidden=(4, 4), residual=None, seed=0):
    j_init, j_apply = jbnarn.BlockNeuralAutoregressiveNN(d, list(hidden), residual)
    _, jparams = j_init(random.PRNGKey(seed), (d,))
    t_init, t_apply = nn.BlockNeuralAutoregressiveNN(d, list(hidden), residual)
    tparams = nn.params_from_numpy(_np_tree(jparams), "cpu")
    return (JBNAF(lambda x: j_apply(jparams, x)),
            BlockNeuralAutoregressiveTransform(lambda x: t_apply(tparams, x)))


def _slogdet(t, x):
    jac = torch.func.vmap(torch.func.jacrev(t))(x)
    return torch.linalg.slogdet(jac.double())[1]


@pytest.mark.parametrize("skip", [False, True])
def test_iaf_matches_jax_and_its_jacobian(skip):
    jt, tt = _iaf_pair(skip=skip)
    x = _x((5, 4))
    y = tt(torch.from_numpy(x))
    _close(y, jt(jnp.asarray(x)))
    ld = tt.log_abs_det_jacobian(torch.from_numpy(x), y)
    _close(ld, jt.log_abs_det_jacobian(jnp.asarray(x), jt(jnp.asarray(x))))
    # the log-Jacobian against slogdet of the Jacobian (atol 1e-5, as the
    # JAX package's own test: the float64 slogdet of a float32 Jacobian)
    _close(ld, _slogdet(tt, torch.from_numpy(x)), rtol=0, atol=1e-5)
    # the intermediates are the log-scales, and the inverse is exact
    y2, inter = tt.call_with_intermediates(torch.from_numpy(x))
    assert torch.equal(y2, y) and torch.equal(inter.sum(-1), ld)
    _close(tt.inv(y), x, rtol=0, atol=1e-5)
    _close(tt.inv(y), jt._inverse(jt(jnp.asarray(x))), rtol=0, atol=1e-5)


def test_iaf_clip_is_straight_through():
    """A log-scale past the clip takes the clipped value, and the gradient
    of the unclipped one (as ``lax.stop_gradient`` gives in JAX)."""
    t = InverseAutoregressiveTransform(lambda x: (torch.zeros_like(x), 10.0 * x),
                                       log_scale_max_clip=3.0)
    x = torch.tensor([1.0, 0.1])
    y, log_scale = t.call_with_intermediates(x)
    assert torch.equal(log_scale, torch.tensor([3.0, 1.0]))
    g = torch.func.grad(lambda v: t.call_with_intermediates(v)[1].sum())(x)
    assert torch.equal(g, torch.tensor([10.0, 10.0]))


@pytest.mark.parametrize("residual", [None, "normal", "gated"])
def test_bnaf_matches_jax_and_its_jacobian(residual):
    jt, tt = _bnaf_pair(residual=residual)
    x = _x((5, 3))
    y = tt(torch.from_numpy(x))
    _close(y, jt(jnp.asarray(x)))
    ld = tt.log_abs_det_jacobian(torch.from_numpy(x), y)
    _close(ld, jt.log_abs_det_jacobian(jnp.asarray(x), jt(jnp.asarray(x))))
    if residual is None:
        # atol 1e-4, as the JAX package's own test
        _close(ld, _slogdet(tt, torch.from_numpy(x)), rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError):
        tt.inv(y)


def test_flow_equality_is_the_networks_identity():
    net = lambda x: (x, x)  # noqa: E731
    assert InverseAutoregressiveTransform(net) == InverseAutoregressiveTransform(net)
    assert InverseAutoregressiveTransform(net) != InverseAutoregressiveTransform(lambda x: (x, x))
    assert InverseAutoregressiveTransform(net) != InverseAutoregressiveTransform(net, -4.0)
    assert BlockNeuralAutoregressiveTransform(net) != InverseAutoregressiveTransform(net)


def test_permute_and_reshape_match_jax():
    perm = np.array([2, 0, 3, 1])
    x = _x((3, 4))
    jt, tt = jtransforms.PermuteTransform(jnp.asarray(perm)), transforms.PermuteTransform(perm)
    y = tt(torch.from_numpy(x))
    _close(y, jt(jnp.asarray(x)), rtol=0, atol=0)
    _close(tt.inv(y), x, rtol=0, atol=0)
    assert tt.log_abs_det_jacobian(torch.from_numpy(x), y).shape == (3,)
    assert tt == transforms.PermuteTransform(perm.copy())
    assert tt != transforms.PermuteTransform(perm[::-1].copy())

    jr, tr = jtransforms.ReshapeTransform((2, 3), (6,)), transforms.ReshapeTransform((2, 3), (6,))
    x = _x((4, 6))
    y = tr(torch.from_numpy(x))
    assert y.shape == jr(jnp.asarray(x)).shape == (4, 2, 3)
    _close(y, jr(jnp.asarray(x)), rtol=0, atol=0)
    assert tr.inv(y).shape == (4, 6)
    assert tr.forward_shape((5, 6)) == jr.forward_shape((5, 6)) == (5, 2, 3)
    assert tr.inverse_shape((2, 3)) == jr.inverse_shape((2, 3)) == (6,)
    assert tr.log_abs_det_jacobian(torch.from_numpy(x), y).shape == (4,)
    assert (tr.domain.event_dim, tr.codomain.event_dim) == (1, 2)
    with pytest.raises(ValueError, match="shape sizes"):
        transforms.ReshapeTransform((2, 3), (5,))
    with pytest.raises(ValueError, match="cannot reshape"):
        tr(torch.zeros(5))

    # a batched Normal pushed through a reshape, as the batched guides do
    base_j = jdist.MultivariateNormal(jnp.zeros((3, 2)), scale_tril=jnp.eye(2) * 0.5)
    base_t = dist.MultivariateNormal(torch.zeros(3, 2), scale_tril=torch.eye(2) * 0.5)
    dj = jdist.TransformedDistribution(base_j, jtransforms.ReshapeTransform((6,), (3, 2)))
    dt = dist.TransformedDistribution(base_t, transforms.ReshapeTransform((6,), (3, 2)))
    assert dt.batch_shape == () and dt.event_shape == (6,)
    v = _x((6,))
    _close(dt.log_prob(torch.from_numpy(v)), dj.log_prob(jnp.asarray(v)))


def test_interval_bijection_matches_jax():
    c_j, c_t = jdist.constraints.interval(0.0, 0.1), dist.constraints.interval(0.0, 0.1)
    jt, tt = jdist.biject_to(c_j), dist.biject_to(c_t)
    x = _x((7,))
    y = tt(torch.from_numpy(x))
    _close(y, jt(jnp.asarray(x)))
    _close(tt.log_abs_det_jacobian(torch.from_numpy(x), y),
           jt.log_abs_det_jacobian(jnp.asarray(x), jt(jnp.asarray(x))))
    _close(tt.inv(y), x, rtol=1e-4)
    assert isinstance(tt.codomain, type(c_t))


# ---------------------------------------------------------------------------
# module


@pytest.mark.parametrize("block", ["arn", "bnaf"])
def test_module_and_init_need_a_generator(block):
    """Parameters are never drawn from torch's global generator on a device
    nobody asked for: ``module`` outside a ``seed`` handler and ``init_fn``
    without a generator raise, as ``sample`` does without a key."""
    net = (nn.AutoregressiveNN(3, [4]) if block == "arn"
           else block_neural_arn.BlockNeuralAutoregressiveNN(3))
    with pytest.raises(ValueError, match="seed"):
        npt.module("net", net, (3,))
    with pytest.raises(ValueError, match="torch.Generator"):
        net[0](None, (3,))
    # the params given, no generator is needed
    params = net[0](torch.Generator().manual_seed(0), (3,))[1]
    out = handlers.substitute(lambda: npt.module("net", net, (3,)),
                              data={"net$params": params})()(torch.ones(3))
    assert all(torch.isfinite(o).all() for o in (out if isinstance(out, tuple) else (out,)))


def test_module_registers_and_binds_the_params():
    d = 3
    net = nn.AutoregressiveNN(d, [4])

    def fn(x):
        return npt.module("arn", net, (d,))(x)

    x = torch.from_numpy(_x((d,)))
    tr = handlers.trace(handlers.seed(fn, 0)).get_trace(x)
    params = tr["arn$params"]["value"]
    assert tr["arn$params"]["type"] == "param" and len(params) == 2
    # the same draws from the same seed; substituted params are used as given
    again = handlers.trace(handlers.seed(fn, 0)).get_trace(x)["arn$params"]["value"]
    assert all(torch.equal(a, b) for a, b in zip(params[0], again[0]))
    fixed = [(torch.zeros_like(w), torch.ones_like(b)) for w, b in params]
    out = handlers.substitute(fn, data={"arn$params": fixed})(x)
    assert all(torch.equal(o, torch.ones(d)) for o in out)
    with pytest.raises(ValueError, match="input_shape"):
        handlers.seed(lambda: npt.module("arn", net), 0)()

    # the JAX package's module on JAX's params gives the same output
    jnet = jarn.AutoregressiveNN(d, [4])
    _, jparams = jnet[0](random.PRNGKey(0), (d,))

    def jfn(x):
        return numpyro_tpu.module("arn", jnet, (d,))(x)

    want = jhandlers.substitute(jfn, data={"arn$params": jparams})(jnp.asarray(x.numpy()))
    tparams = nn.params_from_numpy(_np_tree(jparams), "cpu")
    got = handlers.substitute(fn, data={"arn$params": tparams})(x)
    for g, w in zip(got, want):
        _close(g, w)


def test_initializers_draw_the_jax_families():
    """Moments of the port's draws against the families JAX's initializers
    draw from (JAX's values cannot be reproduced bit for bit)."""
    gen = torch.Generator().manual_seed(0)
    w = nn.util.glorot_normal()(gen, (400, 600))
    assert w.abs().max() <= 2 * math.sqrt(1 / 500) / 0.87962566103423978 + 1e-6
    np.testing.assert_allclose(w.var().item(), 1 / 500, rtol=0.02)
    wj = jax.nn.initializers.glorot_normal()(random.PRNGKey(0), (400, 600))
    np.testing.assert_allclose(float(wj.var()), 1 / 500, rtol=0.02)
    u = nn.util.glorot_uniform()(gen, (400, 600))
    np.testing.assert_allclose(u.abs().max().item(), math.sqrt(3 / 500), rtol=0.01)
    np.testing.assert_allclose(nn.util.normal()(gen, (100_000,)).std().item(), 1e-2, rtol=0.02)
    s = nn.util.uniform(1.0)(gen, (100_000,))
    assert 0 <= s.min() and s.max() < 1
