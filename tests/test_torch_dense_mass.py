"""Dense and structured mass matrices in the port against the JAX package:
the block structure, the mass operations on ``(C, D)`` and ``(C, K, D)``
panels, the precision factors, the initial mass, the dense and block Welford
estimators, one NUTS tick and one transition on JAX's draws, and a warmup
window end from a JAX state (whole runs: ``test_torch_dense_runs.py``).
Float fields to rtol 1e-5 (atol given at each comparison) unless said
otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

from numpyro_tpu.infer import hmc_core as jc
from numpyro_tpu_torch.infer import hmc_core as core

# a draw source fed from JAX's keys, split as the JAX engine splits them
from test_torch_hmc_step import JaxDraws, _problem

torch.set_num_threads(1)

C, K = 3, 4
RTOL = 1e-5
SITES = {"a": (2,), "b": (), "w": (4,)}  # flat dim 7: a 0-1, b 2, w 3-6
# bool, dense blocks with a diagonal rest, a block whose sites are out of flat
# order, and blocks that cover every site
STRUCTURES = {
    "diag": False,
    "dense": True,
    "w": [("w",)],
    "w,a": [("w", "a")],
    "two": [("a", "b"), ("w",)],
}


def _layouts():
    proto = {k: np.zeros(s, np.float32) for k, s in SITES.items()}
    return (jc.FlatLayout({k: jnp.asarray(v) for k, v in proto.items()}),
            core.FlatLayout({k: torch.from_numpy(v) for k, v in proto.items()}))


def _blocks(structure):
    j_layout, t_layout = _layouts()
    return (jc.build_mass_blocks(j_layout, STRUCTURES[structure]),
            core.build_mass_blocks(t_layout, STRUCTURES[structure]))


def _close(t, j, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _close_tree(t, j, **kw):
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j)
        for k in j:
            _close(t[k], j[k], **kw)
    else:
        assert isinstance(t, torch.Tensor)
        _close(t, j, **kw)


def _spd(rng, c, b):
    a = rng.standard_normal((c, b, b)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) / b + 0.5 * np.eye(b, dtype=np.float32)).astype(np.float32)


def _mass(blocks, rng, c=C):
    """A random exposed mass structure: (C, b) diagonal or (C, b, b) SPD blocks."""
    parts = [
        _spd(rng, c, len(idx)) if dense else rng.uniform(0.5, 2.0, (c, len(idx))).astype(np.float32)
        for idx, dense in zip(blocks.indices, blocks.dense)
    ]
    return jc._expose(blocks, parts)


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} if isinstance(tree, dict) else jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_build_mass_blocks_matches_jax(structure):
    b_j, b_t = _blocks(structure)
    assert isinstance(b_t, core.MassBlocks) and b_t._fields == b_j._fields
    assert b_t.names == b_j.names and b_t.dense == b_j.dense and b_t.full == b_j.full
    assert len(b_t.indices) == len(b_j.indices)
    for a, b in zip(b_t.indices, b_j.indices):
        np.testing.assert_array_equal(a, b)
    # the permutation puts the blocks one after another and back
    order, undo = b_t.permutation(torch.device("cpu"))
    np.testing.assert_array_equal(order.numpy(), np.concatenate(b_j.indices))
    np.testing.assert_array_equal(order[undo].numpy(), np.arange(7))


def test_structured_mass_needs_sites():
    layout = core.FlatLayout({"x": torch.zeros(3)})
    layout.site_ranges = {}
    with pytest.raises(ValueError, match="dict-structured latent"):
        core.build_mass_blocks(layout, [("x",)])


@pytest.mark.parametrize("structure", list(STRUCTURES))
@pytest.mark.parametrize("panel", ["(C, D)", "(C, K, D)"])
def test_mass_operations_match_jax(structure, panel):
    b_j, b_t = _blocks(structure)
    rng = np.random.default_rng(1)
    shape = (C, 7) if panel == "(C, D)" else (C, K, 7)
    r = rng.standard_normal(shape).astype(np.float32)
    inv = _mass(b_j, rng)
    v_j = jc.apply_inv_mass(b_j, _to_jax(inv), jnp.asarray(r))
    v_t = core.apply_inv_mass(b_t, _to_torch(inv), torch.from_numpy(r))
    assert v_t.shape == shape
    _close(v_t, v_j)
    _close(core.kinetic(b_t, _to_torch(inv), torch.from_numpy(r)),
           jc.kinetic(b_j, _to_jax(inv), jnp.asarray(r)))
    if panel == "(C, D)":
        sqrt = _mass(b_j, rng)
        _close(core.draw_momentum(b_t, _to_torch(sqrt), torch.from_numpy(r)),
               jc.draw_momentum(b_j, _to_jax(sqrt), jnp.asarray(r)))
    # the U-turn check, which passes (C, K, D) checkpoint panels
    if panel == "(C, K, D)":
        last = rng.standard_normal((C, 1, 7)).astype(np.float32)
        rho = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            core._turning(b_t, _to_torch(inv), torch.from_numpy(r), torch.from_numpy(last),
                          torch.from_numpy(rho)).numpy(),
            np.asarray(jc._turning(b_j, _to_jax(inv), jnp.asarray(r), jnp.asarray(last),
                                   jnp.asarray(rho))),
        )


def test_precision_factors_match_jax():
    rng = np.random.default_rng(2)
    cov = _spd(rng, C, 6)
    cov[1] = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32).repeat(3, 0).repeat(3, 1)  # not PD
    sqrt_j, sqrt_inv_j = jc._precision_factors(jnp.asarray(cov))
    sqrt_t, sqrt_inv_t = core._precision_factors(torch.from_numpy(cov))
    # a matrix that is not positive definite gives NaN factors in both
    # packages, in the same places (assert_allclose holds NaN == NaN)
    assert np.isnan(np.asarray(sqrt_j)[1]).all() and np.isnan(sqrt_t[1].numpy()).all()
    np.testing.assert_array_equal(np.isnan(sqrt_inv_t.numpy()), np.isnan(np.asarray(sqrt_inv_j)))
    _close(sqrt_t, sqrt_j, atol=1e-5)
    _close(sqrt_inv_t, sqrt_inv_j, atol=1e-6)
    # S S^T = cov^{-1} and S^{-1} = sqrt_inv on the positive definite ones
    for c in (0, 2):
        s = sqrt_t[c].double().numpy()
        np.testing.assert_allclose(s @ s.T, np.linalg.inv(cov[c].astype(np.float64)), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(s @ sqrt_inv_t[c].double().numpy(), np.eye(6), atol=1e-5)


@pytest.mark.parametrize("given", ["none", "matrix", "diagonal of a dense block", "per chain", "dict"])
def test_init_mass_matches_jax(given):
    structure = "two" if given in ("none", "dict") else "dense"
    b_j, b_t = _blocks(structure)
    rng = np.random.default_rng(3)
    value = {
        "none": None,
        "matrix": _spd(rng, 1, 7)[0],
        "diagonal of a dense block": rng.uniform(0.5, 2.0, 7).astype(np.float32),
        "per chain": _spd(rng, C, 7),
        "dict": {("a", "b"): _spd(rng, 1, 3)[0], ("w",): rng.uniform(0.5, 2.0, 4).astype(np.float32)},
    }[given]
    out_j = jc.init_mass(b_j, C, jnp.float32, init_inverse=value)
    out_t = core.init_mass(b_t, C, torch.zeros(()), init_inverse=value)
    for a, b in zip(out_t, out_j):
        _close_tree(a, b, atol=1e-5)
    if given == "dict":
        assert set(out_t[0]) == {("a", "b"), ("w",)}
        assert out_t[0][("a", "b")].shape == (C, 3, 3) and out_t[0][("w",)].shape == (C, 4, 4)


@pytest.mark.parametrize("structure", ["dense", "w,a", "two"])
def test_welford_update_finalize_and_pool_match_jax(structure):
    b_j, b_t = _blocks(structure)
    rng = np.random.default_rng(4)
    wf_j = jc._welford_init(b_j, C, jnp.float32)
    wf_t = core._welford_init(b_t, C, torch.zeros(()))
    for _ in range(9):
        z = rng.standard_normal((C, 7)).astype(np.float32)
        wf_j = jc._welford_update(b_j, wf_j, jnp.asarray(z))
        wf_t = core._welford_update(b_t, wf_t, torch.from_numpy(z))
    for a, b in zip(wf_t, wf_j):
        _close_tree(a, b)
    for regularize in (True, False):
        for a, b in zip(core._welford_finalize(b_t, wf_t, regularize),
                        jc._welford_finalize(b_j, wf_j, regularize)):
            _close_tree(a, b, rtol=1e-4, atol=1e-5)
    pooled_t, pooled_j = core._welford_pool(b_t, wf_t), jc._welford_pool(b_j, wf_j)
    for a, b in zip(pooled_t, pooled_j):
        _close_tree(a, b)
    for a, b in zip(core._welford_finalize(b_t, pooled_t), jc._welford_finalize(b_j, pooled_j)):
        _close_tree(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine under dense and structured mass, on JAX's draws

# the logistic problem of test_torch_hmc_step (sites "b" () and "w" (4,)):
# one dense block, a dense block beside a diagonal one
ENGINE_STRUCTURES = {"dense": True, "w": [("w",)]}


def _engine(structure):
    pe_j, pe_t, z0 = _problem()
    j_layout = jc.FlatLayout({k: jnp.asarray(v[0]) for k, v in z0.items()})
    t_layout = core.FlatLayout({k: torch.as_tensor(v[0]) for k, v in z0.items()})
    b_j = jc.build_mass_blocks(j_layout, ENGINE_STRUCTURES[structure])
    b_t = core.build_mass_blocks(t_layout, ENGINE_STRUCTURES[structure])
    pg_j = jc.batched_potential(pe_j, j_layout)
    pg_t = core.batched_potential(pe_t, t_layout)
    z = np.asarray(j_layout.ravel_batch({k: jnp.asarray(v) for k, v in z0.items()}))
    rng = np.random.default_rng(5)
    inv = jc._expose(b_j, [
        _spd(rng, C, len(i)) * 0.05 if d else rng.uniform(0.02, 0.1, (C, len(i))).astype(np.float32)
        for i, d in zip(b_j.indices, b_j.dense)
    ])
    _, sqrt, _ = jc.init_mass(b_j, C, jnp.float32, init_inverse=inv)
    return pg_j, pg_t, b_j, b_t, z, inv, sqrt


@pytest.mark.parametrize("structure", list(ENGINE_STRUCTURES))
@pytest.mark.parametrize("ticks", [0, 5])
def test_one_tick_matches_jax(structure, ticks):
    pg_j, pg_t, b_j, b_t, z, inv, sqrt = _engine(structure)
    step_size, max_depth = 0.3, 5
    pe, grad = pg_j(jnp.asarray(z))
    keys = random.split(random.PRNGKey(0), C)
    t_j = jc._init_nuts_carry(keys, jnp.asarray(z), pe, grad, b_j, _to_jax(inv), sqrt, max_depth)
    for _ in range(ticks):
        t_j = jc._nuts_tick(t_j, b_j, pg_j, _to_jax(inv), step_size, max_depth, 1000.0)
    t_t = core.carry_from_numpy({k: np.asarray(v) for k, v in t_j._asdict().items()})
    _, k_swap, k_merge, k_dir = jc.split_keys(t_j.key, 4)
    draws = tuple(torch.from_numpy(np.array(x, np.float32)) for x in (
        jc.batch_uniform(k_swap), jc.batch_uniform(k_merge), jc.batch_rademacher(k_dir)))
    out_j = jc._nuts_tick(t_j, b_j, pg_j, _to_jax(inv), step_size, max_depth, 1000.0)
    out_t = core._nuts_tick(t_t, b_t, pg_t, _to_torch(inv), step_size, max_depth, 1000.0, *draws)
    for name in core.NutsCarry._fields:
        a, b = getattr(out_t, name), np.asarray(getattr(out_j, name))
        if a.is_floating_point():
            finite = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a.numpy()), finite, err_msg=name)
            _close(a[torch.from_numpy(finite)], b[finite], atol=1e-4)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("structure", list(ENGINE_STRUCTURES))
def test_nuts_transition_matches_jax(structure):
    pg_j, pg_t, b_j, b_t, z, inv, sqrt = _engine(structure)
    pe, grad = pg_j(jnp.asarray(z))
    keys = random.split(random.PRNGKey(4), C)
    step_size, max_depth = 0.3, 5
    out_j = jc.nuts_transition(pg_j, b_j, keys, jnp.asarray(z), pe, grad, _to_jax(inv), sqrt,
                               step_size, max_depth)
    out_t = core.nuts_transition(pg_t, b_t, JaxDraws(keys), torch.from_numpy(z),
                                 torch.from_numpy(np.asarray(pe)), torch.from_numpy(np.asarray(grad)),
                                 _to_torch(inv), _to_torch(sqrt), step_size, max_depth)
    assert int(np.asarray(out_j.num_steps).max()) > 3  # a real tree, not one leaf
    np.testing.assert_array_equal(out_t.num_steps.numpy(), np.asarray(out_j.num_steps))
    np.testing.assert_array_equal(out_t.diverging.numpy(), np.asarray(out_j.diverging))
    for name in ("z", "pe", "grad", "energy", "accept_prob"):
        _close(getattr(out_t, name), getattr(out_j, name), atol=1e-4)


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("structure", list(ENGINE_STRUCTURES))
def test_window_end_from_adapt_from_numpy_matches_jax(structure, pool):
    """Warmup in JAX up to the step before the first window end, the panel
    carried over with ``adapt_from_numpy``, and the window end (Welford
    finalize, precision factors, step-size search on JAX's draws) in both."""
    pg_j, pg_t, b_j, b_t, z, _, _ = _engine(structure)
    num_warmup = 20  # windows (0, 2), (3, 17), (18, 19): the end is step 17
    kw = dict(find_step_size=True, pool_chains=pool)
    init_j, update_j = jc.build_warmup(pg_j, b_j, num_warmup, **kw)
    _, update_t = core.build_warmup(pg_t, b_t, num_warmup, **kw)
    pe, grad = pg_j(jnp.asarray(z))
    adapt = init_j(random.split(random.PRNGKey(2), C), jnp.asarray(z), pe, grad, 0.1)
    # the Welford state of steps 3-16, as the middle window has gathered it
    rng = np.random.default_rng(6)
    wf = (adapt.wf_mean, adapt.wf_m2, adapt.wf_count)
    for _ in range(14):
        wf = jc._welford_update(
            b_j, wf, jnp.asarray(z + 0.1 * rng.standard_normal(z.shape).astype(np.float32)))
    adapt = adapt._replace(wf_mean=wf[0], wf_m2=wf[1], wf_count=wf[2])
    zs = jnp.asarray(z + 0.1 * rng.standard_normal(z.shape).astype(np.float32))
    pe, grad = pg_j(zs)
    adapt_t = core.adapt_from_numpy(jax.tree.map(np.asarray, adapt))
    assert isinstance(adapt_t, core.AdaptPanel) and adapt_t.wf_count[0].item() == 14
    accept = jnp.asarray([0.9, 0.5, 0.75])
    out_j = update_j(17, adapt, accept, zs, pe, grad)
    out_t = update_t(17, adapt_t, torch.from_numpy(np.asarray(accept)), torch.from_numpy(np.asarray(zs)),
                     torch.from_numpy(np.asarray(pe)), torch.from_numpy(np.asarray(grad)),
                     JaxDraws(adapt.rng_key))
    for name in core.AdaptPanel._fields:
        _close_tree(getattr(out_t, name), getattr(out_j, name), rtol=1e-4, atol=1e-5)
    if pool:  # one estimate for every chain
        inv = out_t.inverse_mass_matrix
        first = inv if isinstance(inv, torch.Tensor) else inv[("w",)]
        assert torch.equal(first[0], first[2])
