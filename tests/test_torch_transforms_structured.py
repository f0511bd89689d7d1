"""The port's structured constraints, transforms and ``biject_to`` rows
against the JAX package's, on the same numpy inputs: each constraint's
``__call__``, ``feasible_like``, ``event_dim`` and ``is_discrete`` on feasible
and infeasible values; each transform's forward map, inverse,
``log_abs_det_jacobian``, ``forward_shape`` and ``inverse_shape``, its round
trip, and its log-determinant against ``slogdet`` of the autograd Jacobian
where the map is square; ``biject_to``'s table, row for row, and each row's
composition, type by type.

The inputs follow ``tests/test_transforms_suite.py``'s specs (normal draws
scaled by 0.5, from a seed), widened to a batch of 2.

Tolerances: rtol 1e-5 and atol 1e-6 on float32 values, unless a case says
why not.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import numpyro_tpu.distributions.transforms as jt
from numpyro_tpu.distributions import constraints as jc
from numpyro_tpu_torch.distributions import constraints as tc
from numpyro_tpu_torch.distributions import transforms as tt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got, want = _np(got), np.asarray(want)
    if np.iscomplexobj(want) or np.iscomplexobj(got):
        assert np.iscomplexobj(got) and np.iscomplexobj(want), what
        _close(got.real, want.real, rtol, atol, what + " (real)")
        _close(got.imag, want.imag, rtol, atol, what + " (imag)")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _spd(rng, n, batch=()):
    a = rng.normal(size=batch + (n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _corr(rng, n, batch=()):
    cov = _spd(rng, n, batch).astype(np.float64)
    sd = np.sqrt(np.diagonal(cov, axis1=-2, axis2=-1))
    return (cov / (sd[..., :, None] * sd[..., None, :])).astype(np.float32)


# ---------------------------------------------------------------------------
# constraints


def _constraint_inputs(name, rng):
    """Feasible and infeasible values of each constraint, batch of 2 each."""
    eye = np.eye(3, dtype=np.float32)
    if name in ("corr_cholesky",):
        good = np.linalg.cholesky(_corr(rng, 3, (2,)))
        bad = good.copy()
        bad[0, 2, 1] += 0.3
        bad[1] = bad[1].T
        return [good, bad, np.stack([eye, -eye])]
    if name == "corr_matrix":
        good = _corr(rng, 3, (2,))
        bad = good.copy()
        bad[0, 0, 0] = 1.5
        bad[1, 0, 1] = 0.2
        return [good, bad, np.stack([eye, np.full((3, 3), 1.0, np.float32)])]
    if name in ("positive_semidefinite", "positive_definite"):
        good = _spd(rng, 3, (2,))
        singular = np.ones((3, 3), np.float32)
        return [good, np.stack([singular, -eye]), np.stack([good[0], good[1] + np.triu(eye, 1)])]
    if name == "softplus_lower_cholesky":
        good = np.linalg.cholesky(_spd(rng, 3, (2,)))
        return [good, np.stack([good[0].T, -good[1]])]
    if name == "positive_ordered_vector":
        return [np.array([[0.5, 1.0, 3.0, 7.0], [-0.5, 1.0, 3.0, 7.0]], np.float32),
                np.array([[1.0, 1.0, 3.0, 7.0], [0.1, 0.2, 0.3, 0.0]], np.float32)]
    if name.startswith("zero_sum"):
        x = rng.normal(size=(2, 3, 4)).astype(np.float32)
        one = x - x.mean(-1, keepdims=True)
        both = one - one.mean(-2, keepdims=True)
        return [one, both, x]
    if name == "complex":
        return [np.array([[1.0, np.nan, -2.0]], np.float32)]
    if name == "positive_definite_circulant_vector":
        return [np.array([[2.0, 0.7, 0.3, 0.7], [1.0, 0.8, 0.5, 0.8]], np.float32)]
    if name == "real_matrix":
        return [np.array([[[1.0, 2.0], [np.inf, 0.0]], [[0.0, 1.0], [2.0, 3.0]]], np.float32)]
    raise KeyError(name)


NEW_CONSTRAINTS = {
    "corr_cholesky": (tc.corr_cholesky, jc.corr_cholesky),
    "corr_matrix": (tc.corr_matrix, jc.corr_matrix),
    "positive_semidefinite": (tc.positive_semidefinite, jc.positive_semidefinite),
    "positive_definite": (tc.positive_definite, jc.positive_definite),
    "softplus_lower_cholesky": (tc.softplus_lower_cholesky, jc.softplus_lower_cholesky),
    "positive_ordered_vector": (tc.positive_ordered_vector, jc.positive_ordered_vector),
    "zero_sum(1)": (tc.zero_sum(1), jc.zero_sum(1)),
    "zero_sum(2)": (tc.zero_sum(2), jc.zero_sum(2)),
    "complex": (tc.complex, jc.complex),
    "positive_definite_circulant_vector": (tc.positive_definite_circulant_vector,
                                           jc.positive_definite_circulant_vector),
    "real_matrix": (tc.real_matrix, jc.real_matrix),
}


@pytest.mark.parametrize("name", list(NEW_CONSTRAINTS))
def test_constraint_matches_jax(name):
    c_t, c_j = NEW_CONSTRAINTS[name]
    assert c_t.event_dim == c_j.event_dim and c_t.is_discrete == c_j.is_discrete
    rng = np.random.default_rng(0)
    for x in _constraint_inputs(name.split("(")[0] if name.startswith("zero") else name, rng):
        got, want = c_t(_t(x)), np.asarray(c_j(jnp.asarray(x)))
        np.testing.assert_array_equal(_np(got), np.broadcast_to(want, _np(got).shape),
                                      err_msg=f"{name} on {x}")
        np.testing.assert_array_equal(_np(c_t.feasible_like(_t(x))),
                                      np.asarray(c_j.feasible_like(jnp.asarray(x))))
        assert bool(c_t(c_t.feasible_like(_t(x))).all())
    assert c_t == NEW_CONSTRAINTS[name][0] and hash(c_t) == hash(NEW_CONSTRAINTS[name][0])


def test_complex_constraint_takes_complex_tensors():
    z = torch.complex(_t([1.0, -2.0]), _t([0.5, 3.0]))
    assert bool(tc.complex(z).all())
    assert tc.zero_sum(1) != tc.zero_sum(2) and tc.zero_sum(2) == tc.zero_sum(2)


# ---------------------------------------------------------------------------
# transforms


def _rlt_matrix():
    return np.array([[0.5, 0.2], [-0.3, 0.8]], np.float32)


class Spec:
    """A transform of each package and how to make an input of its domain
    (a function of a numpy generator)."""

    def __init__(self, name, t_t, t_j, make_x, square=None, rtol=RTOL, atol=ATOL):
        self.name, self.t_t, self.t_j, self.make_x = name, t_t, t_j, make_x
        # (flatten the free coordinates of x, of y) where the map is square
        self.square = square
        self.rtol, self.atol = rtol, atol

    def __repr__(self):
        return self.name


def _normal(shape):
    return lambda rng: (0.5 * rng.normal(size=shape)).astype(np.float32)


def _simplex(rng):
    x = rng.normal(size=(2, 4))
    return (np.exp(x) / np.exp(x).sum(-1, keepdims=True)).astype(np.float32)


def _tril_vec(d, diagonal):
    rows, cols = np.tril_indices(d, diagonal)
    return lambda y: y[..., rows, cols]


def _identity(v):
    return v


SPECS = [
    Spec("OrderedTransform", tt.OrderedTransform(), jt.OrderedTransform(), _normal((2, 5)),
         square=(_identity, _identity)),
    Spec("SimplexToOrderedTransform", tt.SimplexToOrderedTransform(_t(0.3)),
         jt.SimplexToOrderedTransform(jnp.asarray(0.3, jnp.float32)), _simplex,
         square=(lambda x: x[..., :-1], _identity)),
    Spec("CorrCholeskyTransform", tt.CorrCholeskyTransform(), jt.CorrCholeskyTransform(),
         _normal((2, 6)), square=(_identity, _tril_vec(4, -1))),
    Spec("CholeskyTransform", tt.CholeskyTransform(), jt.CholeskyTransform(),
         lambda rng: _spd(rng, 3, (2,))),
    Spec("CorrMatrixCholeskyTransform", tt.CorrMatrixCholeskyTransform(),
         jt.CorrMatrixCholeskyTransform(), lambda rng: _corr(rng, 3, (2,))),
    Spec("SoftplusLowerCholeskyTransform", tt.SoftplusLowerCholeskyTransform(),
         jt.SoftplusLowerCholeskyTransform(), _normal((2, 6)),
         square=(_identity, _tril_vec(3, 0))),
    Spec("L1BallTransform", tt.L1BallTransform(), jt.L1BallTransform(), _normal((2, 4)),
         square=(_identity, _identity)),
    Spec("ZeroSumTransform(1)", tt.ZeroSumTransform(1), jt.ZeroSumTransform(1),
         _normal((2, 4))),
    Spec("ZeroSumTransform(2)", tt.ZeroSumTransform(2), jt.ZeroSumTransform(2),
         _normal((2, 3, 4))),
    Spec("ComplexTransform", tt.ComplexTransform(), jt.ComplexTransform(), _normal((2, 3, 2))),
    Spec("RealFastFourierTransform((8,))", tt.RealFastFourierTransform((8,)),
         jt.RealFastFourierTransform((8,)), _normal((2, 8))),
    Spec("RealFastFourierTransform((7,))", tt.RealFastFourierTransform(7),
         jt.RealFastFourierTransform(7), _normal((2, 7))),
    Spec("RealFastFourierTransform((4, 6), 2)", tt.RealFastFourierTransform((4, 6), 2),
         jt.RealFastFourierTransform((4, 6), 2), _normal((2, 4, 6))),
    Spec("PackRealFastFourierCoefficientsTransform((8,))",
         tt.PackRealFastFourierCoefficientsTransform((8,)),
         jt.PackRealFastFourierCoefficientsTransform((8,)), _normal((2, 8))),
    Spec("PackRealFastFourierCoefficientsTransform((7,))",
         tt.PackRealFastFourierCoefficientsTransform((7,)),
         jt.PackRealFastFourierCoefficientsTransform((7,)), _normal((2, 7))),
    # the doubling sums the terms of the recursion in another order than
    # JAX's scan: atol 1e-5 for entries that cancel towards 0
    Spec("RecursiveLinearTransform", tt.RecursiveLinearTransform(_t(_rlt_matrix())),
         jt.RecursiveLinearTransform(jnp.asarray(_rlt_matrix())), _normal((2, 13, 2)),
         square=(_identity, _identity), atol=1e-5),
]
IDS = [repr(s) for s in SPECS]


def _x(spec):
    return spec.make_x(np.random.default_rng(0))


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_transform_matches_jax(spec):
    x = _x(spec)
    y_t, y_j = spec.t_t(_t(x)), spec.t_j(jnp.asarray(x))
    _close(y_t, y_j, spec.rtol, spec.atol, "forward")
    y_np = np.asarray(y_j)
    y_in = (torch.from_numpy(y_np.copy()) if np.iscomplexobj(y_np) else _t(y_np))
    _close(spec.t_t.inv(y_in), spec.t_j.inv(y_j), spec.rtol, max(spec.atol, 1e-5), "inverse")
    # the log-determinant of a transform with a data-dependent Jacobian
    # accumulates float32 rounding over the event: atol 1e-5
    _close(spec.t_t.log_abs_det_jacobian(_t(x), y_t),
           spec.t_j.log_abs_det_jacobian(jnp.asarray(x), y_j), rtol=RTOL, atol=1e-5,
           what="log_abs_det_jacobian")
    assert spec.t_t.forward_shape(x.shape) == spec.t_j.forward_shape(x.shape) == tuple(y_t.shape)
    assert spec.t_t.inverse_shape(tuple(y_t.shape)) == spec.t_j.inverse_shape(y_j.shape) \
        == x.shape
    assert type(spec.t_t.domain).__name__ == type(spec.t_j.domain).__name__
    assert type(spec.t_t.codomain).__name__ == type(spec.t_j.codomain).__name__
    assert spec.t_t.domain.event_dim == spec.t_j.domain.event_dim
    assert spec.t_t.codomain.event_dim == spec.t_j.codomain.event_dim


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_round_trip_and_codomain(spec):
    x = _t(_x(spec))
    y = spec.t_t(x)
    if not y.is_complex():
        assert bool(spec.t_t.codomain(y).all()), spec
    _close(spec.t_t.inv(y), x.numpy(), rtol=1e-4, atol=1e-5, what="round trip")
    _close(spec.t_t.inv.log_abs_det_jacobian(y, x), -_np(spec.t_t.log_abs_det_jacobian(x, y)))
    assert spec.t_t == spec.t_t and spec.t_t.inv.inv is spec.t_t


SQUARE = [s for s in SPECS if s.square is not None]


@pytest.mark.parametrize("spec", SQUARE, ids=[repr(s) for s in SQUARE])
def test_log_det_equals_slogdet_of_the_autograd_jacobian(spec):
    """float64, one event at a time: the log-determinant against ``slogdet``
    of ``torch.func.jacfwd`` over the free coordinates (rtol 1e-6)."""
    x = torch.from_numpy(_x(spec).astype(np.float64))
    t = spec.t_t
    if isinstance(t, tt.RecursiveLinearTransform):
        t = tt.RecursiveLinearTransform(t.transition_matrix.double())
    if isinstance(t, tt.SimplexToOrderedTransform):
        t = tt.SimplexToOrderedTransform(t.anchor_point.double())
    free_x, free_y = spec.square
    for row in range(x.shape[0]):
        x0 = x[row]

        def fn(u):
            if isinstance(t, tt.SimplexToOrderedTransform):
                u = torch.cat([u, (1.0 - u.sum())[None]])
            return free_y(t(u.reshape(x0.shape) if u.shape != x0.shape else u)).reshape(-1)

        u0 = free_x(x0).reshape(-1)
        jac = torch.func.jacfwd(fn)(u0)
        want = torch.linalg.slogdet(jac).logabsdet
        got = t.log_abs_det_jacobian(x0, t(x0))
        _close(got, want.numpy(), rtol=1e-6, atol=1e-6, what=repr(spec))


def test_corr_cholesky_at_saturated_inputs_matches_jax():
    """|x| = 20 saturates tanh to 1 in float32: the forward map, inverse and
    log-determinant give the JAX package's values (and its NaN pattern),
    and the gradient of the log-determinant plus a sum of the factor is the
    JAX package's."""
    x = np.array([[20.0, -20.0, 0.3, 20.0, 1.0, -20.0], [0.5, 20.0, -0.2, -20.0, 20.0, 0.1]],
                 np.float32)
    t, t_j = tt.CorrCholeskyTransform(), jt.CorrCholeskyTransform()
    y_t, y_j = t(_t(x)), t_j(jnp.asarray(x))
    _close(y_t, y_j, what="forward")
    _close(t.inv(y_t), t_j.inv(y_j), what="inverse")
    _close(t.log_abs_det_jacobian(_t(x), y_t), t_j.log_abs_det_jacobian(jnp.asarray(x), y_j),
           atol=1e-5, what="log-det")

    def loss_j(v):
        return (t_j(v).sum() + t_j.log_abs_det_jacobian(v, t_j(v))).sum()

    def loss_t(v):
        return (t(v).sum() + t.log_abs_det_jacobian(v, t(v))).sum()

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(x)))
    g_t = torch.func.grad(loss_t)(_t(x))
    np.testing.assert_array_equal(np.isfinite(_np(g_t)), np.isfinite(g_j))
    _close(g_t, g_j, atol=1e-5, what="gradient")


def test_rfft_gradients_match_jax_in_both_modes():
    """A real loss through ``RealFastFourierTransform`` and the packed
    coefficients: PyTorch's complex autograd convention differs from JAX's,
    and the real end-to-end gradient agrees, in reverse and forward mode."""
    x = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)
    rfft_t, rfft_j = tt.RealFastFourierTransform((8,)), jt.RealFastFourierTransform((8,))
    pack_t = tt.PackRealFastFourierCoefficientsTransform((8,))
    pack_j = jt.PackRealFastFourierCoefficientsTransform((8,))

    def loss_j(v):
        z = rfft_j(v)
        return (jnp.abs(z) ** 2 * w).sum() + (pack_j.inv(z) ** 3).sum()

    def loss_t(v):
        z = rfft_t(v)
        return (z.abs().square() * _t(w)).sum() + (pack_t.inv(z) ** 3).sum()

    _close(torch.func.grad(loss_t)(_t(x)), jax.grad(loss_j)(jnp.asarray(x)), rtol=1e-5,
           atol=1e-4)
    tangent = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    _, t_t = torch.func.jvp(loss_t, (_t(x),), (_t(tangent),))
    _, t_j = jax.jvp(loss_j, (jnp.asarray(x),), (jnp.asarray(tangent),))
    _close(t_t, t_j, rtol=1e-4, atol=1e-3)


def test_recursive_linear_transform_batched_matrix_matches_jax():
    """A batched transition matrix and a long series (T = 100): the doubling
    against JAX's scan, at rtol 1e-4 (the terms of 100 steps summed in
    another order)."""
    rng = np.random.default_rng(5)
    a = (0.45 * rng.normal(size=(3, 2, 2))).astype(np.float32)
    x = rng.normal(size=(3, 100, 2)).astype(np.float32)
    y_t = tt.RecursiveLinearTransform(_t(a))(_t(x))
    y_j = jt.RecursiveLinearTransform(jnp.asarray(a))(jnp.asarray(x))
    _close(y_t, y_j, rtol=1e-4, atol=1e-5)
    _close(tt.RecursiveLinearTransform(_t(a)).inv(y_t), x, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# biject_to


def _structure(t):
    name = type(t).__name__
    if name == "_InverseTransform":
        return ("inv", _structure(t._transform))
    if name == "ComposeTransform":
        return ("compose",) + tuple(_structure(p) for p in t.parts)
    if name == "IndependentTransform":
        return ("independent", _structure(t.base_transform), t.reinterpreted_batch_ndims)
    return name


def _jax_table_keys():
    """The constraint types of the JAX package's built-in table (its live
    registry also holds rows that other modules add when imported, such as
    ``contrib.tfp``'s)."""
    keys = []
    for targets, _ in jt._BUILTIN_BIJECTIONS:
        for c in targets if isinstance(targets, tuple) else (targets,):
            keys.append((c if isinstance(c, type) else type(c)).__name__)
    return sorted(set(keys))


def test_biject_to_table_is_jax_row_for_row():
    assert sorted(k.__name__ for k in tt.biject_to._registry) == _jax_table_keys()


# the constraints of tests/test_transforms_suite.py's biject_to table
ROWS = {
    "real": ((), "real"), "positive": ((), "positive"), "nonnegative": ((), "nonnegative"),
    "unit_interval": ((), "unit_interval"), "circular": ((), "circular"),
    "simplex": ((4,), "simplex"), "ordered_vector": ((5,), "ordered_vector"),
    "positive_ordered_vector": ((5,), "positive_ordered_vector"),
    "real_vector": ((4,), "real_vector"), "corr_cholesky": ((3, 3), "corr_cholesky"),
    "corr_matrix": ((3, 3), "corr_matrix"), "lower_cholesky": ((3, 3), "lower_cholesky"),
    "scaled_unit_lower_cholesky": ((3, 3), "scaled_unit_lower_cholesky"),
    "positive_definite": ((3, 3), "positive_definite"),
    "positive_semidefinite": ((3, 3), "positive_semidefinite"),
    "softplus_positive": ((), "softplus_positive"),
    "softplus_lower_cholesky": ((3, 3), "softplus_lower_cholesky"),
    "l1_ball": ((4,), "l1_ball"),
}
PARAMETRIC = {
    "interval": ((), lambda m: m.interval(-2.0, 5.0)),
    "greater_than": ((), lambda m: m.greater_than(1.5)),
    "less_than": ((), lambda m: m.less_than(-0.5)),
    "zero_sum(1)": ((4,), lambda m: m.zero_sum(1)),
    "zero_sum(2)": ((3, 4), lambda m: m.zero_sum(2)),
}


def _row(name):
    if name in ROWS:
        shape, attr = ROWS[name]
        return shape, getattr(tc, attr), getattr(jc, attr)
    shape, make = PARAMETRIC[name]
    return shape, make(tc), make(jc)


@pytest.mark.parametrize("name", list(ROWS) + list(PARAMETRIC))
def test_biject_to_row_matches_jax(name):
    shape, c_t, c_j = _row(name)
    t, t_j = tt.biject_to(c_t), jt.biject_to(c_j)
    assert _structure(t) == _structure(t_j)
    u_shape = (2,) + tuple(t_j.inverse_shape(shape) if shape else ())
    u = np.random.default_rng(6).normal(size=u_shape).astype(np.float32)
    y_t, y_j = t(_t(u)), t_j(jnp.asarray(u))
    _close(y_t, y_j, atol=1e-5, what="forward")
    assert bool(c_t(y_t).all())
    _close(t.log_abs_det_jacobian(_t(u), y_t), t_j.log_abs_det_jacobian(jnp.asarray(u), y_j),
           atol=1e-5, what="log-det")
    # positive (semi)definite round trips pass through a Cholesky factor
    # and its product: 1e-4
    _close(t.inv(y_t), u, rtol=1e-4, atol=1e-4, what="round trip")


def test_sphere_has_no_row_and_raises_as_jax():
    for registry, constraint in ((tt.biject_to, tc.sphere), (jt.biject_to, jc.sphere)):
        with pytest.raises(NotImplementedError, match="^Cannot transform _Sphere constraint$"):
            registry(constraint)


@pytest.mark.parametrize("name", ["corr_cholesky", "corr_matrix"])
def test_biject_to_corr_at_jax_init_points(name):
    """``init_to_uniform``'s points (uniform in (-2, 2)) and a saturated one
    (|u| = 20): the potential's pieces, the constrained value and the
    log-determinant, are JAX's; finite at the init points."""
    shape, c_t, c_j = _row(name)
    t, t_j = tt.biject_to(c_t), jt.biject_to(c_j)
    u = np.random.default_rng(7).uniform(-2.0, 2.0, size=(16, 3)).astype(np.float32)
    u = np.concatenate([u, np.array([[20.0, -20.0, 20.0]], np.float32)])
    y_t, y_j = t(_t(u)), t_j(jnp.asarray(u))
    ld_t = t.log_abs_det_jacobian(_t(u), y_t)
    ld_j = t_j.log_abs_det_jacobian(jnp.asarray(u), y_j)
    assert bool(torch.isfinite(ld_t[:16]).all() and torch.isfinite(y_t[:16]).all())
    np.testing.assert_array_equal(np.isfinite(_np(ld_t)), np.isfinite(np.asarray(ld_j)))
    _close(y_t, y_j, atol=1e-5)
    finite = np.isfinite(np.asarray(ld_j))
    _close(_np(ld_t)[finite], np.asarray(ld_j)[finite], rtol=1e-5, atol=1e-4)


def test_stick_budget_is_a_product_over_columns():
    """``CorrCholeskyTransform``'s stick budget is a product over columns,
    not ``torch.cumprod``, whose backward reads on the host whether a factor
    is 0: the values and the gradient at a zero factor are the product
    rule's."""
    v = _t([[2.0, 0.0, 3.0, 5.0]]).requires_grad_()
    budget = tt._exclusive_cumprod(v)
    _close(budget, [[1.0, 2.0, 0.0, 0.0]])
    budget.sum().backward()
    _close(v.grad, [[1.0, 8.0, 0.0, 0.0]])
    assert math.isclose(float(tt._exclusive_cumprod(_t([[4.0]]))[0, 0]), 1.0)
