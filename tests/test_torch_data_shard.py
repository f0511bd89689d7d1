"""The tag of a data shard's rows carried through ops
(``numpyro_tpu_torch/parallel/data_shard.py``), in one process.

The rows here are a partial ``DataShard`` with no process group: a tensor
tagged as rows ``[start, stop)`` of a longer data set, whose sums over the
rows stay this process's partial sums (there is no group to add them over).
The tests hold which ops keep the tag and where, which give a plain sum, and
which raise and with what message; then a model written for the whole data,
run on two such halves, whose two potentials and gradients add up to the
JAX package's on all rows (potential rtol 1e-5, gradient rtol 1e-4 and atol
1e-4 of its largest component, as ``test_torch_hmc_gibbs.py`` holds one
transition).  The collectives themselves run in the multi-process jobs of
``test_torch_parallel.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import numpyro_tpu
import numpyro_tpu.distributions as jdist
from numpyro_tpu.infer.util import potential_energy as jpotential
import numpyro_tpu_torch as npt
import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.parallel.data_shard import (
    DataShard, DataShardTensor, distribution_shard, local_draws, local_rows, shard_of,
)

ROWS, SIZE, D = 10, 25, 3


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((SIZE, D)).astype(np.float32)
    y = (rng.random(SIZE) < 0.5).astype(np.float32)
    return X, y


def _rows(start=0, stop=ROWS, seed=0):
    """Rows ``[start, stop)`` of ``_data`` as tagged X and y, and the plain
    rows."""
    X, y = (torch.from_numpy(a[start:stop]) for a in _data(seed))
    shard = DataShard(start, stop, 0, None, SIZE)
    return DataShardTensor(X, shard, -2), DataShardTensor(y, shard, -1), X, y


W = torch.tensor([0.3, -0.2, 0.5])

KEEPS = {
    # op on (X, y): the tagged axis of the result
    "float": (lambda X, y: y.float(), -1),
    "to_double": (lambda X, y: X.to(torch.float64), -2),
    "add_scalar": (lambda X, y: y + 1.0, -1),
    "exp": (lambda X, y: torch.exp(X), -2),
    "where": (lambda X, y: torch.where(y > 0.5, y, -y), -1),
    "columns": (lambda X, y: X[:, :2], -2),
    "one_column": (lambda X, y: X[:, 0], -1),
    "new_axis": (lambda X, y: y[..., None], -2),
    "matmul_vector": (lambda X, y: X @ W, -1),
    "matmul_matrix": (lambda X, y: X @ torch.ones(D, 4), -2),
    "transpose": (lambda X, y: X.T, -1),
    "sum_columns": (lambda X, y: X.sum(-1), -1),
    "logsumexp_columns": (lambda X, y: torch.logsumexp(X, -1), -1),
    "reshape": (lambda X, y: X.reshape(ROWS, D, 1), -3),
    "unsqueeze_front": (lambda X, y: X.unsqueeze(0), -2),
    "expand": (lambda X, y: y.expand(4, ROWS), -1),
    "stack": (lambda X, y: torch.stack([y, y]), -1),
    "cat_columns": (lambda X, y: torch.cat([X, X], 1), -2),
    "broadcast_replicated": (lambda X, y: X * torch.ones(4, 1, D), -2),
    "softplus": (lambda X, y: torch.nn.functional.softplus(X @ W), -1),
    "log_prob": (lambda X, y: dist.Bernoulli(logits=X @ W).log_prob(y), -1),
    "index_by_rows": (lambda X, y: torch.arange(5.0)[y.long()], -1),
    # elementwise ops of the densities, each read off its run on meta tensors
    "logsigmoid": (lambda X, y: torch.nn.functional.logsigmoid(X @ W), -1),
    "lgamma": (lambda X, y: torch.lgamma(X.abs() + 1.0), -2),
    "digamma": (lambda X, y: torch.digamma(y + 1.0), -1),
    "polygamma": (lambda X, y: torch.polygamma(1, y + 1.0), -1),
    "xlogy": (lambda X, y: torch.xlogy(y, torch.sigmoid(X @ W)), -1),
    "log1p_expm1": (lambda X, y: torch.log1p(torch.expm1(X)), -2),
    "clamp_tensor": (lambda X, y: X.clamp(min=torch.zeros(D)), -2),
    "masked_fill": (lambda X, y: X.masked_fill(X > 0.0, 0.0), -2),
    "log_ndtr": (lambda X, y: torch.special.log_ndtr(X), -2),
    "type_as": (lambda X, y: y.type_as(torch.zeros((), dtype=torch.float64)), -1),
    "pow_replicated": (lambda X, y: torch.pow(W.abs(), X), -2),
    "full_like": (lambda X, y: torch.full_like(y, 2.0), -1),
    # moves, which meta tensors cannot make
    "cpu": (lambda X, y: X.cpu(), -2),
    "to_device": (lambda X, y: y.to("cpu", torch.float64), -1),
}


@pytest.mark.parametrize("name", list(KEEPS))
def test_ops_along_other_axes_keep_the_tag(name):
    Xs, ys, X, y = _rows()
    op, axis = KEEPS[name]
    got = op(Xs, ys)
    assert isinstance(got, DataShardTensor) and got._axis == axis
    assert got.data_shard.axis == got.dim() + axis
    assert got.shape[axis] == ROWS
    torch.testing.assert_close(local_rows(got), op(X, y), rtol=0, atol=0)


SUMS = {
    "sum": (lambda X, y: y.sum(), lambda X, y: y.sum()),
    "sum_rows": (lambda X, y: X.sum(0), lambda X, y: X.sum(0)),
    "mean": (lambda X, y: y.mean(), lambda X, y: y.sum() / SIZE),
    "mean_rows": (lambda X, y: X.mean(0), lambda X, y: X.sum(0) / SIZE),
    "contraction": (lambda X, y: X.T @ y, lambda X, y: X.T @ y),
    "count_nonzero": (lambda X, y: torch.count_nonzero(y), lambda X, y: torch.count_nonzero(y)),
    "any": (lambda X, y: (y > 0.5).any(), lambda X, y: (y > 0.5).any()),
    "all": (lambda X, y: (y > -1.0).all(), lambda X, y: (y > -1.0).all()),
}


@pytest.mark.parametrize("name", list(SUMS))
def test_sums_over_the_rows_lose_the_tag(name):
    """A sum over the rows is the group's sum of the partial ones: with no
    group, this process's partial sum; a mean divides by the whole data's
    count."""
    Xs, ys, X, y = _rows()
    op, want = SUMS[name]
    got = op(Xs, ys)
    assert not isinstance(got, DataShardTensor)
    torch.testing.assert_close(got, want(X, y))


RAISES = {
    "row_slice": lambda X, y: X[:3],
    "row_slice_from": lambda X, y: y[1:],
    "row": lambda X, y: X[0],
    "cat_rows": lambda X, y: torch.cat([y, y]),
    "sort": lambda X, y: y.sort(),
    "argsort": lambda X, y: torch.argsort(y, 0),
    "cumsum": lambda X, y: y.cumsum(0),
    "flip": lambda X, y: torch.flip(X, [0]),
    "softmax_rows": lambda X, y: torch.softmax(X, 0),
    "max": lambda X, y: y.max(),
    "logsumexp_rows": lambda X, y: torch.logsumexp(y, 0),
    "pairwise": lambda X, y: y[:, None] - y[None, :],
    "select_by_value": lambda X, y: X[y > 0.5],
    "index_select_rows": lambda X, y: torch.index_select(y, 0, torch.tensor([0, 2])),
    "local_count": lambda X, y: y + torch.ones(ROWS),
    "tolist": lambda X, y: y.tolist(),
    "numpy": lambda X, y: y.numpy(),
    "item": lambda X, y: y[..., :1].sum(-1).item(),
    "draw": lambda X, y: torch.bernoulli(torch.sigmoid(y)),
    "write_untagged": lambda X, y: torch.zeros(ROWS).copy_(y),
    "flatten_rows": lambda X, y: X.reshape(-1),
}


@pytest.mark.parametrize("name", list(RAISES))
def test_ops_that_cut_reorder_or_mix_the_rows_raise(name):
    Xs, ys, _, _ = _rows()
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        RAISES[name](Xs, ys)
    assert "rows of a data shard" in str(e.value)


# a slice that keeps the rows and one of the same form that cuts them, in
# the order they run, twice over: the probe of one never answers for the
# other
SAME_FORM = {
    "new_axis_then_row_slice": ("keep", lambda X, y: y[:, None], lambda X, y: y[:3, None]),
    "column_then_row_slice": ("keep", lambda X, y: X[:, 0], lambda X, y: X[:5, 0]),
    "row_slice_then_column": ("cut", lambda X, y: X[:5, 0], lambda X, y: X[:, 0]),
    "tensor_bound": ("keep", lambda X, y: X[:, :torch.tensor(2)],
                     lambda X, y: X[:torch.tensor(2)]),
}


@pytest.mark.parametrize("name", list(SAME_FORM))
def test_a_row_slice_is_never_taken_for_a_slice_of_the_same_form(name):
    Xs, ys, X, y = _rows()
    first, op_a, op_b = SAME_FORM[name]
    keep, cut = (op_a, op_b) if first == "keep" else (op_b, op_a)
    for op in (op_a, op_b) * 2:
        if op is cut:
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                op(Xs, ys)
        else:
            got = op(Xs, ys)
            assert isinstance(got, DataShardTensor) and got.shape[got._axis] == ROWS
            torch.testing.assert_close(local_rows(got), keep(X, y), rtol=0, atol=0)


# draws at a sample site over the rows (under ``local_draws``), each row
# from its own parameters: the tag's axis of the result, or None where the
# draw runs across the rows and raises
DRAWS = {
    "bernoulli": (lambda X, y: torch.bernoulli(torch.sigmoid(X @ W)), -1),
    "normal": (lambda X, y: torch.normal(X, 1.0), -2),
    "standard_gamma": (lambda X, y: torch._standard_gamma(X.abs() + 1.0), -2),
    "dirichlet": (lambda X, y: torch._sample_dirichlet(X.abs() + 1.0), -2),
    "multinomial_per_row": (lambda X, y: torch.multinomial(X.abs() + 0.1, 2), -2),
    "multinomial_over_rows": (lambda X, y: torch.multinomial(y + 0.1, 2), None),
}


@pytest.mark.parametrize("name", list(DRAWS))
def test_a_draw_at_a_site_over_the_rows_keeps_their_axis(name):
    Xs, ys, _, _ = _rows()
    op, axis = DRAWS[name]
    with local_draws():
        if axis is None:
            with pytest.raises(NotImplementedError, match="draws across the rows"):
                op(Xs, ys)
            return
        got = op(Xs, ys)
    assert isinstance(got, DataShardTensor) and got._axis == axis
    assert got.shape[axis] == ROWS


def test_rows_of_two_shards_do_not_mix():
    Xs, _, _, _ = _rows(0, ROWS)
    _, ys, _, _ = _rows(ROWS, 2 * ROWS)
    with pytest.raises(ValueError, match="two data shards"):
        Xs @ W + ys


def test_the_tag_keeps_its_rows_in_place_and_passes_through_torch_func():
    """Shapes are the rank's; the tag's axis counts from the right, so a
    ``vmap`` and a ``grad`` around the ops leave it in place."""
    Xs, ys, X, y = _rows()
    assert Xs.shape == (ROWS, D) and len(ys) == ROWS and Xs.data_shard.size == SIZE
    assert shard_of(Xs) is Xs._shard and shard_of(X) is None and local_rows(X) is X

    def f(w):
        logits = Xs @ w
        assert isinstance(logits, DataShardTensor) and logits._axis == -1
        return dist.Bernoulli(logits=logits).log_prob(ys).sum()

    def plain(w):
        return dist.Bernoulli(logits=X @ w).log_prob(y).sum()

    ws = torch.stack([W, -W, 2 * W])
    g, v = torch.func.vmap(torch.func.grad_and_value(f))(ws)
    g0, v0 = torch.func.vmap(torch.func.grad_and_value(plain))(ws)
    assert not isinstance(v, DataShardTensor)
    torch.testing.assert_close(v, v0)
    torch.testing.assert_close(g, g0)
    jac = torch.func.vmap(torch.func.jacfwd(f))(ws)
    torch.testing.assert_close(jac, g0)


def test_a_distribution_over_the_rows_is_found():
    Xs, ys, _, _ = _rows()
    fn = dist.Normal(Xs @ W, 1.0).to_event(1)
    assert distribution_shard(fn) is Xs._shard
    assert distribution_shard(dist.Normal(0.0, 1.0)) is None


def _model(n):
    def model(X, y):
        w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
        with npt.plate("N", n):
            npt.sample("y", dist.Bernoulli(logits=X @ w), obs=y)

    return model


def test_a_plate_over_the_rows_has_the_whole_size():
    """A plate of the whole size takes the rank's rows as its rows; one of
    the rank's own count raises; ``subsample`` returns the rows tagged."""
    Xs, ys, _, _ = _rows()
    tr = handlers.trace(handlers.seed(_model(SIZE), 0)).get_trace(Xs, ys)
    assert tr["y"]["fn"].batch_shape == (ROWS,) and isinstance(tr["y"]["value"],
                                                                 DataShardTensor)
    with pytest.raises(ValueError, match="give the plate the whole data's size"):
        handlers.seed(_model(Xs.shape[0]), 0)(Xs, ys)
    assert isinstance(npt.subsample(Xs, event_dim=1), DataShardTensor)

    def subsampled(X):
        with npt.plate("N", SIZE):
            return npt.subsample(X, event_dim=1)

    assert handlers.seed(subsampled, 0)(Xs) is Xs


def test_a_latent_over_the_rows_raises():
    """A latent a row would be each rank's own: the init search's draw of
    it raises, and so does a trace that holds one."""
    Xs, _, _, _ = _rows()

    def model(X):
        w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
        with npt.plate("N", SIZE):
            npt.sample("z", dist.Normal(X @ w, 1.0))

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        infer_util.initialize_model(torch.Generator().manual_seed(0), model,
                                    model_args=(Xs,))
    seeded = handlers.seed(model, 0)
    with pytest.raises(NotImplementedError, match="latent site 'z'"):
        infer_util.get_transforms(seeded, (Xs,), {})


def test_log_likelihood_keeps_each_rows_term_tagged():
    Xs, ys, X, y = _rows()
    ws = {"w": torch.stack([W, -W])}
    got = infer_util.log_likelihood(_model(SIZE), ws, Xs, ys)["y"]
    want = infer_util.log_likelihood(_model(ROWS), ws, X, y)["y"]
    assert isinstance(got, DataShardTensor) and got.shape == (2, ROWS) and got._axis == -1
    torch.testing.assert_close(local_rows(got), want, rtol=0, atol=0)


def test_two_halves_add_up_to_the_jax_packages_whole_data_potential():
    """The model written for the whole data, run on the rows of each half
    (its prior counted once): the two potentials and gradients add up to
    the JAX package's on all rows."""
    X, y = _data(1)
    ws = np.stack([W.numpy(), -W.numpy(), 2 * W.numpy()])
    model = _model(SIZE)
    halves = [_rows(0, 12, seed=1), _rows(12, SIZE, seed=1)]
    parts = []
    for Xs, ys, _, _ in halves:

        def pe(z, Xs=Xs, ys=ys):
            return infer_util.potential_energy(model, (Xs, ys), {}, z)

        parts.append(infer_util.batched_value_and_grad(pe)({"w": torch.from_numpy(ws)}))
    prior = 0.5 * (ws**2).sum(-1) + 1.5 * np.log(2 * np.pi)
    pe_t = parts[0][0].numpy() + parts[1][0].numpy() - prior
    g_t = parts[0][1]["w"].numpy() + parts[1][1]["w"].numpy() - ws

    def jax_model(X, y):
        wv = numpyro_tpu.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
        with numpyro_tpu.plate("N", SIZE):
            numpyro_tpu.sample("y", jdist.Bernoulli(logits=X @ wv), obs=y)

    value, grad = jax.vmap(jax.value_and_grad(
        lambda v: jpotential(jax_model, (jnp.asarray(X), jnp.asarray(y)), {}, {"w": v})))(
            jnp.asarray(ws))
    np.testing.assert_allclose(pe_t, np.asarray(value), rtol=1e-5)
    g_j = np.asarray(grad)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-4 * np.abs(g_j).max())


def test_a_draw_over_the_rows_takes_a_generator_of_its_own():
    """``Predictive`` of one draw over the rows: the site's generator moves
    by one draw whatever the rank's row count; inside a ``vmap`` (more
    than one draw) such a draw raises."""
    Xs, ys, _, _ = _rows()

    def model(X, y=None):
        w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
        with npt.plate("N", SIZE):
            return npt.sample("y", dist.Bernoulli(logits=X @ w), obs=y)

    states = []
    for X in (Xs, _rows(0, 4)[0]):
        g = torch.Generator().manual_seed(3)
        out = handlers.seed(handlers.substitute(model, data={"w": W}), g)(X)
        assert isinstance(out, DataShardTensor) and out.shape == (X.shape[0],)
        states.append(g.get_state())
    assert torch.equal(states[0], states[1])
    pred = infer_util.Predictive(model, posterior_samples={"w": torch.stack([W, W])},
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="inside a torch.func transform"):
        pred(torch.Generator().manual_seed(0), Xs)
