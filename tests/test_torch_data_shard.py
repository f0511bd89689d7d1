"""The tag of a data shard's rows carried through ops
(``numpyro_tpu_torch/parallel/data_shard.py``), in one process.

Two kinds of rows here.  A partial ``DataShard`` with no process group: a
tensor tagged as rows ``[start, stop)`` of a longer data set, whose sums
over the rows stay this process's partial sums (there is no group to add
them over); the tests hold which ops keep the tag and where, which give a
plain sum, and which raise and with what message; then a model written for
the whole data, run on two such halves, whose two potentials and gradients
add up to the JAX package's on all rows (potential rtol 1e-5, gradient rtol
1e-4 and atol 1e-4 of its largest component, as ``test_torch_hmc_gibbs.py``
holds one transition).  And the two uneven halves of the data (12 and 13 of
25 rows) held by two thread ranks of a data group (:class:`ThreadRanks`:
``torch.distributed.all_reduce`` over that group sums, or takes the
maximum, of the threads' tensors; the threads take turns, switching at each
collective, each with its own handler stack; ``torch_thread_ranks.py``),
for the ops that gather the
rows, cut a whole tensor to them or take collectives of their own: each
rank's result equals the op on the whole data, cut to the rank's rows where
it keeps them, bit for bit for gathers, slices, sorts, extrema and draws,
to rtol 1e-6 for ``logsumexp``, ``softmax`` and ``cumsum`` (their sums add
the ranks' partial sums), and gradients to the same.  The collectives of
real process groups run in the multi-process jobs of
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
from numpyro_tpu_torch.infer.initialization import init_to_median, init_to_sample
from numpyro_tpu_torch.parallel.data_shard import (
    DataShard, DataShardTensor, distribution_shard, local_rows, shard_of, whole,
    whole_distribution,
)

from torch_thread_ranks import patch_all_reduce

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


@pytest.fixture
def thread_group(monkeypatch):
    """A :class:`ThreadRanks` group of two ranks and ``all_reduce`` over it."""
    return patch_all_reduce(monkeypatch)


HALVES = ((0, 12), (12, SIZE))  # the uneven rows of the two thread ranks


def _rank_rows(group, rank, seed=0):
    """Rank ``rank``'s rows of ``_data`` as tagged X and y on ``group``."""
    start, stop = HALVES[rank]
    X, y = (torch.from_numpy(a[start:stop]) for a in _data(seed))
    shard = DataShard(start, stop, 0, group, SIZE)
    return DataShardTensor(X, shard, -2), DataShardTensor(y, shard, -1)


def _whole_data(seed=0):
    return tuple(torch.from_numpy(a) for a in _data(seed))


def _as_on_whole(got, want, rank, rtol=0.0):
    """A rank's result against the op on the whole data: the rank's rows of
    it where the result keeps the tag, all of it where it does not."""
    if isinstance(got, DataShardTensor):
        start, stop = HALVES[rank]
        assert got.shape[got._axis] == stop - start
        want = want.narrow(got._axis, start, stop - start)
        got = local_rows(got)
    if isinstance(got, torch.Tensor):
        assert type(got) is torch.Tensor and got.shape == want.shape
        if rtol:
            torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * want.abs().max())
        else:
            assert torch.equal(got, want)
    elif isinstance(got, tuple):
        for g, w in zip(got, want):
            _as_on_whole(g, w, rank, rtol)
    else:
        assert got == want


RAISES = {
    "local_count": lambda X, y: y + torch.ones(ROWS),
    "draw": lambda X, y: torch.bernoulli(torch.sigmoid(y)),
    "write_untagged": lambda X, y: torch.zeros(ROWS).copy_(y),
}


@pytest.mark.parametrize("name", list(RAISES))
def test_ops_that_cut_reorder_or_mix_the_rows_raise(name):
    """What has no counterpart in the JAX package: an untagged tensor of the
    rank's own row count (JAX gives a shape error), a draw on torch's global
    generator (every JAX draw takes a key), an in-place write of the rows
    into an untagged tensor (JAX's arrays are immutable)."""
    Xs, ys, _, _ = _rows()
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        RAISES[name](Xs, ys)
    assert "rows of a data shard" in str(e.value)


PERM = torch.from_numpy(np.random.default_rng(5).permutation(SIZE))
E_WHOLE = torch.from_numpy(np.random.default_rng(6).standard_normal(SIZE).astype(np.float32))


def _set_rows(X, y):
    z = y * 1.0
    z[2:5] = -1.0
    return z


def _cumsum_in_place(X, y):
    z = X * 1.0
    z.cumsum_(0)
    return z


COMPUTES = {
    # op on (X, y), held against the op on the whole data; the ids of the
    # first 18 name the ops that raised while the rows could not be gathered
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
    "tolist": lambda X, y: y.tolist(),
    "numpy": lambda X, y: y.numpy().tolist(),
    "item": lambda X, y: y[..., :1].sum(-1).item(),
    "flatten_rows": lambda X, y: X.reshape(-1),
    # the reductions' collectives
    "max_rows": lambda X, y: X.max(0),
    "min_rows_keepdim": lambda X, y: X.min(0, keepdim=True),
    "amax_rows": lambda X, y: X.abs().amax(0),
    "amin_all": lambda X, y: torch.amin(X),
    "argmax_flat": lambda X, y: X.argmax(),
    "argmin_rows": lambda X, y: torch.argmin(X, 0),
    "logsumexp_all": lambda X, y: torch.logsumexp(X, (0, 1)),
    "log_softmax_rows": lambda X, y: torch.nn.functional.log_softmax(X, dim=0),
    "cumsum_matrix": lambda X, y: torch.cumsum(X, dim=0),
    "cumsum_in_place": _cumsum_in_place,
    # gathers
    "sort_matrix": lambda X, y: X.sort(0).values,
    "std_rows": lambda X, y: X.std(0),
    "topk_rows": lambda X, y: y.topk(3),
    "permute_rows": lambda X, y: X[PERM],
    "set_rows": _set_rows,
    "iterate": lambda X, y: [float(v) for v in y],
    # a whole tensor meets the rows: cut
    "add_whole": lambda X, y: y + E_WHOLE,
    "contract_whole": lambda X, y: X.T @ E_WHOLE,
    "where_whole": lambda X, y: torch.where(y > 0.5, E_WHOLE, -E_WHOLE),
    "whole_by_rows": lambda X, y: E_WHOLE[:, None] * y[None, :],
    "whole_at_rows": lambda X, y: E_WHOLE[PERM[:SIZE // 2]] * y[:3].sum(),
    "whole_indexed_by_rows": lambda X, y: torch.gather(E_WHOLE, 0, (y * 7).long()),
    "write_whole": lambda X, y: _write_whole(X),
    # ops that take or write the rows by the whole data's positions
    "index_put_rows": lambda X, y: torch.index_put(y, (PERM[:4],), torch.ones(4)),
    "scatter_rows": lambda X, y: torch.scatter(X, 0, PERM[:6].reshape(2, 3), -X[:2]),
    "index_add_rows": lambda X, y: y.index_add(0, PERM[:5], torch.arange(5.0)),
    "gather_rows": lambda X, y: torch.gather(X, 0, PERM[:4, None].expand(4, D)),
    "take_along_rows": lambda X, y: torch.take_along_dim(y, PERM[:7], 0),
    "take": lambda X, y: torch.take(X, PERM[:5] * 2),
    "index_fill_in_place": lambda X, y: (y * 1.0).index_fill_(0, PERM[:3], 9.0),
    "gather_columns": lambda X, y: torch.gather(X, 1, (y[:, None] > 0.5).long()),
}


def _write_whole(X):
    z = X * 1.0
    z[:, 1] = E_WHOLE
    return z
ROUNDED = ("cumsum", "softmax_rows", "logsumexp_rows", "logsumexp_all", "log_softmax_rows",
           "cumsum_matrix", "cumsum_in_place", "std_rows", "contract_whole")


@pytest.mark.parametrize("name", list(COMPUTES))
def test_ops_that_cut_reorder_or_mix_the_rows_run_on_the_whole_rows(thread_group, name):
    """Each rank's result equals the op on the whole data (cut to the rank's
    rows where it keeps them), as the JAX package's global array gives it."""
    op = COMPUTES[name]
    want = op(*_whole_data())
    got = thread_group.run(lambda r: op(*_rank_rows(thread_group, r)))
    for rank, g in enumerate(got):
        _as_on_whole(g, want, rank, rtol=1e-6 if name in ROUNDED else 0.0)


GRADS = {
    # f(X, y, w, e) with w (D,) and e (SIZE,) every rank holds alike
    "cut": lambda X, y, w, e: (torch.sigmoid(X @ w + 0.7 * e) * y).sum(),
    "gather": lambda X, y, w, e: ((X @ w)[2:] * (X @ w)[:-2]).sum() + (e[1:] * y[:-1]).sum(),
    "logsumexp": lambda X, y, w, e: torch.logsumexp(X @ w + e, 0),
    "max": lambda X, y, w, e: (X @ w).max() - (X @ w + e).amin(),
    # y is 0 or 1: both ranks hold rows at the extremum, whose derivative
    # one process shares among its ties (max(dim)'s values: to its index)
    "max_tied": lambda X, y, w, e: ((y * w[0]).max() + (y[:, None] * w).amax(0).sum()
                                    + (y[:, None] * w).min(0).values.sum()
                                    + (y * e[:1]).max()),
    "softmax": lambda X, y, w, e: (torch.softmax(X @ w + e, 0) * y).sum(),
    "cumsum": lambda X, y, w, e: (torch.cumsum(X @ w + e, 0) ** 2).sum() / SIZE,
}


@pytest.mark.parametrize("name", list(GRADS))
def test_gradients_through_the_rules_are_the_whole_datas(thread_group, name):
    """The value and the gradient in ``w`` and ``e`` at three points, under
    ``vmap`` of ``grad_and_value``, on each rank against the same function
    of the whole data: the gradient of ``e`` is whole on every rank (rtol
    1e-5, atol 1e-6).  Forward mode keeps its levels in one table for the
    process, which thread ranks taking turns would interleave: the
    four-rank job of ``test_torch_parallel.py`` holds it."""
    f = GRADS[name]
    rng = np.random.default_rng(7)
    W = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32))
    E = torch.from_numpy(rng.standard_normal((3, SIZE)).astype(np.float32))

    def value_and_grad(X, y):
        fn = lambda w, e: f(X, y, w, e)  # noqa: E731 - the rows ride in the closure
        g, v = torch.func.vmap(torch.func.grad_and_value(fn, argnums=(0, 1)))(W, E)
        return v, g[0], g[1]

    want = value_and_grad(*_whole_data())
    for got in thread_group.run(lambda r: value_and_grad(*_rank_rows(thread_group, r))):
        for g, w in zip(got, want):
            assert type(g) is torch.Tensor and g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


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
def test_a_row_slice_is_never_taken_for_a_slice_of_the_same_form(thread_group, name):
    """The slice that keeps the rows keeps the tag; the row slice runs on
    the whole rows and gives the whole data's slice, untagged."""
    first, op_a, op_b = SAME_FORM[name]
    keep, cut = (op_a, op_b) if first == "keep" else (op_b, op_a)

    def run(rank):
        Xs, ys = _rank_rows(thread_group, rank)
        return [(op is keep, op(Xs, ys)) for op in (op_a, op_b) * 2]

    whole_data = _whole_data()
    for rank, results in enumerate(thread_group.run(run)):
        for kept, got in results:
            assert isinstance(got, DataShardTensor) == kept
            _as_on_whole(got, (keep if kept else cut)(*whole_data), rank)


# draws on an explicit generator from tagged parameters, as a sample site
# draws: the whole data's draw, of which each rank keeps its rows (the
# tag's axis of the result, or None where the draw runs across the rows
# and every rank holds it whole)
DRAWS = {
    "bernoulli": (lambda X, y, g: torch.bernoulli(torch.sigmoid(X @ W), generator=g), -1),
    "normal": (lambda X, y, g: torch.normal(X, 1.0, generator=g), -2),
    "standard_gamma": (lambda X, y, g: torch._standard_gamma(X.abs() + 1.0, generator=g), -2),
    "dirichlet": (lambda X, y, g: torch._sample_dirichlet(X.abs() + 1.0, generator=g), -2),
    "multinomial_per_row": (lambda X, y, g: torch.multinomial(X.abs() + 0.1, 2, generator=g),
                            -2),
    "multinomial_over_rows": (lambda X, y, g: torch.multinomial(y + 0.1, 2, generator=g), None),
}


@pytest.mark.parametrize("name", list(DRAWS))
def test_a_draw_at_a_site_over_the_rows_keeps_their_axis(thread_group, name):
    op, axis = DRAWS[name]
    want = op(*_whole_data(), torch.Generator().manual_seed(3))
    got = thread_group.run(
        lambda r: op(*_rank_rows(thread_group, r), torch.Generator().manual_seed(3)))
    for rank, g in enumerate(got):
        assert isinstance(g, DataShardTensor) == (axis is not None)
        if axis is not None:
            assert g._axis == axis
        _as_on_whole(g, want, rank)


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


def _latent_model(X):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    s = npt.sample("s", dist.HalfNormal(1.0))
    with npt.plate("N", SIZE):
        npt.sample("z", dist.Normal(X @ w, s))


def test_a_latent_over_the_rows_is_whole_on_every_rank(thread_group):
    """A latent with a value a row, whose distribution holds the rows: on
    each thread rank the init search draws it whole from the whole data's
    distribution and finds
    the one-process params, potential and gradient of the same generator
    under ``init_to_median`` and ``init_to_sample`` (exact; the potential
    and gradient to rtol 1e-5, atol 1e-6), and its transforms and
    ``constrain_fn`` map it whole."""
    X, _ = _whole_data()

    def init(data, strategy):
        info = infer_util.initialize_model(
            torch.Generator().manual_seed(0), _latent_model, model_args=(data,),
            init_strategy=strategy, num_chains=2)
        transforms = infer_util.get_transforms(
            handlers.seed(_latent_model, 1), (data,), {})
        constrained = infer_util.constrain_fn(
            _latent_model, (data,), {}, {k: v[0] for k, v in info.param_info.z.items()})
        return info.param_info, sorted(transforms), constrained

    for strategy in (init_to_median, init_to_sample):
        want = init(X, strategy)
        got = thread_group.run(lambda r: init(_rank_rows(thread_group, r)[0], strategy))
        for params, names, constrained in got:
            assert names == want[1] == ["s", "w", "z"]
            assert params.z["z"].shape == (2, SIZE) and type(params.z["z"]) is torch.Tensor
            for k in want[0].z:
                assert torch.equal(params.z[k], want[0].z[k])
                torch.testing.assert_close(params.z_grad[k], want[0].z_grad[k], rtol=1e-5,
                                           atol=1e-6)
            torch.testing.assert_close(params.potential_energy, want[0].potential_energy,
                                       rtol=1e-5, atol=1e-6)
            for k in want[2]:
                assert type(constrained[k]) is torch.Tensor
                torch.testing.assert_close(constrained[k], want[2][k], rtol=1e-6, atol=0.0)


def _bounded_model(X):
    w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    with npt.plate("N", SIZE):
        # a support of the rows: each row's latent lies within 1 of its X[:, 0]
        z = npt.sample("z", dist.Uniform(X[:, 0] - 1.0, X[:, 0] + 1.0))
        npt.sample("v", dist.Normal(z + X @ w, 1.0), obs=X[:, 1])


def test_an_autoguide_maps_a_latent_with_a_support_of_the_rows_whole(thread_group):
    """A latent a row whose support holds the rows: the site carries the
    whole data's distribution, so ``AutoNormal``'s bijection maps the whole
    latent on every thread rank; its SVI loss before and after a step, its
    parameters and its posterior draws equal one process's (rtol 1e-5, atol
    1e-6), and every draw lies in the whole data's support."""
    from numpyro_tpu_torch import optim
    from numpyro_tpu_torch.infer import SVI, Trace_ELBO
    from numpyro_tpu_torch.infer.autoguide import AutoNormal

    def fit(X):
        guide = AutoNormal(_bounded_model)
        svi = SVI(_bounded_model, guide, optim.Adam(0.01), Trace_ELBO(), device="cpu")
        state = svi.init(torch.Generator().manual_seed(0), X)
        state, loss = svi.update(state, X)
        params = svi.get_params(state)
        draws = guide.sample_posterior(torch.Generator().manual_seed(1), params, X,
                                       sample_shape=(2,))
        return loss, svi.evaluate(state, X), params, draws

    X, _ = _whole_data()
    want = fit(X)
    for got in thread_group.run(lambda r: fit(_rank_rows(thread_group, r)[0])):
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        for part in (2, 3):
            assert set(got[part]) == set(want[part])
            for k, w in want[part].items():
                assert type(got[part][k]) is torch.Tensor and got[part][k].shape == w.shape
                torch.testing.assert_close(got[part][k], w, rtol=1e-5, atol=1e-6)
        z = got[3]["z"]
        assert z.shape == (2, SIZE)
        assert bool(((z > X[:, 0] - 1.0) & (z < X[:, 0] + 1.0)).all())


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


def test_a_draw_over_the_rows_is_the_whole_draw_of_the_sites_generator(thread_group):
    """A draw over the rows is the whole data's draw from the site's
    generator: a seeded model's draw is whole and moves the generator as one
    process's
    does, and ``Predictive`` of more than one draw (inside a ``vmap``)
    returns each rank's rows of the one-process draws, tagged; the
    distribution made whole is the one-process distribution."""

    def model(X, y=None):
        w = npt.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
        with npt.plate("N", SIZE):
            return npt.sample("y", dist.Bernoulli(logits=X @ w), obs=y)

    def draws(X):
        g = torch.Generator().manual_seed(3)
        seeded = handlers.seed(handlers.substitute(model, data={"w": W}), g)(X)
        pred = infer_util.Predictive(model, posterior_samples={"w": torch.stack([W, -W, W])},
                                     device="cpu")(torch.Generator().manual_seed(0), X)["y"]
        fn = whole_distribution(dist.Normal(X @ W, 1.0).expand((3, X.shape[0])).to_event(1))
        return seeded, g.get_state(), pred, (fn.batch_shape, fn.event_shape, fn.mean)

    X, _ = _whole_data()
    want = draws(X)
    for rank, got in enumerate(thread_group.run(lambda r: draws(_rank_rows(thread_group, r)[0]))):
        assert type(got[0]) is torch.Tensor and torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        assert isinstance(got[2], DataShardTensor) and got[2]._axis == -1
        _as_on_whole(got[2], want[2], rank)
        assert got[3][:2] == want[3][:2] == ((3,), (SIZE,))
        assert torch.equal(got[3][2], want[3][2])


def test_scan_over_the_rows_gathers_them_once(thread_group):
    """``scan`` over tagged rows gathers them at entry (one all_reduce over
    the data), and its log density equals the one-process one."""
    from numpyro_tpu_torch.contrib.control_flow import scan

    def model(y):
        a = npt.sample("a", dist.Normal(0.0, 1.0))

        def step(prev, yt):
            npt.sample("y", dist.Normal(a * prev, 1.0), obs=yt)
            return yt, None

        scan(step, torch.zeros(()), y)

    def density(y):
        return infer_util.log_density(model, (y,), {}, {"a": torch.tensor(0.3)})[0]

    _, y = _whole_data()
    want = density(y)
    got = thread_group.run(lambda r: density(_rank_rows(thread_group, r)[1]))
    assert thread_group.calls == [1, 1]
    for value in got:
        torch.testing.assert_close(value, want, rtol=1e-6, atol=0.0)
    gathered = thread_group.run(lambda r: whole(_rank_rows(thread_group, r)[1]))
    assert all(torch.equal(g, y) for g in gathered)
