"""The rows of a data shard, carried through ops.

The JAX package's ``shard_data`` returns one global array laid out over the
mesh's ``data`` axis: any op on it is an op on the whole data, and XLA
partitions it.  The port's ``shard_data`` gives a rank its own rows only, as
a :class:`DataShardTensor`: a ``torch.Tensor`` subclass that holds the plain
tensor of those rows (``local_rows``) and which of its axes is the sharded
one, and that passes both on through every op (``__torch_function__``).
Every latent stays whole on every rank.  The rules:

- an op that keeps the sharded axis whole keeps the tag: elementwise ops,
  casts and moves, column slices and other indexing that leaves the axis
  alone, products along other axes (``X @ w``), reductions over other axes,
  reshapes that keep the axis as one dim;
- a sum over the sharded axis (``sum``, ``mean``, ``count_nonzero``,
  ``all``, ``any``, a product that contracts the axis: ``X.T @ y``) is this
  rank's partial sum, summed over the data group (:class:`_SumOverData`,
  one ``all_reduce``): the result is the whole data's, replicated, with no
  tag.  Where a tensor that every rank holds alike (a latent ``w``) enters
  an op with a tagged one, it passes through :class:`_EnterShard`, the
  identity whose backward sums the cotangent over the group (Megatron-LM's
  pair of operators), so that ``w``'s gradient is the whole data's on every
  rank.  A sample site's log-density over tagged rows is such a sum, so the
  potential and its gradient are the whole data's;
- **cut**: a tensor that every rank holds alike and whose axis aligned with
  the rows (counted from the right, as broadcasting aligns) has the whole
  data's size (a latent with a value a row) is cut to the rank's rows
  where it meets them (:class:`_CutRows`, in place of ``_EnterShard``): its
  backward puts the cotangent into a zero-filled whole tensor summed over
  the group, so its gradient is the whole data's on every rank;
- **gather**: an op that cuts, reorders or mixes the rows (a row slice,
  ``torch.cat`` or a pairwise op along them, ``sort``, selection by value,
  another reduction over them, a reshape that merges them) runs on the
  whole rows (:class:`_GatherRows`: the rows of every rank, exactly, each
  gather one ``all_reduce``; backward the rank's rows of the cotangent),
  and its result is replicated, with no tag: where it meets the rows again
  it is cut.  Reads on the host (``tolist``, ``numpy``, ``item``) read the
  gathered whole.  Some reductions along the rows take collectives of
  their own: ``max``, ``min``, ``amax``, ``amin`` an ``all_reduce`` with
  ``MAX`` or ``MIN`` (``argmax``, ``argmin`` and ``max(dim)``'s indices the
  same with the whole data's row index; the derivative shared among the
  ranks at the extremum, :class:`_AtExtremum`), ``logsumexp`` a ``MAX`` and a sum,
  ``softmax`` and ``log_softmax`` along the rows the same two (the result
  keeps the tag), ``cumsum`` along the rows the ranks' totals and an
  exclusive prefix (:class:`_RankPrefix`; the result keeps the tag);
- a draw from tagged parameters with an explicit ``generator=`` draws the
  whole from the gathered parameters and keeps the rank's rows, as a
  sample site does (``primitives``, :func:`whole_site`): a sharded draw
  equals the one-process draw on the whole data.

Every collective of these rules runs inside ``torch.func`` transforms: the
autograd functions' ``vmap`` rules leave the ``vmap`` and make one
collective for every chain.  What stays refused, with
``NotImplementedError``, has no counterpart in the JAX package: an in-place
write of the rows into an untagged tensor, and ``out=`` (JAX's arrays are
immutable: the out-of-place form runs under the gather), and a draw from
tagged parameters on torch's global generator outside a sample site (every
JAX draw takes an explicit key).  An untagged tensor of the rank's own row
count meeting the rows raises as well, where JAX gives a shape error.

Where an op takes the sharded axis is read off the op itself: it is run
once on ``meta`` tensors in which the sharded axis has a size no real tensor
has (:data:`_PROBE_ROWS`), and the axis is found by that size in the result
(cached per op and the arguments' shapes and values).  Names decide only
what the probe cannot: moves to another device, reshapes and expands to
sizes taken from the rank's own shape (matched by their sizes), what a
reduction that loses the axis means (a sum, a mean, an extremum or a
gather), ops that keep the axis's size but reorder or mix along it, random
draws, indexing by position, in-place writes and reads on the host.
"""

from __future__ import annotations

import copy
import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

__all__ = ["DataShard", "DataShardTensor", "cut_rows", "distribution_shard", "local_rows",
           "shard_of", "whole", "whole_distribution", "whole_site"]

# the sharded axis's size in a probe: no real tensor has it
_PROBE_ROWS = 1_000_003
_ROADMAP = "(ROADMAP.md)"


# whether this process has made a shard of part of the rows: until it has,
# no distribution holds one, and the sample sites do not look
_PARTIAL_MADE = []


class DataShard:
    """Rows ``[start, stop)`` along ``axis`` of a tensor of ``size`` rows
    there, held by this rank of the data axis's process ``group``."""

    def __init__(self, start, stop, axis, group, size):
        self.start, self.stop, self.axis, self.group = start, stop, axis, group
        self.size = size
        if self.partial and not _PARTIAL_MADE:
            _PARTIAL_MADE.append(True)

    @property
    def rows(self):
        return self.stop - self.start

    @property
    def partial(self):
        return self.rows != self.size

    def same_rows(self, other):
        return (self.start, self.stop, self.size) == (other.start, other.stop, other.size) \
            and self.group is other.group

    def __repr__(self):
        return f"DataShard(rows {self.start} to {self.stop} of {self.size})"


def _mesh():
    # imported here: mesh imports this module
    from numpyro_tpu_torch.parallel import mesh

    return mesh


def _all_reduce(x, group, op="sum"):
    return _mesh().all_reduce(x, group, over_data=True, op=op)


def _leave_vmap(fn, in_dims, x, *rest):
    """A ``vmap`` rule that runs ``fn`` once on the whole batch (its axis
    moved to the front; the sharded axis counts from the right)."""
    if in_dims[0] is None:
        return fn.apply(x, *rest), None
    return fn.apply(x.movedim(in_dims[0], 0), *rest), 0


class _SumOverData(torch.autograd.Function):
    """The sum over the data ``group`` of every rank's partial sums ``x``;
    the cotangent passes unchanged (each rank's partial sum enters the whole
    sum once), the tangent is summed as the value is."""

    @staticmethod
    def forward(x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        if out.dtype == torch.bool:
            out = out.to(torch.int64)
        return _all_reduce(out, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return ct, None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _SumOverData.apply(tangent, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _leave_vmap(_SumOverData, in_dims, x, group)


class _EnterShard(torch.autograd.Function):
    """The identity on a tensor that every rank of ``group`` holds alike,
    where it enters an op with a rank's rows: its backward sums the
    cotangent over the group (each rank's rows add their part of the
    gradient)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return _SumOverData.apply(ct, ctx.group), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return tangent

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _EnterShard.apply(x, group), in_dims[0]


class _CutRows(torch.autograd.Function):
    """A tensor that every rank holds whole, cut to this rank's rows along
    ``axis`` (negative) where it meets them: the backward puts the
    cotangent into a zero-filled whole tensor and sums it over the group,
    so the whole tensor's gradient is the whole data's on every rank."""

    @staticmethod
    def forward(x, shard, axis):
        return x.narrow(axis, shard.start, shard.rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, ct):
        s = ctx.shard
        full = F.pad(ct, [0, 0] * (-ctx.axis - 1) + [s.start, s.size - s.stop])
        return _sum_over(full, s), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return tangent.narrow(ctx.axis, ctx.shard.start, ctx.shard.rows)

    @staticmethod
    def vmap(info, in_dims, x, shard, axis):
        return _leave_vmap(_CutRows, in_dims, x, shard, axis)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows along ``axis`` (negative) as the whole tensor, bit
    for bit (``mesh.gather_along``: one ``all_reduce``); the backward is
    this rank's rows of the cotangent, which every rank holds alike."""

    @staticmethod
    def forward(x, shard, axis):
        return _mesh().gather_along(x, axis, shard.start, shard.size, shard.group,
                                    over_data=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, ct):
        return ct.narrow(ctx.axis, ctx.shard.start, ctx.shard.rows), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _GatherRows.apply(tangent, ctx.shard, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, shard, axis):
        return _leave_vmap(_GatherRows, in_dims, x, shard, axis)


class _ExtremumOverData(torch.autograd.Function):
    """The maximum or minimum (``op``) over the data ``group`` of every
    rank's ``x``, without a gradient: :class:`_AtExtremum` gives it one."""

    @staticmethod
    def forward(x, group, op):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), group, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, ct):
        return None, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, op):
        return _leave_vmap(_ExtremumOverData, in_dims, x, group, op)


class _AtExtremum(torch.autograd.Function):
    """``best``, the extremum over the data ``group`` of every rank's
    ``local`` extrema, as a function of ``local``: its cotangent and its
    tangent are shared among the ranks in proportion to their ``weight``
    (nonzero only where ``local`` is at ``best``), as one process shares
    them among its ties.  The forward makes no collective; the backward and
    the tangent sum the weights over the group."""

    @staticmethod
    def forward(local, best, weight, group):
        return best.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[3]
        ctx.save_for_backward(inputs[2])
        ctx.save_for_forward(inputs[2])

    @staticmethod
    def backward(ctx, ct):
        (weight,) = ctx.saved_tensors
        return ct * weight / _SumOverData.apply(weight, ctx.group), None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        (weight,) = ctx.saved_tensors
        both = _SumOverData.apply(torch.stack([tangent * weight, weight]), ctx.group)
        return both[0] / both[1]

    @staticmethod
    def vmap(info, in_dims, local, best, weight, group):
        def front(x, d):
            return x.expand(info.batch_size, *x.shape) if d is None else x.movedim(d, 0)

        parts = [front(x, d) for x, d in zip((local, best, weight), in_dims)]
        return _AtExtremum.apply(*parts, group), 0


def _rank_prefix(x, shard, before):
    """The sum of the ``x`` of the ranks whose rows come before this rank's
    (``before``) or after them."""
    panel, starts = _mesh().gather_ranks(x, shard.start, shard.group)
    keep = (starts < shard.start) if before else (starts > shard.start)
    keep = keep.reshape((-1,) + (1,) * x.dim())
    return torch.where(keep, panel, panel.new_zeros(())).sum(0)


class _RankPrefix(torch.autograd.Function):
    """The sum of the ranks' ``x`` whose rows come before this rank's (the
    exclusive prefix of a sum along the rows, one ``all_reduce``); the
    backward sums the cotangents of the ranks whose rows come after."""

    @staticmethod
    def forward(x, shard, before):
        return _rank_prefix(x, shard, before)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard, ctx.before = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, ct):
        return _RankPrefix.apply(ct, ctx.shard, not ctx.before), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _RankPrefix.apply(tangent, ctx.shard, ctx.before)

    @staticmethod
    def vmap(info, in_dims, x, shard, before):
        return _leave_vmap(_RankPrefix, in_dims, x, shard, before)


def shard_of(x):
    """The :class:`DataShard` whose rows ``x`` holds, or ``None``."""
    return x._shard if isinstance(x, DataShardTensor) else None


def local_rows(x):
    """The plain tensor of a :class:`DataShardTensor`'s rows (``x`` as it
    is otherwise): what the GLM op and the subsample gather read."""
    return x._t if isinstance(x, DataShardTensor) else x


def _gather(t):
    """The plain whole tensor of the tagged ``t``: every rank's rows."""
    if t._shard.group is None:
        raise ValueError(f"{t._shard} has no process group to gather the other rows over")
    return _GatherRows.apply(t._t, t._shard, t._axis)


def whole(x):
    """The whole data's tensor of ``x``, a rank's rows of a data shard
    (gathered over the data group, bit for bit, with a gradient that flows
    back to the rank's rows), or ``x`` itself where it holds no such rows."""
    if isinstance(x, DataShardTensor) and x._shard.partial:
        return _gather(x)
    return local_rows(x)


def _cut(x, shard, axis):
    """This rank's rows along ``axis`` of ``x``, which every rank holds
    whole (the gradient of ``x`` then sums over the group)."""
    if x.requires_grad:
        return _CutRows.apply(x, shard, axis)
    return x.narrow(axis, shard.start, shard.rows)


def cut_rows(x, rows):
    """``x``, a tensor that every rank holds whole, as this rank's rows,
    tagged, where ``rows`` is ``(shard, axis)`` (:func:`whole_site`)."""
    shard, axis = rows
    return DataShardTensor(_cut(x, shard, axis), shard, axis)


def _searched(obj):
    """Whether :func:`distribution_shard` looks inside ``obj``: a
    distribution, a constraint or a transform."""
    from numpyro_tpu_torch.distributions import Distribution, constraints, transforms

    return isinstance(obj, (Distribution, constraints.Constraint, transforms.Transform))


def _first_tagged(obj):
    """The first tagged tensor of ``obj`` (searched through the
    distributions, constraints and transforms it holds), or ``None``."""
    if not _PARTIAL_MADE:
        return None
    seen = set()

    def find(o, depth):
        if isinstance(o, DataShardTensor):
            return o
        if depth > 4 or id(o) in seen or isinstance(o, torch.Tensor):
            return None
        seen.add(id(o))
        if isinstance(o, (list, tuple)):
            values = o
        elif isinstance(o, dict):
            values = o.values()
        elif _searched(o):
            values = vars(o).values()
        else:
            return None
        for v in values:
            found = find(v, depth + 1)
            if found is not None:
                return found
        return None

    return find(obj, 0)


def distribution_shard(fn):
    """The :class:`DataShard` of the first tagged parameter of the
    distribution ``fn`` (searched through the distributions, constraints and
    transforms it holds), or ``None``."""
    t = _first_tagged(fn)
    return None if t is None else t._shard


def _rows_position(shape, shard, prefer):
    """The position (negative) in ``shape`` that holds the rank's rows:
    ``prefer`` if it does, else the first that does, else ``None``."""
    found = [i - len(shape) for i, n in enumerate(shape) if n == shard.rows]
    if prefer in found:
        return prefer
    return found[0] if found else None


def _widened(obj, shard, at, memo):
    """A copy of ``obj`` whose tagged tensors are the whole data's and whose
    distributions' shapes have the whole size at the rows' position ``at``
    of their batch and event shape."""
    from numpyro_tpu_torch.distributions import Distribution

    if isinstance(obj, (list, tuple)):
        parts = [_widened(v, shard, at, memo) for v in obj]
        return type(obj)(*parts) if hasattr(obj, "_fields") else type(obj)(parts)
    if isinstance(obj, dict):
        return {k: _widened(v, shard, at, memo) for k, v in obj.items()}
    if isinstance(obj, DataShardTensor):
        if id(obj) not in memo:  # each tagged tensor gathered once
            memo[id(obj)] = _gather(obj) if obj._shard.partial else obj._t
    elif not _searched(obj) or _first_tagged(obj) is None:
        return obj
    elif id(obj) not in memo:
        new = memo[id(obj)] = copy.copy(obj)
        for k, v in vars(obj).items():
            new.__dict__[k] = _widened(v, shard, at, memo)
        if isinstance(obj, Distribution):
            joint = tuple(new._batch_shape) + tuple(new._event_shape)
            pos = _rows_position(joint, shard, at)
            if pos is not None:
                joint = list(joint)
                joint[pos] = shard.size
                n = len(new._batch_shape)
                new._batch_shape, new._event_shape = tuple(joint[:n]), tuple(joint[n:])
    return memo[id(obj)]


def whole_site(fn):
    """``(whole_distribution(fn), rows)``: ``rows`` is ``(shard, axis)``
    where ``fn`` holds a rank's rows of a data shard at ``axis`` (negative)
    of its batch and event shape, else ``None``."""
    t = _first_tagged(fn)
    if t is None or not t._shard.partial:
        return fn, None
    shard = t._shard
    at = _rows_position(tuple(fn.batch_shape) + tuple(fn.event_shape), shard, t._axis)
    return _widened(fn, shard, at, {}), (None if at is None else (shard, at))


def whole_distribution(fn):
    """``fn``, a distribution over a rank's rows of a data shard, over the
    whole data's rows: a copy whose tagged tensors are gathered (each one
    ``all_reduce``, inside a ``vmap`` too) and whose shapes have the whole
    data's size in place of the rank's rows.  Its draws on a generator are
    the one-process draws on the whole data.  ``fn`` itself where it holds
    no such rows."""
    return whole_site(fn)[0]


def _fn_name(func):
    name = getattr(func, "__name__", "")
    if name == "__get__":
        return "get:" + getattr(getattr(func, "__self__", None), "__name__", "")
    return name


# moves to another device or type, which meta tensors cannot make: they
# keep the axis where it is
_MOVES = frozenset("to cpu cuda type".split())
# reads of a tensor's properties that give no tensor
_PLAIN = frozenset("""
get:shape get:dtype get:device get:ndim get:is_cuda get:requires_grad get:is_leaf
get:layout get:grad_fn get:is_sparse get:is_quantized get:is_meta get:names get:itemsize
size dim ndimension numel nelement __len__ element_size is_floating_point is_complex
is_contiguous stride storage_offset data_ptr get_device is_signed register_hook
retain_grad backward is_inference new_zeros new_ones new_full new_empty new_tensor
__format__ __setstate__ __dir__ __sizeof__ is_shared
""".split())
# reads of the rows on the host
_HOST = frozenset("item tolist numpy __array__ __int__ __float__ __index__ __bool__ "
                  "__complex__ __array_wrap__ __reduce_ex__ __iter__".split())
# sums over the sharded axis: the partial sums are summed over the group
_SUMS = frozenset("sum nansum count_nonzero".split())
_MEANS = frozenset("mean nanmean".split())
_ANY_ALL = frozenset("any all".split())
# extrema over the sharded axis: an all_reduce with MAX or MIN
_EXTREMA = {"max": "max", "amax": "max", "argmax": "max",
            "min": "min", "amin": "min", "argmin": "min"}
# products that contract the sharded axis when they lose it
_PRODUCTS = frozenset("matmul __matmul__ __rmatmul__ mm mv dot inner vdot einsum tensordot "
                      "bmm linear".split())
# ops that keep the size of an axis and reorder or mix along it
_ALONG = {"sort": -1, "argsort": -1, "msort": 0, "cumsum": None, "cumprod": None,
          "cummax": None, "cummin": None, "logcumsumexp": None, "softmax": None,
          "log_softmax": None, "flip": None, "fliplr": 1, "flipud": 0, "roll": None,
          "normalize": 1, "renorm": None, "rot90": None, "triu": None, "tril": None}
_RANDOM = frozenset("bernoulli normal poisson multinomial binomial rand_like randn_like "
                    "randint_like _standard_gamma _sample_dirichlet bernoulli_ normal_ "
                    "uniform_ exponential_ geometric_ cauchy_ log_normal_ random_".split())
_RESHAPES = frozenset("reshape view".split())
_EXPANDS = frozenset("expand broadcast_to expand_as".split())
# ops that select by position: neither the tensor they index nor its
# indices are values a row, so neither is cut (a written value is)
_INDEXING = frozenset("__getitem__ __setitem__ index_select gather take take_along_dim "
                      "index_put scatter scatter_add scatter_reduce index_add index_copy "
                      "index_fill index_reduce".split())
_IN_PLACE = frozenset("__setitem__ __iadd__ __isub__ __imul__ __itruediv__ __ipow__ __iand__ "
                      "__ior__ __ixor__ copy_".split())


def _refuse(what):
    raise NotImplementedError(
        f"{what} on the rows of a data shard (parallel.shard_data) has no counterpart in the "
        f"JAX package: the port does not run it on data shards {_ROADMAP}")


def _walk(x, visit):
    if isinstance(x, torch.Tensor):
        return visit(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_walk(v, visit) for v in x)
    if isinstance(x, dict):
        return {k: _walk(v, visit) for k, v in x.items()}
    return x


class _Uncached(Exception):
    """An argument whose probe is not cached: its value cannot be a key."""


def _signature(x, wholes):
    """A stand-in for an argument of a probe, by value: its shape, dtype and
    tag for a tensor (a whole tensor that meets the rows as if tagged), its
    bounds for a slice, itself otherwise.  Raises :class:`_Uncached` for an
    argument that cannot be hashed, or a slice bound that is a tensor (the
    probe's result depends on its value)."""
    if isinstance(x, DataShardTensor):
        return ("S", tuple(x._t.shape), x._t.dtype, x._axis)
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, wholes.get(id(x)))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_signature(v, wholes) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _signature(v, wholes)) for k, v in sorted(x.items()))
    if isinstance(x, slice):
        bounds = (x.start, x.stop, x.step)
        if any(isinstance(b, torch.Tensor) for b in bounds):
            raise _Uncached
        return ("slice",) + tuple(_signature(b, wholes) for b in bounds)
    try:
        hash(x)
    except TypeError:
        raise _Uncached from None
    return ("v", type(x).__name__, x)


def _meta(x, wholes):
    """The probe's stand-in of an argument: a meta tensor of the same shape
    and dtype, its sharded axis (a whole tensor's aligned axis) ``_PROBE_ROWS``
    long."""
    if isinstance(x, DataShardTensor):
        shape, axis = list(x._t.shape), x._axis
    else:
        shape, axis = list(x.shape), wholes.get(id(x))
    if axis is not None:
        shape[axis] = _PROBE_ROWS
    return torch.empty(shape, dtype=(x._t if isinstance(x, DataShardTensor) else x).dtype,
                       device="meta")


_PROBES = OrderedDict()


def _probe(func, args, kwargs, wholes):
    """Where ``func`` puts the sharded axis: ``("keep", axes)`` with the
    negative axis of each tensor output (``None`` for an output without
    it), or ``("lost", None)`` where no output keeps it, ``("many", None)``
    where one holds it twice, or ``("fail", None)`` where the op cannot run
    on meta tensors."""
    try:
        key = (func, _signature(args, wholes), _signature(kwargs, wholes))
    except _Uncached:
        key = None
    hit = None if key is None else _PROBES.get(key)
    if hit is not None:
        _PROBES.move_to_end(key)
        return hit
    meta = lambda x: _meta(x, wholes)  # noqa: E731
    try:
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*_walk(args, meta), **_walk(kwargs, meta))
    except Exception:  # noqa: BLE001 - an op that meta tensors cannot run
        result = ("fail", None)
    else:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        axes = []
        for o in outs:
            if not isinstance(o, torch.Tensor):
                axes.append(None)
                continue
            at = [i - o.dim() for i, s in enumerate(o.shape) if s == _PROBE_ROWS]
            if len(at) > 1:
                axes.append("many")
            else:
                axes.append(at[0] if at else None)
        if "many" in axes:
            result = ("many", None)
        elif all(a is None for a in axes):
            result = ("lost", None)
        else:
            result = ("keep", tuple(axes))
    if key is not None:
        _PROBES[key] = result
        if len(_PROBES) > 4096:
            _PROBES.popitem(last=False)
    return result


def _dim_arg(func_name, args, kwargs):
    """The ``dim`` an op of :data:`_ALONG` works along (``None``: all of
    them, or the op's default)."""
    if "dim" in kwargs:
        return kwargs["dim"]
    if "dims" in kwargs:
        return kwargs["dims"]
    default = _ALONG[func_name]
    if func_name in ("roll",):
        return args[2] if len(args) > 2 else None
    if func_name in ("rot90",):
        return args[2] if len(args) > 2 else (0, 1)
    if func_name in ("triu", "tril"):
        return (-2, -1)
    if func_name in ("renorm",):
        return args[2] if len(args) > 2 else None
    if func_name == "normalize":
        return args[2] if len(args) > 2 else default
    if func_name in ("fliplr", "flipud", "msort"):
        return default
    return args[1] if len(args) > 1 and not isinstance(args[1], torch.Tensor) else default


def _along_name(name):
    if name in _ALONG:
        return name
    return name.rstrip("_") if name.rstrip("_") in _ALONG else None


def _reorders_axis(name, args, kwargs, tagged):
    name = _along_name(name)
    if name is None:
        return False
    dims = _dim_arg(name, args, kwargs)
    if dims is None:
        return True
    dims = dims if isinstance(dims, (tuple, list)) else (dims,)
    for t in tagged:
        nd = t._t.dim()
        for d in dims:
            if isinstance(d, int) and (d % max(nd, 1)) - nd == t._axis:
                return True
    return False


def _indexes_rows(name, args, kwargs):
    """Whether an op that selects by position (:data:`_INDEXING`) takes or
    writes its tagged input's rows by index (the indices are the whole
    data's positions), which the shapes alone do not show."""
    target = args[0] if args else None
    name = name.rstrip("_")
    if not isinstance(target, DataShardTensor) or name in ("__getitem__", "__setitem__"):
        return False
    if name == "take":
        return True
    nd, axis = target._t.dim(), target._axis
    if name == "index_put":
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        p = nd + axis
        return p < len(indices) and indices[p] is not None
    dim = kwargs.get("dim", args[2] if name == "take_along_dim" and len(args) > 2
                     else args[1] if name != "take_along_dim" and len(args) > 1 else None)
    return dim is None or (isinstance(dim, int) and dim % max(nd, 1) - nd == axis)


def _reshaped_axis(in_shape, axis, out_shape):
    """The negative axis of ``out_shape`` that holds ``in_shape``'s sharded
    ``axis`` whole, with the same elements before and after it, or
    ``None``."""
    p = len(in_shape) + axis
    left, rows = math.prod(in_shape[:p]), in_shape[p]
    right = math.prod(in_shape[p + 1:])
    for q, size in enumerate(out_shape):
        if size == rows and math.prod(out_shape[:q]) == left \
                and math.prod(out_shape[q + 1:]) == right:
            return q - len(out_shape)
    return None


def _untagged_of_local_rows(args, kwargs, tagged, shard):
    """Whether an untagged tensor argument has the rank's row count where
    the tagged ones have their rows (a tensor sized from the shard's own
    shape, which would pass for the rows)."""
    if not shard.partial or shard.rows == 1:
        return False
    axes = {t._axis for t in tagged}
    found = []

    def visit(x):
        if not isinstance(x, DataShardTensor):
            for a in axes:
                if x.dim() >= -a and x.shape[a] == shard.rows:
                    found.append(x)
        return x

    _walk((args, kwargs), visit)
    return bool(found)


def _whole_tensors(name, args, kwargs, tagged, shard):
    """``{id: axis}`` of the untagged tensor arguments that every rank holds
    whole and that meet the rows: the axis aligned with a tagged one's rows
    has the whole data's size.  An op that selects by position holds none
    (``__setitem__``'s value is aligned with the slice it writes)."""
    axes = {t._axis for t in tagged}
    found = {}
    if name in _INDEXING:
        return found

    def visit(x):
        if isinstance(x, DataShardTensor):
            return x
        for a in axes:
            if x.dim() >= -a and x.shape[a] == shard.size:
                found[id(x)] = a
                break
        return x

    _walk((args, kwargs), visit)
    return found


def _plain_call(func, args, kwargs):
    with torch._C.DisableTorchFunctionSubclass():
        return func(*args, **kwargs)


def _on_whole(func, args, kwargs):
    """``func`` on the whole tensors: every tagged argument gathered; the
    result is replicated, with no tag."""

    def gather(x):
        return _gather(x) if isinstance(x, DataShardTensor) else x

    return _plain_call(func, _walk(args, gather), _walk(kwargs, gather))


def _extreme(local, group, op, ties):
    """The extremum over the group of every rank's ``local`` extrema, its
    derivative shared among the ranks at it by their count of ``ties``
    there."""
    if group is None:
        return local
    best = _ExtremumOverData.apply(local.detach(), group, op)
    weight = torch.where(local.detach() == best, ties, 0).to(local.dtype)
    return _AtExtremum.apply(local, best, weight, group)


def _global_index(values, index, group, op):
    """The smallest whole-data index among the ranks whose ``values`` are
    the extremum (as one process's ``argmax`` takes the first)."""
    if group is None:
        return index
    best = _ExtremumOverData.apply(values.detach(), group, op)
    big = torch.iinfo(index.dtype).max
    return _ExtremumOverData.apply(torch.where(values == best, index, big), group, "min")


def _flat_index(index, shape, axis, shard):
    """A flat index into the rank's ``shape`` as a flat index into the whole
    data's (the sharded ``axis`` ``shard.size`` long)."""
    inner = math.prod(shape[len(shape) + axis + 1:])
    rows = shape[axis]
    before, rest = index // (inner * rows), index % (inner * rows)
    return (before * shard.size + rest // inner + shard.start) * inner + rest % inner


def _ties(x, out, dims, keepdim):
    """The count of entries of ``x`` at ``out``, its extremum over ``dims``."""
    dims = sorted(d % x.dim() for d in dims)
    kept = out
    if not keepdim:
        for d in dims:
            kept = kept.unsqueeze(d)
    return (x == kept).sum(dims, keepdim=keepdim)


def _extremum(name, func, plain_args, plain_kwargs, t, shard):
    """``max``, ``min``, ``amax``, ``amin``, ``argmax``, ``argmin`` over the
    sharded axis: this rank's, then an ``all_reduce`` with ``MAX`` or
    ``MIN``.  The derivative goes where one process sends it: shared evenly
    among the entries at the extremum, or, for ``max(dim)``'s values, to
    the entry at its index."""
    op, group = _EXTREMA[name], shard.group
    out = _plain_call(func, plain_args, plain_kwargs)
    x = t._t
    dim = plain_kwargs.get("dim", plain_args[1] if len(plain_args) > 1 else None)
    keepdim = plain_kwargs.get("keepdim", plain_args[2] if len(plain_args) > 2 else False)
    with torch._C.DisableTorchFunctionSubclass():
        if name in ("argmax", "argmin"):
            if dim is None:
                values = x.amax() if op == "max" else x.amin()
                index = _flat_index(out, tuple(x.shape), t._axis, shard)
            else:
                values = x.amax(dim, keepdim) if op == "max" else x.amin(dim, keepdim)
                index = out + shard.start
            return _global_index(values, index, group, op)
        if isinstance(out, torch.Tensor):
            dims = _dims(dim if dim != () else None, x.dim())
            return _extreme(out, group, op, _ties(x, out.detach(), dims, keepdim))
        values, index = out
        index = _global_index(values, index + shard.start, group, op)
        return type(out)((_extreme(values, group, op, index == out[1] + shard.start), index))


def _dims(dim, ndim):
    if dim is None:
        return tuple(range(ndim))
    return tuple(dim) if isinstance(dim, (tuple, list)) else (dim,)


def _max_shift(x, dims, group):
    """The whole data's maximum of ``x`` over ``dims`` (kept), without a
    gradient, finite (a shift for exp)."""
    m = x.detach().amax(dims, keepdim=True)
    if group is not None:
        m = _ExtremumOverData.apply(m, group, "max")
    return torch.nan_to_num(m, nan=0.0, posinf=0.0, neginf=0.0)


def _logsumexp(plain_args, plain_kwargs, t, shard):
    """``logsumexp`` over dims that take in the sharded axis: a ``MAX`` and a
    sum over the group; replicated."""
    x = t._t
    dim = plain_kwargs.get("dim", plain_args[1] if len(plain_args) > 1 else None)
    keepdim = plain_kwargs.get("keepdim", plain_args[2] if len(plain_args) > 2 else False)
    dims = _dims(dim, x.dim())
    with torch._C.DisableTorchFunctionSubclass():
        m = _max_shift(x, dims, shard.group)
        s = _sum_over(torch.exp(x - m).sum(dims, keepdim=True), shard)
        out = torch.log(s) + m
        return out if keepdim else out.squeeze(dims)


def _softmax(name, args, kwargs, t, shard):
    """``softmax`` or ``log_softmax`` along the sharded axis: a ``MAX`` and a
    sum over the group; the result keeps the tag."""
    dtype = kwargs.get("dtype") or next(
        (a for a in args[1:] if isinstance(a, torch.dtype)), None)
    x, axis = t._t, t._axis
    with torch._C.DisableTorchFunctionSubclass():
        if dtype is not None:
            x = x.to(dtype)
        m = _max_shift(x, (axis,), shard.group)
        shifted = x - m
        s = _sum_over(torch.exp(shifted).sum(axis, keepdim=True), shard)
        if shard.group is not None and s.requires_grad:
            s = _EnterShard.apply(s, shard.group)  # each rank's rows use the whole sum
        out = torch.exp(shifted) / s if name == "softmax" else shifted - torch.log(s)
    return DataShardTensor(out, shard, axis)


def _cumsum(func, plain_args, plain_kwargs, t, shard):
    """``cumsum`` along the sharded axis: this rank's, plus the sum of the
    rows of the ranks before it (:class:`_RankPrefix`); keeps the tag."""
    axis = t._axis
    local = _plain_call(func, plain_args, plain_kwargs)
    if shard.group is not None:
        with torch._C.DisableTorchFunctionSubclass():
            total = local.narrow(axis, local.shape[axis] - 1, 1)
            local = local + _RankPrefix.apply(total, shard, True)
    return DataShardTensor(local, shard, axis)


class DataShardTensor(torch.Tensor):
    """A rank's rows of a data shard: ``local_rows`` the plain tensor,
    ``_axis`` its sharded axis (negative, so that a ``vmap`` around it and
    broadcasting leave it in place), ``_shard`` the :class:`DataShard`.
    ``data_shard`` gives the shard with the axis of this tensor.  See the
    module docstring for the rules of its ops."""

    @staticmethod
    def __new__(cls, data, shard, axis):
        if isinstance(data, DataShardTensor):
            data = data._t
        out = data.as_subclass(cls)
        out._t = data
        out._shard = shard
        out._axis = axis
        return out

    @property
    def data_shard(self):
        s = self._shard
        return DataShard(s.start, s.stop, self._t.dim() + self._axis, s.group, s.size)

    def __repr__(self, **kwargs):
        s = self._shard
        return (f"DataShardTensor(rows {s.start} to {s.stop} of {s.size} on axis {self._axis}, "
                f"{self._t!r})")

    def __deepcopy__(self, memo):
        return DataShardTensor(copy.deepcopy(self._t, memo), self._shard, self._axis)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _fn_name(func)
        tagged = []

        def strip(x):
            if isinstance(x, DataShardTensor):
                tagged.append(x)
                return x._t
            return x

        plain_args, plain_kwargs = _walk(args, strip), _walk(kwargs, strip)
        if name in _PLAIN or name.startswith("get:_") or name == "get:grad" or not tagged:
            # a property, or a subclass op reached with no tagged argument
            return _plain_call(func, plain_args, plain_kwargs)
        shard = tagged[0]._shard
        if not shard.partial:
            # every row (a mesh of one data shard): the tag has nothing to keep
            return _plain_call(func, plain_args, plain_kwargs)
        for t in tagged[1:]:
            if not t._shard.same_rows(shard):
                raise ValueError(
                    f"{name} meets the rows of two data shards ({shard} and {t._shard}): "
                    "shard every tensor of the data along its rows on one mesh")
        if name in _HOST:
            return _on_whole(func, args, kwargs)
        if "out" in kwargs:
            _refuse(f"{name}(..., out=)")
        in_place = name.endswith("_") and not name.startswith("__") or name in _IN_PLACE
        if in_place and not isinstance(args[0] if args else None, DataShardTensor):
            _refuse(f"writing the rows into a tensor that does not carry their tag ({name})")
        if name in _RANDOM or name.rstrip("_") in _RANDOM:
            return _draw(func, name, args, kwargs, tagged[0], in_place)
        if _untagged_of_local_rows(args, kwargs, tagged, shard):
            raise NotImplementedError(
                f"{name} of the rows of a data shard with an untagged tensor of this rank's row "
                f"count ({shard.rows}; a tensor sized from the shard's own shape): the JAX "
                "package's global array gives a shape error there; size it from the whole "
                f"data's {shard.size} rows {_ROADMAP}")
        wholes = _whole_tensors(name, args, kwargs, tagged, shard)
        group = shard.group

        def enter(x):
            # the rows as they are; a whole tensor cut to them; a tensor
            # every rank holds alike entering an op with them, its gradient
            # gathering every rank's part
            if isinstance(x, DataShardTensor):
                return x._t
            if id(x) in wholes:
                return _cut(x, shard, wholes[id(x)])
            return _EnterShard.apply(x, group) if group is not None and x.requires_grad else x

        if name == "__setitem__":
            kind, axes = _probe(torch.Tensor.__getitem__, (args[0], args[1]), {}, wholes)
            if kind != "keep" or axes[0] is None:
                return _in_place_on_whole(func, args, kwargs)
            value = args[2]
            if isinstance(value, torch.Tensor) and not isinstance(value, DataShardTensor) \
                    and value.dim() >= -axes[0] and value.shape[axes[0]] == shard.size:
                wholes[id(value)] = axes[0]  # a whole value for the rows of the slice
            _plain_call(func, _walk(args, enter), _walk(kwargs, enter))
            return None
        if in_place:
            if _reorders_axis(name, args, kwargs, tagged) or _indexes_rows(name, args, kwargs):
                return _in_place_on_whole(func, args, kwargs)
            _plain_call(func, _walk(args, enter), _walk(kwargs, enter))
            return args[0]

        if name in _MOVES:
            # a move, which meta tensors cannot make, keeps the axis
            return _tag(_plain_call(func, plain_args, plain_kwargs), shard, tagged[0]._axis)

        if name in _RESHAPES or name in _EXPANDS:
            out = _plain_call(func, plain_args, plain_kwargs)
            t = tagged[0]
            if name in _EXPANDS:
                axis = t._axis if out.dim() >= -t._axis and out.shape[t._axis] == shard.rows \
                    else None
            else:
                axis = _reshaped_axis(tuple(t._t.shape), t._axis, tuple(out.shape))
            if axis is None:  # splits or merges the rows with another axis
                return _on_whole(func, args, kwargs)
            return _tag(out, shard, axis)

        if name in _INDEXING and _indexes_rows(name, args, kwargs):
            return _on_whole(func, args, kwargs)
        if _reorders_axis(name, args, kwargs, tagged):
            along = _along_name(name)
            if len(tagged) == 1 and not wholes and _dim_arg(along, args, kwargs) is not None:
                if along in ("softmax", "log_softmax"):
                    return _softmax(along, args, kwargs, tagged[0], shard)
                if along == "cumsum":
                    return _cumsum(func, plain_args, plain_kwargs, tagged[0], shard)
            return _on_whole(func, args, kwargs)
        kind, axes = _probe(func, args, kwargs, wholes)
        if kind == "keep":
            out = _plain_call(func, _walk(args, enter), _walk(kwargs, enter))
            if isinstance(out, (tuple, list)):
                return type(out)([_tag(o, shard, a) if a is not None else o
                                  for o, a in zip(out, axes)])
            return _tag(out, shard, axes[0])
        if kind == "lost" and (name in _SUMS or name in _PRODUCTS):
            return _sum_over(_plain_call(func, _walk(args, enter), _walk(kwargs, enter)), shard)
        if kind == "lost" and name in _MEANS:
            # the partial sum over the same dims, divided by the whole count,
            # which has the shard's size in place of its rows
            summer = torch.nansum if name == "nanmean" else torch.sum
            partial = _plain_call(summer, _walk(args, enter), _walk(kwargs, enter))
            count = tagged[0]._t.numel() // max(partial.numel(), 1)
            return _sum_over(partial, shard) / (count // shard.rows * shard.size)
        if kind == "lost" and name in _ANY_ALL:
            local = _plain_call(func, _walk(args, enter), _walk(kwargs, enter))
            with torch._C.DisableTorchFunctionSubclass():
                if name == "any":
                    return _sum_over(local.to(torch.int64), shard) > 0
                return _sum_over((~local).to(torch.int64), shard) == 0
        if kind == "lost" and len(tagged) == 1 and not wholes:
            if name in _EXTREMA:
                return _extremum(name, func, plain_args, plain_kwargs, tagged[0], shard)
            if name == "logsumexp":
                return _logsumexp(plain_args, plain_kwargs, tagged[0], shard)
        # cuts, selects, reorders or mixes the rows: on the whole rows
        return _on_whole(func, args, kwargs)


def _in_place_on_whole(func, args, kwargs):
    """An in-place write to a tagged tensor that moves along its rows: on a
    whole copy, whose rows of this rank are written back."""
    target = args[0]
    full = _gather(target).clone()
    _on_whole(func, (full,) + tuple(args[1:]), kwargs)
    _plain_call(torch.Tensor.copy_, (target._t, _cut(full, target._shard, target._axis)), {})
    return None if _fn_name(func) == "__setitem__" else target


def _draw(func, name, args, kwargs, t, in_place):
    """A draw from tagged parameters on an explicit generator, as a sample
    site draws: the whole from the gathered parameters, then this rank's
    rows where the draw keeps them."""
    if kwargs.get("generator") is None:
        _refuse(f"a random draw from tagged parameters on torch's global generator outside a "
                f"sample site ({name}; give it generator=)")
    if in_place:
        return _in_place_on_whole(func, args, kwargs)
    out = _on_whole(func, args, kwargs)
    shard, axis = t._shard, t._axis
    if isinstance(out, torch.Tensor) and out.dim() >= -axis and out.shape[axis] == shard.size:
        return DataShardTensor(_cut(out, shard, axis), shard, axis)
    return out


def _tag(out, shard, axis):
    if isinstance(out, torch.Tensor):
        return DataShardTensor(out, shard, axis)
    return out


def _sum_over(partial, shard):
    """The whole data's sum from this rank's ``partial`` one."""
    if shard.group is None:
        return partial
    return _SumOverData.apply(partial, shard.group)
