"""The rows of a data shard, carried through ops.

The JAX package's ``shard_data`` returns one global array laid out over the
mesh's ``data`` axis: any op on it is an op on the whole data, and XLA turns
each reduction over the rows into a sum over the data axis.  The port's
``shard_data`` gives a rank its own rows only, as a :class:`DataShardTensor`:
a ``torch.Tensor`` subclass that holds the plain tensor of those rows
(``local_rows``) and which of its axes is the sharded one, and that passes
both on through every op (``__torch_function__``).  The rules:

- an op that keeps the sharded axis whole keeps the tag: elementwise ops,
  casts and moves, column slices and other indexing that leaves the axis
  alone, products along other axes (``X @ w``), reductions over other axes,
  reshapes that keep the axis as one dim;
- a sum over the sharded axis (``sum``, ``mean``, ``count_nonzero``,
  ``all``, ``any``, a product that contracts the axis: ``X.T @ y``) is this
  rank's partial sum, summed over the data group (:class:`_SumOverData`,
  one ``all_reduce``): the result is the whole data's, replicated, with no
  tag.  Its gradient is exact: where a tensor that every rank holds (a
  latent ``w``) enters an op with a tagged one, it passes through
  :class:`_EnterShard`, the identity whose backward sums the cotangent over
  the group (Megatron-LM's pair of operators), so that ``w``'s gradient is
  the whole data's on every rank.  Both run inside ``torch.func`` transforms:
  their ``vmap`` rules leave the ``vmap`` and make one collective for every
  chain.  A sample site's log-density over tagged rows is such a sum, so the
  potential and its gradient are the whole data's;
- anything else that mixes, reorders or cuts the sharded axis raises
  ``NotImplementedError`` (``ROADMAP.md``): a row slice, ``torch.cat`` or a
  pairwise op along it, ``sort``, ``cumsum``, ``softmax`` along it, another
  reduction over it (``max``, ``logsumexp``), selection by value, and a read
  of the rows on the host (``tolist``, ``numpy``, ``item``).  So is an
  untagged tensor of the rank's own row count meeting the rows, and a
  random draw from tagged parameters outside a sample site (each rank would
  draw its own count from one generator).

Where an op takes the sharded axis is read off the op itself: it is run
once on ``meta`` tensors in which the sharded axis has a size no real tensor
has (:data:`_PROBE_ROWS`), and the axis is found by that size in the result
(cached per op and the arguments' shapes and values).  Names decide only
what the probe cannot: moves to another device, reshapes and expands to
sizes taken from the rank's own shape (matched by their sizes), what a
reduction that loses the axis means (a sum, a mean, or a refusal), ops that
keep the axis's size but reorder or mix along it, random draws, in-place
writes and reads on the host.
"""

from __future__ import annotations

import copy
import math
from collections import OrderedDict
from contextlib import contextmanager

import torch

__all__ = ["DataShard", "DataShardTensor", "distribution_shard", "local_rows", "shard_of"]

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


def _all_reduce(x, group):
    # imported here: mesh imports this module
    from numpyro_tpu_torch.parallel.mesh import all_reduce

    return all_reduce(x, group, over_data=True)


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
        if in_dims[0] is None:
            return _SumOverData.apply(x, group), None
        return _SumOverData.apply(x.movedim(in_dims[0], 0), group), 0


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


def shard_of(x):
    """The :class:`DataShard` whose rows ``x`` holds, or ``None``."""
    return x._shard if isinstance(x, DataShardTensor) else None


def local_rows(x):
    """The plain tensor of a :class:`DataShardTensor`'s rows (``x`` as it
    is otherwise): what the GLM op and the subsample gather read."""
    return x._t if isinstance(x, DataShardTensor) else x


def distribution_shard(fn):
    """The :class:`DataShard` of the first tagged parameter of the
    distribution ``fn`` (searched through the distributions it wraps), or
    ``None``."""
    if not _PARTIAL_MADE:
        return None
    from numpyro_tpu_torch.distributions import Distribution

    seen = set()

    def find(obj, depth):
        if isinstance(obj, DataShardTensor):
            return obj._shard
        if depth > 4 or id(obj) in seen:
            return None
        seen.add(id(obj))
        if isinstance(obj, Distribution):
            values = vars(obj).values()
        elif isinstance(obj, (list, tuple)):
            values = obj
        elif isinstance(obj, dict):
            values = obj.values()
        else:
            return None
        for v in values:
            found = find(v, depth + 1)
            if found is not None:
                return found
        return None

    return find(fn, 0)


_LOCAL_DRAWS = []


@contextmanager
def local_draws():
    """Context in which random draws from tagged parameters are allowed: a
    sample site that draws over a shard's rows, on a generator of the
    rank's own (``primitives.default_process_message``)."""
    _LOCAL_DRAWS.append(True)
    try:
        yield
    finally:
        _LOCAL_DRAWS.pop()


def _fn_name(func):
    name = getattr(func, "__name__", "")
    if name == "__get__":
        return "get:" + getattr(getattr(func, "__self__", None), "__name__", "")
    return name


# moves to another device or type, which meta tensors cannot make: they
# keep the axis where it is, as a draw at a sample site does
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


def _refuse(what):
    raise NotImplementedError(
        f"{what} on the rows of a data shard (parallel.shard_data) would give this rank's "
        f"rows alone: the port does not run it on data shards {_ROADMAP}")


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


def _signature(x):
    """A stand-in for an argument of a probe, by value: its shape, dtype and
    tag for a tensor, its bounds for a slice, itself otherwise.  Raises
    :class:`_Uncached` for an argument that cannot be hashed, or a slice
    bound that is a tensor (the probe's result depends on its value)."""
    if isinstance(x, DataShardTensor):
        return ("S", tuple(x._t.shape), x._t.dtype, x._axis)
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, slice):
        bounds = (x.start, x.stop, x.step)
        if any(isinstance(b, torch.Tensor) for b in bounds):
            raise _Uncached
        return ("slice",) + tuple(_signature(b) for b in bounds)
    try:
        hash(x)
    except TypeError:
        raise _Uncached from None
    return ("v", type(x).__name__, x)


def _meta(x):
    """The probe's stand-in of an argument: a meta tensor of the same shape
    and dtype, its sharded axis ``_PROBE_ROWS`` long."""
    if isinstance(x, DataShardTensor):
        shape = list(x._t.shape)
        shape[x._axis] = _PROBE_ROWS
        return torch.empty(shape, dtype=x._t.dtype, device="meta")
    return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")


_PROBES = OrderedDict()


def _probe(func, args, kwargs):
    """Where ``func`` puts the sharded axis: ``("keep", axes)`` with the
    negative axis of each tensor output (``None`` for an output without
    it), or ``("lost", None)`` where no output keeps it, or ``("fail",
    None)`` where the op cannot run on meta tensors."""
    try:
        key = (func, _signature(args), _signature(kwargs))
    except _Uncached:
        key = None
    hit = None if key is None else _PROBES.get(key)
    if hit is not None:
        _PROBES.move_to_end(key)
        return hit
    try:
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*_walk(args, _meta), **_walk(kwargs, _meta))
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


def _reorders_axis(name, args, kwargs, tagged):
    if name not in _ALONG and name.rstrip("_") not in _ALONG:
        return False
    name = name if name in _ALONG else name.rstrip("_")
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
        if name in _PLAIN or name.startswith("get:_") or name == "get:grad":
            with torch._C.DisableTorchFunctionSubclass():
                return func(*plain_args, **plain_kwargs)
        if not tagged:  # a subclass op reached with no tagged argument
            with torch._C.DisableTorchFunctionSubclass():
                return func(*plain_args, **plain_kwargs)
        shard = tagged[0]._shard
        if not shard.partial:
            # every row (a mesh of one data shard): the tag has nothing to keep
            with torch._C.DisableTorchFunctionSubclass():
                return func(*plain_args, **plain_kwargs)
        if _LOCAL_DRAWS:
            # a draw over the rows: an untagged tensor of the rank's row count
            # holds the draw's own rows (each row's noise)
            axis = tagged[0]._axis

            def as_rows(x):
                if not isinstance(x, DataShardTensor) and x.dim() >= -axis \
                        and x.shape[axis] == shard.rows:
                    return DataShardTensor(x, shard, axis)
                return x

            args, kwargs = _walk(args, as_rows), _walk(kwargs, as_rows)
            tagged.clear()
            plain_args, plain_kwargs = _walk(args, strip), _walk(kwargs, strip)
        for t in tagged[1:]:
            if not t._shard.same_rows(shard):
                raise ValueError(
                    f"{name} meets the rows of two data shards ({shard} and {t._shard}): "
                    "shard every tensor of the data along its rows on one mesh")
        if name in _HOST:
            _refuse(f"reading the rows on the host ({name})")
        if "out" in kwargs:
            _refuse(f"{name}(..., out=)")
        random = name in _RANDOM or name.rstrip("_") in _RANDOM
        if random and not _LOCAL_DRAWS:
            _refuse(f"a random draw from tagged parameters outside a sample site ({name})")
        in_place = name.endswith("_") and not name.startswith("__") or name in (
            "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ipow__",
            "__iand__", "__ior__", "__ixor__", "copy_")
        if in_place:
            target = args[0] if args else None
            if not isinstance(target, DataShardTensor):
                _refuse(f"writing the rows into a tensor that does not carry their tag ({name})")
        if _untagged_of_local_rows(args, kwargs, tagged, shard):
            _refuse(f"{name} of the rows with an untagged tensor of this rank's row count "
                    f"({shard.rows}; a tensor sized from the shard's own shape)")
        if shard.group is not None:
            # a tensor every rank holds alike enters an op with the rows: its
            # gradient gathers every rank's part
            group = shard.group

            def enter(x):
                if isinstance(x, DataShardTensor):
                    return x._t
                return _EnterShard.apply(x, group) if x.requires_grad else x

            plain_args, plain_kwargs = _walk(args, enter), _walk(kwargs, enter)

        if name == "__setitem__":
            kind, axes = _probe(torch.Tensor.__getitem__, (args[0], args[1]), {})
            if kind != "keep" or axes[0] is None:
                _refuse("writing to a slice of the rows")
            with torch._C.DisableTorchFunctionSubclass():
                func(*plain_args, **plain_kwargs)
            return None
        if in_place:
            if _reorders_axis(name, args, kwargs, tagged):
                _refuse(f"{name} along the rows")
            with torch._C.DisableTorchFunctionSubclass():
                func(*plain_args, **plain_kwargs)
            return args[0]

        if name in _MOVES or random:
            # a move, or a sample site's draw of each row from its own
            # parameters (some draws have no meta kernel)
            with torch._C.DisableTorchFunctionSubclass():
                out = func(*plain_args, **plain_kwargs)
            axis = tagged[0]._axis
            if random and not (out.dim() >= -axis and out.shape[axis] == shard.rows):
                _refuse(f"{name}, which draws across the rows")
            return _tag(out, shard, axis)

        if name in _RESHAPES or name in _EXPANDS:
            with torch._C.DisableTorchFunctionSubclass():
                out = func(*plain_args, **plain_kwargs)
            t = tagged[0]
            if name in _EXPANDS:
                axis = t._axis if out.dim() >= -t._axis and out.shape[t._axis] == shard.rows \
                    else None
            else:
                axis = _reshaped_axis(tuple(t._t.shape), t._axis, tuple(out.shape))
            if axis is None:
                _refuse(f"{name} that splits or merges the rows with another axis")
            return _tag(out, shard, axis)

        if _reorders_axis(name, args, kwargs, tagged):
            _refuse(f"{name} along the rows")
        kind, axes = _probe(func, args, kwargs)
        if kind == "keep":
            with torch._C.DisableTorchFunctionSubclass():
                out = func(*plain_args, **plain_kwargs)
            if isinstance(out, (tuple, list)):
                return type(out)([_tag(o, shard, a) if a is not None else o
                                  for o, a in zip(out, axes)])
            return _tag(out, shard, axes[0])
        if kind == "lost" and (name in _SUMS or name in _PRODUCTS):
            with torch._C.DisableTorchFunctionSubclass():
                out = func(*plain_args, **plain_kwargs)
            return _sum_over(out, shard)
        if kind == "lost" and name in _MEANS:
            # the partial sum over the same dims, divided by the whole count,
            # which has the shard's size in place of its rows
            summer = torch.nansum if name == "nanmean" else torch.sum
            with torch._C.DisableTorchFunctionSubclass():
                partial = summer(*plain_args, **plain_kwargs)
            count = tagged[0]._t.numel() // max(partial.numel(), 1)
            return _sum_over(partial, shard) / (count // shard.rows * shard.size)
        if kind == "lost" and name in _ANY_ALL:
            with torch._C.DisableTorchFunctionSubclass():
                local = func(*plain_args, **plain_kwargs)
            if name == "any":
                return _sum_over(local.to(torch.int64), shard) > 0
            return _sum_over((~local).to(torch.int64), shard) == 0
        if kind == "many":
            _refuse(f"{name} of the rows against themselves (pairwise)")
        if kind == "fail":
            with torch._C.DisableTorchFunctionSubclass():
                func(*plain_args, **plain_kwargs)  # the op's own error, if it has one
            _refuse(f"{name}, whose treatment of the rows cannot be read off its shapes")
        _refuse(f"{name}, which reduces, cuts or selects along the rows")


def _tag(out, shard, axis):
    if isinstance(out, torch.Tensor):
        return DataShardTensor(out, shard, axis)
    return out


def _sum_over(partial, shard):
    """The whole data's sum from this rank's ``partial`` one."""
    if shard.group is None:
        return partial
    return _SumOverData.apply(partial, shard.group)
