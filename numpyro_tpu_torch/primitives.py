"""Model-DSL primitives and the effect-handler message stack (port of
``numpyro_tpu/primitives.py`` but for ``flax_module``, a bridge to flax:
``Messenger``, ``apply_stack``, ``sample`` with ``obs_mask``, ``param``,
``mutable``, ``factor``, ``deterministic``, ``plate``, ``plate_stack``,
``subsample``, ``get_mask`` and ``module``).

The handler stack is plain Python that runs whenever the model runs.  Under
``torch.func`` transforms (the chain-batched potential) the model runs once
per batched evaluation, and only the summed log density leaves it.

Subsample indices are ``int64`` tensors everywhere (what ``torch.topk``
returns and what every indexing path under ``vmap`` accepts); the JAX package
keeps them as ``int32``.

A tensor from ``parallel.shard_data`` holds one rank's rows of the data, where
the JAX package's sharded array is the whole array; its tag rides through
every op (``parallel.data_shard``), and a sum over its rows is the whole
data's.  A sample site over tagged rows (an observed value, a distribution
whose parameters carry the tag) is scored on the rank's rows, and the
potential's sum over them is the whole data's.  A plate over such rows has
the whole data's size ``N`` and takes the rank's rows as its ``N`` rows; a
plate of the rank's own count (``X.shape[0]``) raises.  ``subsample`` under
a plate of size ``N`` that subsamples the rows takes the whole data's panel
(``parallel.mesh.subsample_shard``); with no plate, or one that does not
subsample the rows, it returns them as they are, as the JAX package returns
its global array.  A site with no observed value whose distribution holds
tagged rows is whole on every rank, decided once, in :func:`sample`: its
message carries the whole data's distribution (its parameters gathered,
``parallel.data_shard.whole_site``), so that every handler and every
consumer of a trace (the init strategies, the supports' bijections, the
autoguides, the reparametrizers) reads the whole distribution and its
support, and ``msg["_whole_rows"]`` says where the rank's rows lie in it.
Its draw is the whole data's, from the site's generator, which stays in
step on every rank: it equals the one-process draw on the whole data,
inside a ``torch.func`` transform too; ``Predictive`` returns the rank's
rows of it.
"""

from __future__ import annotations

import functools
import warnings
from collections import namedtuple
from contextlib import ExitStack, contextmanager

import torch

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch.distributions.util import broadcast_shape
from numpyro_tpu_torch.parallel.data_shard import (
    distribution_shard, shard_of, whole_distribution, whole_site,
)
from numpyro_tpu_torch.util import identity

__all__ = [
    "CondIndepStackFrame", "Messenger", "apply_stack", "deterministic", "factor",
    "get_mask", "module", "mutable", "param", "plate", "plate_stack", "prng_key", "sample",
    "subsample",
]

CondIndepStackFrame = namedtuple("CondIndepStackFrame", ["name", "dim", "size", "subsample_size"])

_PYRO_STACK = []


def default_process_message(msg):
    if msg["value"] is None:
        if msg["type"] == "sample":
            # a distribution over a data shard's rows that a handler put on
            # the site draws the whole data's rows too
            fn = whole_distribution(msg["fn"])
            msg["value"], msg["intermediates"] = fn(
                *msg["args"], sample_intermediates=True, **msg["kwargs"]
            )
        else:
            msg["value"] = msg["fn"](*msg["args"], **msg["kwargs"])


def apply_stack(msg):
    """Route a message bottom-up (process) then top-down (postprocess); a
    handler setting ``msg["stop"]`` truncates the upward pass."""
    stop_at = 0
    for idx in range(len(_PYRO_STACK) - 1, -1, -1):
        _PYRO_STACK[idx].process_message(msg)
        if msg.get("stop"):
            stop_at = idx
            break
    if msg["value"] is None:
        default_process_message(msg)
    for idx in range(stop_at, len(_PYRO_STACK)):
        _PYRO_STACK[idx].postprocess_message(msg)
    return msg


class Messenger:
    """Base effect handler: a context manager on the global stack."""

    def __init__(self, fn=None):
        if fn is not None and not callable(fn):
            raise ValueError(
                "Expected `fn` to be a Python callable object; "
                f"instead found type(fn) = {type(fn)}."
            )
        self.fn = fn
        functools.update_wrapper(self, fn, updated=[])

    def __enter__(self):
        _PYRO_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if exc_type is None:
            assert _PYRO_STACK[-1] is self
            _PYRO_STACK.pop()
        elif self in _PYRO_STACK:
            del _PYRO_STACK[_PYRO_STACK.index(self):]

    def process_message(self, msg):
        pass

    def postprocess_message(self, msg):
        pass

    def __call__(self, *args, **kwargs):
        with self:
            return None if self.fn is None else self.fn(*args, **kwargs)


def _dispatch(msg_type, name=None, fn=identity, value=None, kwargs=None, **extras):
    msg = {
        "type": msg_type,
        "name": name,
        "fn": fn,
        "args": (),
        "kwargs": {} if kwargs is None else kwargs,
        "value": value,
        "cond_indep_stack": [],
    }
    msg.update(extras)
    return apply_stack(msg)


def _masked_observe(name, fn, obs, obs_mask, **kwargs):
    """A partly observed site as two: ``{name}_unobserved``, a latent of the
    whole shape whose density is masked out, and ``{name}_observed``, scored
    at the data where ``obs_mask`` holds and at the latent elsewhere; their
    merged value is the deterministic ``{name}``."""
    value = sample(f"{name}_unobserved", fn.mask(False), **kwargs)
    if obs is not None:
        keep = obs_mask.reshape(tuple(obs_mask.shape) + (1,) * fn.event_dim)
        value = torch.where(keep, obs, value)
    sample(f"{name}_observed", fn, **kwargs, obs=value, obs_mask=None)
    return deterministic(name, value)


def sample(name, fn, obs=None, rng_key=None, sample_shape=(), infer=None, obs_mask=None):
    """Declare a random variable.  ``rng_key`` is a ``torch.Generator``; a
    boolean ``obs_mask`` (broadcast over the batch of ``fn``) marks the
    entries of ``obs`` that are observed, the rest being latent."""
    if not isinstance(fn, dist.Distribution):
        raise TypeError(f"sample() fn must be a Distribution, got {fn!r}")
    if not _PYRO_STACK:
        if obs is not None:
            return obs
        if rng_key is None:
            raise ValueError(
                "Cannot call `sample` outside an inference context without "
                "an explicit rng_key."
            )
        return fn(rng_key=rng_key, sample_shape=sample_shape)
    if obs_mask is not None:
        return _masked_observe(
            name, fn, obs, obs_mask, rng_key=rng_key, sample_shape=sample_shape, infer=infer
        )
    rows = None
    if obs is None:
        # over a data shard's rows, a site with no observed value is whole
        fn, rows = whole_site(fn)
    return _dispatch(
        "sample",
        name,
        fn,
        value=obs,
        kwargs={"rng_key": rng_key, "sample_shape": sample_shape},
        scale=None,
        is_observed=obs is not None,
        intermediates=[],
        infer={} if infer is None else infer,
        _whole_rows=rows,
    )["value"]


def param(name, init_value=None, **kwargs):
    """Declare an optimizable parameter.  ``kwargs`` are ``constraint`` (the
    support of the value, ``constraints.real`` by default) and ``event_dim``;
    a callable ``init_value`` is called with the generator of the innermost
    ``seed`` handler."""
    if not _PYRO_STACK:
        if callable(init_value):
            raise ValueError(
                "A callable init_value needs to be put inside a numpyro_tpu_torch handler."
            )
        return init_value

    if callable(init_value):

        def initial_fn(*args, **kw):
            return init_value(prng_key())

    else:

        def initial_fn(*args, **kw):
            return init_value

    return _dispatch("param", name, initial_fn, kwargs=kwargs, scale=None)["value"]


def mutable(name, init_value=None):
    """A mutable state site, threaded through SVI steps."""
    if not _PYRO_STACK:
        return init_value
    return _dispatch("mutable", name, lambda *a, **k: init_value, value=init_value)["value"]


def prng_key():
    """The generator of the innermost ``seed`` handler (JAX's ``prng_key``
    draws a fresh split key there; the port's generator advances with every
    draw instead).  ``None`` outside any handler or without a ``seed``."""
    if not _PYRO_STACK:
        return None
    return _dispatch(
        "prng_key", fn=lambda rng_key: rng_key, kwargs={"rng_key": None}
    )["value"]


def deterministic(name, value):
    """Record a deterministic function of other sites in the trace."""
    if not _PYRO_STACK:
        return value
    return _dispatch("deterministic", name, lambda *a, **k: value, value=value)["value"]


def get_mask():
    """The effective mask at the current point in the handler stack."""
    return _dispatch("inspect", fn=lambda: True, mask=None)["mask"]


def subsample(data, event_dim):
    """Subselect ``data`` along the dims of the active subsampled plates.  A
    data shard's rows (``parallel.shard_data``) give the whole data's rows at
    the plate's indices under a plate that subsamples their sharded axis,
    and come back as they are otherwise."""
    if not _PYRO_STACK:
        return data
    assert isinstance(event_dim, int) and event_dim >= 0
    extras = {}
    shard = shard_of(data)
    if shard is not None:
        extras = {"_data_shard": shard, "_data_shard_dim": data._axis}
    msg = _dispatch(
        "subsample", fn=lambda *a, **k: data, value=data, kwargs={"event_dim": event_dim},
        **extras,
    )
    return msg["value"]


class plate(Messenger):
    """Conditional-independence context: takes a negative batch dim,
    broadcasts sample sites into it, scales their log-prob by
    ``size / subsample_size`` under subsampling, and subselects ``subsample``
    values and ``param`` values declared with an ``event_dim`` along its dim
    (a param's gradient scatters back into the rows drawn)."""

    def __init__(self, name, size, subsample_size=None, dim=None):
        self.name = name
        assert size > 0, "size of plate should be positive"
        self.size = size
        if dim is not None and dim >= 0:
            raise ValueError("dim arg must be negative.")
        self.dim, self._indices = self._subsample(self.name, self.size, subsample_size, dim)
        self.subsample_size = self._indices.shape[0]
        super().__init__()

    @staticmethod
    def _subsample_fn(size, subsample_size, rng_key=None):
        if rng_key is None:
            raise ValueError(
                "Missing random key to generate subsample indices. "
                "Algorithms like HMC/NUTS do not support subsampling; "
                "use HMCECS instead."
            )
        # a draw without replacement: the top-k of one uniform per row
        u = torch.rand((size,), generator=rng_key, device=rng_key.device)
        return torch.topk(u, subsample_size).indices

    @staticmethod
    def _subsample(name, size, subsample_size, dim):
        msg = _dispatch(
            "plate",
            name,
            plate._subsample_fn,
            value=(
                None
                if (subsample_size is not None and size != subsample_size)
                else torch.arange(size)
            ),
            kwargs={"rng_key": None},
            args=(size, subsample_size),
            scale=1.0,
        )
        indices = msg["value"]
        subsample_size = msg["args"][1]
        if subsample_size is not None and subsample_size != indices.shape[0]:
            warnings.warn(
                "subsample_size does not match len(subsample), "
                f"{subsample_size} vs {indices.shape[0]}.",
                stacklevel=2,
            )
        occupied_dims = {f.dim for f in msg["cond_indep_stack"]}
        if dim is None:
            dim = -1
            while dim in occupied_dims:
                dim -= 1
        else:
            assert dim not in occupied_dims
        return dim, indices

    def __enter__(self):
        super().__enter__()
        return self._indices

    def _frame(self):
        return CondIndepStackFrame(self.name, self.dim, self.size, self.subsample_size)

    def _broadcast_into_frame(self, msg):
        """Expand a sample site's batch shape over every enclosing plate dim
        (an explicit sample_shape folds into the batch).  Where the site
        holds a rank's rows of a data shard at a plate's dim, the plate of
        the whole data's size takes them as its rows."""
        stack = msg["cond_indep_stack"]
        rank = max(-f.dim for f in stack)
        plate_shape = [1] * rank
        fn_shape = tuple(msg["fn"].batch_shape)
        local = _shard_rows_at(msg, fn_shape, stack)
        for f in stack:
            plate_shape[f.dim] = local.get(f.dim, f.subsample_size)
        sample_shape = tuple(msg["kwargs"].get("sample_shape", ()))
        if sample_shape:
            fn_shape = sample_shape + fn_shape
            msg["kwargs"]["sample_shape"] = ()
        head = max(rank - len(fn_shape), 0)
        tail = broadcast_shape(tuple(plate_shape[head:]), fn_shape)
        msg["fn"] = msg["fn"].expand(tuple(plate_shape[:head]) + tuple(tail))

    def process_message(self, msg):
        kind = msg["type"]
        if kind == "control_flow":
            raise NotImplementedError(
                "Cannot use control flow primitive under a `plate` primitive."
            )
        if kind not in ("param", "sample", "plate", "deterministic"):
            # "subsample" messages are subselected in postprocess_message
            return
        msg["cond_indep_stack"].append(self._frame())
        if kind == "deterministic":
            return
        if kind == "sample":
            self._broadcast_into_frame(msg)
        if self.size != self.subsample_size:
            correction = self.size / self.subsample_size
            msg["scale"] = correction if msg["scale"] is None else msg["scale"] * correction

    def postprocess_message(self, msg):
        if msg["type"] not in ("subsample", "param"):
            return
        if msg.get("_pregathered"):
            # a handler above already put the subselected panel in place
            return
        event_dim = msg["kwargs"].get("event_dim")
        if event_dim is None:
            return
        axis = self.dim - event_dim
        if msg.get("_data_shard") is not None and axis == msg["_data_shard_dim"] \
                and msg["_data_shard"].partial:
            self._subsample_shard(msg, axis)
            return
        shape = tuple(msg["value"].shape)
        if len(shape) < -axis or shape[axis] == 1:
            return
        if shape[axis] != self.size:
            statement = (
                f"numpyro_tpu_torch.param({msg['name']}, ..., event_dim={event_dim})"
                if msg["type"] == "param"
                else f"numpyro_tpu_torch.subsample(..., event_dim={event_dim})"
            )
            raise ValueError(
                f"Inside plate({self.name}, {self.size}, "
                f"subsample_size={self.subsample_size}) invalid shape of {statement}: {shape}"
            )
        if self.subsample_size < self.size:
            msg["value"] = torch.index_select(msg["value"], axis, self._indices)

    def _subsample_shard(self, msg, axis):
        """The whole data's rows at this plate's indices from a data shard
        (``parallel.mesh.subsample_shard``); ``msg["_partial_over"]`` names
        the data group whose sum a ``defer`` caller still owes."""
        from numpyro_tpu_torch.parallel.mesh import subsample_shard

        shard = msg["_data_shard"]
        if self.size != shard.size:
            raise ValueError(
                f"plate({self.name!r}, {self.size}) subsamples a data shard of {shard.size} "
                f"rows (this rank holds rows {shard.start} to {shard.stop}): give the plate "
                "the whole data's size, not the shard's"
            )
        if self.subsample_size >= self.size:
            return  # every row: the rank's rows, tagged, as they are
        msg["value"], msg["_partial_over"] = subsample_shard(
            msg["value"], axis, self._indices, shard)
        msg["_shard_gathered"] = self.name


def _shard_rows_at(msg, fn_shape, stack):
    """``{plate dim: this rank's row count}`` for the plates of ``stack``
    at whose dim the sample site of ``msg`` holds a rank's rows of a data
    shard (in its distribution's batch shape or its observed value's); a
    plate there must have the whole data's size."""
    shard = distribution_shard(msg["fn"])
    value = msg.get("value")
    shapes = [fn_shape]
    if shard_of(value) is not None:
        shard = shard or shard_of(value)
        shapes.append(tuple(value.shape)[: value.dim() - msg["fn"].event_dim])
    if shard is None or not shard.partial:
        return {}
    local = {}
    for f in stack:
        if any(len(s) >= -f.dim and s[f.dim] == shard.rows for s in shapes):
            if f.size != shard.size:
                raise ValueError(
                    f"plate({f.name!r}, {f.size}) holds the rows of a data shard of "
                    f"{shard.size} rows (this rank holds rows {shard.start} to {shard.stop}): "
                    "give the plate the whole data's size, not the shard's"
                )
            local[f.dim] = shard.rows
    return local


@contextmanager
def plate_stack(prefix, sizes, rightmost_dim=-1):
    """Nested plates ``{prefix}_0`` .. ``{prefix}_{n-1}`` of ``sizes``, on
    dims ``rightmost_dim - n + 1`` .. ``rightmost_dim``: the last size is
    the innermost plate, on ``rightmost_dim``."""
    assert rightmost_dim < 0
    with ExitStack() as stack:
        for i, size in enumerate(reversed(sizes)):
            name = f"{prefix}_{len(sizes) - i - 1}"
            stack.enter_context(plate(name, size, dim=rightmost_dim - i))
        yield


def factor(name, log_factor):
    """Add an arbitrary log-density term via a Unit-distribution site."""
    unit_dist = dist.Unit(log_factor)
    unit_value = torch.zeros(
        tuple(log_factor.shape) + (0,), dtype=log_factor.dtype, device=log_factor.device
    )
    sample(name, unit_dist, obs=unit_value, infer={"is_auxiliary": True})


def module(name, nn, input_shape=None):
    """Declare a network given as an ``(init_fn, apply_fn)`` pair (the
    blocks of :mod:`numpyro_tpu_torch.nn`): its parameters are the ``param``
    site ``name + "$params"``, made on first use by ``init_fn(generator,
    input_shape)`` with the generator of the innermost ``seed`` handler;
    returns ``apply_fn`` bound to them."""
    module_key = name + "$params"
    nn_init, nn_apply = nn
    nn_params = param(module_key)
    if nn_params is None:
        if input_shape is None:
            raise ValueError("Valid value for `input_shape` needed to initialize.")
        generator = prng_key()
        if generator is None:
            raise ValueError(
                "Cannot call `module` outside a `seed` handler without its "
                "parameters: their initialization needs a generator."
            )
        _, nn_params = nn_init(generator, input_shape)
        param(module_key, nn_params)
    return functools.partial(nn_apply, nn_params)
