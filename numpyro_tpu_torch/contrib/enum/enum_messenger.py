"""Parallel enumeration of discrete latent sites (port of
``numpyro_tpu/contrib/enum/enum_messenger.py``: ``enum``,
``config_enumerate`` and ``markov``).

Each enumerable latent site takes its whole support as its value, laid along
a fresh negative dim to the left of every plate dim
(``first_available_dim``); the log-probs downstream broadcast against these
dims, and ``infer_util.log_density`` sums them out.  Inside ``markov`` a
chain of sites recycles ``history + 1`` dims, so its length never grows the
rank of a tensor.

Dims are capped twice.  The JAX package's budget of 25 enumeration dims
stands.  Besides, a CUDA elementwise kernel takes at most 25 dims
(``MAX_DIMS`` of ATen's ``OffsetCalculator``), and every ``torch.func.vmap``
around the model (the chains of a run, the particles of an ELBO, the steps
of an enumerated ``scan``) adds one dim to each tensor that the model does
not see: a site whose plate and enumeration dims and those vmap dims pass 25
raises here, on every device, before any kernel is launched.
"""

from __future__ import annotations

import torch

from numpyro_tpu_torch.handlers import infer_config
from numpyro_tpu_torch.primitives import Messenger

__all__ = ["config_enumerate", "enum", "markov"]

# the enumeration dim given to a site, in its infer dict
ENUM_DIM_KEY = "_enum_dim"
# the serial number that tells apart successive variables on one dim
ENUM_SERIAL_KEY = "_enum_serial"
# the JAX package's budget of enumeration dims
MAX_ENUM_DIMS = 25
# the most dims a CUDA elementwise kernel takes (ATen's OffsetCalculator)
MAX_TENSOR_DIMS = 25

# the active markov frames: dicts {"period", "slot", "base"}
_MARKOV_STACK = []


def vmap_depth():
    """The count of ``torch.func.vmap`` levels around the caller, each of
    which adds a dim to the tensors it maps."""
    stack = torch._C._functorch.get_interpreter_stack() or []
    return sum(1 for level in stack if level.key() == torch._C._functorch.TransformType.Vmap)


class enum(Messenger):
    """Give each enumerable latent site its expanded support as its value.

    :param first_available_dim: the rightmost dim free for enumeration, a
        negative integer left of every plate dim (``-1 - max_plate_nesting``).
    """

    def __init__(self, fn=None, first_available_dim=None):
        assert first_available_dim is not None and first_available_dim < 0
        self.first_available_dim = first_available_dim
        super().__init__(fn)

    def __enter__(self):
        self._next_dim = self.first_available_dim
        self._serial = 0
        return super().__enter__()

    def process_message(self, msg):
        if msg["type"] == "control_flow" and "history" in msg["kwargs"]:
            # an effectful scan below: it enumerates its carried discrete on
            # a recycled dim pair, sums out its time block and returns one
            # factor into this scope
            msg["kwargs"]["enum"] = True
            msg["kwargs"]["first_available_dim"] = self._next_dim
            msg["kwargs"]["enum_boundary"] = self.first_available_dim
            return
        if msg["type"] != "sample" or msg["is_observed"] or msg["value"] is not None:
            return
        fn = msg["fn"]
        if not fn.has_enumerate_support or msg["infer"].get("enumerate") != "parallel":
            return
        if ENUM_DIM_KEY in msg["infer"]:
            return

        if _MARKOV_STACK:
            # inside markov: a pool of history + 1 dims, recycled
            frame = _MARKOV_STACK[-1]
            if frame.get("base") is None:
                frame["base"] = self._next_dim
                self._next_dim -= frame["period"]
            dim = frame["base"] - (frame["slot"] % frame["period"])
        else:
            dim = self._next_dim
            self._next_dim -= 1
        if self.first_available_dim - dim >= MAX_ENUM_DIMS:
            raise RuntimeError(f"Exceeded the enumeration dim budget of {MAX_ENUM_DIMS}.")
        mapped = vmap_depth()
        if -dim + mapped > MAX_TENSOR_DIMS:
            raise RuntimeError(
                f"site {msg['name']!r} needs {-dim} plate and enumeration dims and runs "
                f"under {mapped} vmap dim(s): {-dim + mapped} dims in all, more than the "
                f"{MAX_TENSOR_DIMS} that a CUDA elementwise kernel takes"
            )
        support = fn.enumerate_support(expand=False)
        size = support.shape[0]
        msg["value"] = support.reshape((size,) + (1,) * (-dim - 1) + tuple(fn.event_shape))
        msg["infer"][ENUM_DIM_KEY] = dim
        msg["infer"][ENUM_SERIAL_KEY] = self._serial
        self._serial += 1
        msg["infer"]["_enum_size"] = size
        # the site is enumerated, not drawn
        msg["kwargs"]["rng_key"] = None


def config_enumerate(fn=None, default="parallel"):
    """Mark every latent site of finite support with
    ``infer={"enumerate": default}`` unless it is configured already."""

    def config_fn(msg):
        if (
            msg["type"] == "sample"
            and not msg.get("is_observed", False)
            and msg["fn"].has_enumerate_support
            and msg["infer"].get("enumerate") is None
        ):
            return {"enumerate": default}
        return {}

    if fn is None:  # a decorator factory
        return lambda f: config_enumerate(f, default=default)
    return infer_config(fn, config_fn=config_fn)


def markov(iterable=None, history=1):
    """Mark a history-limited dependency: the enumerated sites of successive
    iterations recycle ``history + 1`` dims, and the density sums out each
    recycled variable in site order (the forward algorithm)::

        for t in markov(range(T), history=1):
            z = sample(f"z_{t}", ..., infer={"enumerate": "parallel"})

    ``with markov():`` is the context form, whose every entry is one step.
    """
    if iterable is None:
        return _MarkovFrame(history)
    if isinstance(iterable, int):
        iterable = range(iterable)

    def steps():
        frame = {"period": history + 1, "slot": 0, "base": None}
        _MARKOV_STACK.append(frame)
        try:
            for i, item in enumerate(iterable):
                frame["slot"] = i
                yield item
        finally:
            _MARKOV_STACK.remove(frame)

    return steps()


class _MarkovFrame:
    """The context form of :func:`markov`: each entry advances the slot."""

    def __init__(self, history):
        self.frame = {"period": history + 1, "slot": -1, "base": None}

    def __enter__(self):
        if self.frame not in _MARKOV_STACK:
            _MARKOV_STACK.append(self.frame)
        self.frame["slot"] += 1
        return self

    def __exit__(self, *args):
        return False
