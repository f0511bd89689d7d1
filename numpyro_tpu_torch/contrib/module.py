"""A bridge that registers a ``torch.nn.Module``'s parameters as sites (the
port's counterpart of ``numpyro_tpu/contrib/module.py``'s ``nnx_module`` and
``random_nnx_module``).

The JAX module's bridges take flax and haiku modules, which the port cannot
take; their job, an eagerly built network applied functionally inside a
model, is ``torch.nn.Module`` with ``torch.func.functional_call``:

- :func:`torch_module` turns the module's ``named_parameters()`` into one
  ``param`` site ``name$params``, a dict keyed by the dotted names with
  initial values copied from the module (on its device), and its buffers
  into the ``mutable`` site ``name$state``; it returns a callable that
  applies the module to the site's values.  A buffer that the module
  updates while it runs (``BatchNorm`` in train mode) is written back to
  the ``mutable`` site detached, the counterpart of the JAX bridge's
  ``stop_gradient``.  A module without buffers has no ``mutable`` site (the
  nnx bridge registers an empty one).
- :func:`random_torch_module` lifts the parameters to ``sample`` sites under
  a prior (a Bayesian neural network): ``name/<dotted name>``, every
  parameter or those named in a dict prior, each leaving a
  :class:`ParamShape` placeholder in the ``param`` site.  It runs under the
  batched potential of ``NUTS`` with chains, which maps the model with
  ``torch.func.vmap``: ``functional_call`` with batched parameters is
  PyTorch's ensembling pattern.  A buffer update in place cannot run under
  ``vmap``; the callable raises then, naming the module (put it in eval
  mode).
- :func:`params_from_linen` (``nn.util``) carries a flax linen network's
  weights into the module, for parity with the JAX package's examples.

Site names follow the module's own parameter names (``bnn/0.weight``),
where the JAX bridges follow flax's (``bnn/Dense_0.kernel``), and a
``Linear`` weight ``(out, in)`` is the transpose of a ``Dense`` kernel.
"""

from __future__ import annotations

from collections import namedtuple
from functools import partial

from torch.func import functional_call

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.distributions.distribution import Distribution
from numpyro_tpu_torch.nn.util import params_from_linen
from numpyro_tpu_torch.primitives import mutable, param, sample

__all__ = ["params_from_linen", "random_torch_module", "torch_module"]

ParamShape = namedtuple("ParamShape", ["shape"])
"""Shape-only placeholder left in a param site once its value has been
lifted to a sample site: it keeps the structure for later runs without
giving the optimizer anything to update."""


def _sample_leaf(site_name, leaf, prior):
    """Draw a prior sample shaped like ``leaf`` (all its dims event dims)."""
    shape = tuple(leaf.shape)
    if isinstance(prior, dict):
        d = prior[site_name]
    elif callable(prior) and not isinstance(prior, Distribution):
        d = prior(site_name, shape)
    else:
        d = prior
    batch = shape[: len(shape) - d.event_dim]
    return sample(site_name, d.expand(batch).to_event())


def _bayesianize(scope_name, params, prior):
    """Replace the selected entries of a param dict (keyed by dotted names)
    with prior samples: every entry, or those a dict ``prior`` names.
    ``params`` is changed in place to hold :class:`ParamShape` markers (so
    the optimizer skips them on later traces); returns a new dict with the
    sampled values."""
    sampled = dict(params)
    with handlers.scope(prefix=scope_name):
        for path, leaf in params.items():
            if not isinstance(prior, dict) or path in prior:
                sampled[path] = _sample_leaf(path, leaf, prior)
                if not isinstance(leaf, ParamShape):
                    params[path] = ParamShape(tuple(leaf.shape))
    return sampled


def _apply(name, nn_module, holder, params, *args, **kwargs):
    """``nn_module`` applied to ``params`` and the buffers held in
    ``holder`` (``None``: the module has none), whose updates go back into
    ``holder`` detached."""
    tensors = dict(params)
    buffers = {}
    if holder is not None:
        # the module updates its buffers in place: on copies, so that the
        # held state stays as it was
        buffers = {k: v.clone() for k, v in holder.items()}
        tensors.update(buffers)
    try:
        out = functional_call(nn_module, tensors, args, kwargs)
    except RuntimeError as e:
        if buffers and nn_module.training and ("batched" in str(e) or "vmap" in str(e)):
            raise RuntimeError(
                f"torch_module({name!r}): the module updates its buffers in place while it runs "
                "(BatchNorm in train mode), which cannot run under torch.func.vmap (a batched "
                "potential with chains, vectorized particles); call nn_module.eval() or run "
                "one chain or particle at a time"
            ) from e
        raise
    for k, v in buffers.items():
        holder[k] = v.detach()
    return out


def torch_module(name, nn_module):
    """Register the parameters of ``nn_module``, a built ``torch.nn.Module``,
    as the ``param`` site ``name + "$params"`` and its buffers as the
    ``mutable`` site ``name + "$state"``; returns a callable that applies
    the module to the sites' values::

        net = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.ReLU(),
                                  torch.nn.Linear(8, 1))   # built outside the model
        def model(x, y=None):
            out = torch_module("net", net)(x)
            ...
    """
    eager_params = dict(nn_module.named_parameters())
    eager_buffers = dict(nn_module.named_buffers())
    nn_params = param(name + "$params") if eager_params else None
    if nn_params is None:
        nn_params = param(name + "$params",
                          {k: v.detach().clone() for k, v in eager_params.items()})
    holder = None
    if eager_buffers:
        holder = mutable(name + "$state")
        if holder is None:
            holder = mutable(name + "$state",
                             {k: v.detach().clone() for k, v in eager_buffers.items()})
    return partial(_apply, name, nn_module, holder, nn_params)


def random_torch_module(name, nn_module, prior):
    """:func:`torch_module` with a prior over the module's parameters: a
    ``Distribution`` for every parameter, a dict from dotted names to
    distributions for those it names, or a callable ``prior(site_name,
    shape)`` returning one.  Each lifted parameter is the sample site
    ``name/<dotted name>``."""
    nn = torch_module(name, nn_module)
    return partial(nn.func, *nn.args[:3], _bayesianize(name, nn.args[3], prior))
