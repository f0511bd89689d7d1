"""Checkpoint and resume of sampler and SVI states (port of
``numpyro_tpu/checkpoint.py``).

A state (``HMCState``, ``SVIState``, an ensemble's state, a dict of params)
is a tree of namedtuples, dicts, lists and tuples whose leaves are tensors,
Python numbers and ``torch.Generator`` objects.  :func:`save_checkpoint`
writes its leaves, in the order :func:`restore_checkpoint` visits them, with
``torch.save``: each tensor copied to the host, each generator as its
``get_state()`` and its device, each number as it is.  The file holds only
tensors and plain containers, so it loads with ``torch.load(...,
weights_only=True)`` and restoring runs no code, the guarantee that the JAX
package's orbax path gives (its pickle fallback warns that it runs code).

:func:`restore_checkpoint` rebuilds the tree of a ``target`` state from the
file's leaves, after the JAX package's checks: the count of leaves, then
each leaf's shape, each a ``ValueError``.  A tensor lands on the device of
the matching leaf of the target, and a generator is made on the target's
generator's device and given the saved state, so a resumed run draws what
the uninterrupted run would have drawn.  A generator's state does not carry
across device types (a CUDA generator's is a seed and an offset, a CPU
generator's the Mersenne twister): such a generator is seeded from the
saved state and a warning says that its draws differ.

A state whose chains are sharded over ranks (``parallel.shard_chain_state``,
or a per-step run under ``MCMC(chain_method="parallel")``) is gathered by
:func:`save_checkpoint` (every rank calls it), written once, by rank 0, and
the ranks wait for the file before they return.  :func:`restore_checkpoint`
onto a target of the full panel, then ``shard_chain_state``, gives each rank
its rows again, and the resumed run draws what the uninterrupted one would.

Usage::

    mcmc.warmup(0, *args)
    save_checkpoint("/ckpt/warm.pt", mcmc.post_warmup_state)
    ...
    mcmc.post_warmup_state = restore_checkpoint("/ckpt/warm.pt", mcmc.post_warmup_state)
    mcmc.run(0, *args)
"""

from __future__ import annotations

import hashlib
import os
import warnings

import torch

__all__ = ["save_checkpoint", "restore_checkpoint"]

_FORMAT = "numpyro_tpu_torch.checkpoint/1"


def _keys(d):
    """A dict's keys in sorted order, as ``jax.tree`` visits them (so two
    dicts built in another order agree), or in their own order where they
    do not sort."""
    try:
        return sorted(d)
    except TypeError:
        return list(d)


def _leaves(tree):
    """The leaves of a state in a fixed order: tensors, generators and
    numbers; ``None`` is structure, as in ``jax.tree.leaves``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in _keys(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _unflatten(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        values = {k: _unflatten(tree[k], it) for k in _keys(tree)}
        return type(tree)((k, values[k]) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, it) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _saved(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    if isinstance(leaf, torch.Generator):
        return {"generator_state": leaf.get_state(), "device": str(leaf.device)}
    if isinstance(leaf, (bool, int, float, str)):
        return leaf
    raise TypeError(f"save_checkpoint cannot save a leaf of type {type(leaf).__name__}: a state "
                    "holds tensors, generators, numbers, strings and their containers")


def save_checkpoint(path, state, *, async_save=False):
    """Write ``state`` to the file ``path`` (its directory is made if it is
    missing; the file is written beside it and renamed, so a reader never
    sees half a checkpoint).  A state sharded over ranks is gathered first,
    written by rank 0 only, and every rank returns once the file is there.
    ``async_save`` is accepted and not used, as in the JAX package.  Returns
    the absolute path."""
    from numpyro_tpu_torch.infer.hmc_core import ShardedDraws, gather_state
    from numpyro_tpu_torch.parallel.mesh import all_reduce

    path = os.path.abspath(os.fspath(path))
    sharded = [leaf for leaf in _leaves(state)
               if isinstance(leaf, ShardedDraws) and leaf.shard.group is not None]
    if sharded:
        state = gather_state(state)
    if not sharded or torch.distributed.get_rank() == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"format": _FORMAT, "leaves": [_saved(leaf) for leaf in _leaves(state)]}
        partial = path + ".partial"
        torch.save(payload, partial)
        os.replace(partial, path)
    if sharded:
        # every rank waits for rank 0's file (a sum over the world)
        all_reduce(torch.zeros(1, device=sharded[0].generator.device), None)
    return path


def _shape(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return ()


def _is_saved_generator(got):
    return isinstance(got, dict) and "generator_state" in got


def _check_device(device):
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the target state lives on {device}, but this machine has no CUDA "
                           "device: restore onto a target on the CPU")


def _generator_like(want, got):
    """A generator on ``want``'s device in the saved state ``got``."""
    _check_device(want.device)
    generator = torch.Generator(device=want.device)
    saved = torch.device(got["device"])
    if saved.type == want.device.type:
        generator.set_state(got["generator_state"])
        return generator
    digest = hashlib.sha256(got["generator_state"].numpy().tobytes()).digest()
    generator.manual_seed(int.from_bytes(digest[:8], "little") % 2**63)
    warnings.warn(f"a generator saved on {saved} is restored onto {want.device}: its state does "
                  "not carry across device types, so it is seeded from the saved state and the "
                  "resumed run draws other numbers than the uninterrupted run", stacklevel=3)
    return generator


def _restored(want, got, i):
    if isinstance(want, torch.Generator):
        if not _is_saved_generator(got):
            raise ValueError(f"checkpoint leaf {i} is not a generator, but the target's is")
        return _generator_like(want, got)
    if _is_saved_generator(got):
        raise ValueError(f"checkpoint leaf {i} is a generator, but the target's is "
                         f"{type(want).__name__}")
    if isinstance(want, torch.Tensor):
        _check_device(want.device)
        return torch.as_tensor(got).to(want.device)
    return got


def _rebuild_like(target, restored):
    """The target's tree with the restored leaves, after checking the count
    of leaves and each leaf's shape, so that a state of another structure
    (another kernel, another version) fails loudly instead of putting leaves
    in the wrong places."""
    leaves = _leaves(target)
    if len(restored) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(restored)} leaves but the target "
            f"state has {len(leaves)}; the saved state's structure does not "
            "match this kernel/version — re-create the checkpoint"
        )
    for i, (want, got) in enumerate(zip(leaves, restored)):
        want_shape, got_shape = _shape(want), _shape(got)
        if want_shape != got_shape:
            raise ValueError(
                f"checkpoint leaf {i} has shape {got_shape} but the target "
                f"expects {want_shape}; the saved state does not match"
            )
    return _unflatten(target, iter([_restored(w, g, i)
                                    for i, (w, g) in enumerate(zip(leaves, restored))]))


def restore_checkpoint(path, target):
    """Restore a state saved by :func:`save_checkpoint`.

    :param target: a state of the structure to rebuild (for example the
        current ``mcmc.post_warmup_state``); the count and shapes of its
        leaves are checked against the file's, and each restored tensor and
        generator lands on the device of the target's leaf.  A target on
        the ``meta`` device gets its tensors there.
    """
    path = os.path.abspath(os.fspath(path))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(payload, dict) and payload.get("format") == _FORMAT):
        raise ValueError(f"{path} is not a checkpoint written by save_checkpoint")
    return _rebuild_like(target, payload["leaves"])
