"""Chains and data across processes (port of ``numpyro_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets XLA insert the
collectives.  PyTorch's idiom is one process per device, joined by
``torch.distributed``: a rank is a device, as ``torchrun`` lays it out.

- :func:`initialize_distributed` joins the process group (a no-op in one
  process).  The backend is chosen, never guessed at after a failure:
  ``nccl`` when every rank of a host has a card of its own
  (``cuda:LOCAL_RANK``), ``gloo`` on the CPU and when ranks share a card
  (NCCL refuses two ranks on one device).
- :func:`chain_mesh` and :func:`chain_data_mesh` lay the ranks out as a
  ``(chains, data)`` grid (a :class:`Mesh`), with one process group per axis.
- Every rank derives the full chain panel from the seed and keeps its own
  rows (:class:`ChainShard`): chains ``[i C / S, (i + 1) C / S)`` of ``C``
  live on chain shard ``i`` of ``S`` (``MCMC`` pads ``C`` to a multiple of
  ``S`` first).  A sharded run therefore draws what the one-process run
  draws, row for row (``infer.hmc_core.ShardedDraws``).
- :func:`shard_data` gives a rank its rows of the observations, rows
  ``[j N / S, (j + 1) N / S)`` of ``N`` on data shard ``j`` of ``S``; the
  GLM op adds its partial sums over the data group (``ops.glm``).

Collectives are ``all_reduce`` (and nothing else) on tensors of the device
the data lives on: gloo supports only ``all_reduce`` and ``broadcast`` on
CUDA tensors, NCCL every collective.  A gather is an ``all_reduce`` of a
zero-filled buffer of the full panel, summed as integers of the same bits,
so the gathered panel equals the one-process panel bit for bit.  Every
collective adds one to :data:`collective_counts`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from numpyro_tpu_torch.diagnostics import effective_sample_size, split_gelman_rubin
from numpyro_tpu_torch.util import tree_leaves, tree_map

__all__ = [
    "chain_data_mesh",
    "chain_mesh",
    "cross_chain_diagnostics",
    "initialize_distributed",
    "pooled_step_size",
    "shard_chain_state",
    "shard_data",
]

# collectives launched by this package, by kind
collective_counts = {"all_reduce": 0}


def reset_collective_counts():
    for k in collective_counts:
        collective_counts[k] = 0


def all_reduce(tensor, group):
    """In-place sum of ``tensor`` over ``group`` (counted)."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    collective_counts["all_reduce"] += 1
    return tensor


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device():
    """This rank's card: ``cuda:LOCAL_RANK``, wrapped onto the cards there
    are when ranks share them."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return torch.device("cuda", local % max(count, 1))


def _backend_for(device, world):
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           **kwargs):
    """Join this process to the run's process group.

    ``coordinator_address`` (``host:port``, or a URL such as
    ``file:///path``), ``num_processes`` and ``process_id`` default to
    ``torchrun``'s environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  With one process, or when the group is
    already up, this is a no-op, as in the JAX package.  Keyword arguments:
    ``device`` (this rank's device; :func:`rank_device` by default), and
    the rest go to ``torch.distributed.init_process_group`` (``timeout``).
    The backend follows from the device as the module docstring says; a
    failed ``init_process_group`` raises.

    Returns the backend's name, or ``None`` in a single process.
    """
    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None else num_processes
    if world <= 1:
        return None
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    device = torch.device(kwargs.pop("device")) if "device" in kwargs else rank_device()
    backend = _backend_for(device, world)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)
    return backend


class Mesh:
    """Ranks laid out on named axes (``chains``, and ``data`` for
    :func:`chain_data_mesh`).

    - ``ranks``: numpy array of the ranks, of shape ``tuple(shape.values())``;
    - ``shape``: ``{axis: size}``; ``axis_names``: the axes in order;
    - ``coords``: ``{axis: this rank's index}``;
    - ``groups``: ``{axis: process group of the ranks that differ from this
      one only along the axis}``, ``None`` for an axis of size 1;
    - ``device``: this rank's device.
    """

    def __init__(self, ranks, axis_names, device, groups):
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        _, me = _world()
        where = np.argwhere(ranks == me)[0]
        self.rank = me
        self.coords = dict(zip(axis_names, (int(i) for i in where)))
        self.device = torch.device(device)
        self.groups = groups

    @property
    def num_chain_shards(self):
        return self.shape["chains"]

    @property
    def num_data_shards(self):
        return self.shape.get("data", 1)

    @property
    def chain_group(self):
        return self.groups["chains"]

    @property
    def data_group(self):
        return self.groups.get("data")

    def chain_shard(self, num_chains, padded=None):
        """This rank's rows of a panel of ``num_chains`` chains (``padded``
        rows with the pad at the end, if given)."""
        padded = num_chains if padded is None else padded
        i, s = self.coords["chains"], self.num_chain_shards
        return ChainShard(i * padded // s, (i + 1) * padded // s, num_chains, padded,
                          self.chain_group)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def _mesh(ranks, axis_names, device):
    world, _ = _world()
    if sorted(ranks.reshape(-1).tolist()) != list(range(world)):
        raise ValueError(f"a mesh lays out every rank of the world (0 to {world - 1}) once; "
                         f"got {ranks.reshape(-1).tolist()}")
    groups = {}
    # every rank makes every group, in the same order (new_group is collective)
    for axis, name in enumerate(axis_names):
        size = ranks.shape[axis]
        if size == 1:
            groups[name] = None
            continue
        lines = np.moveaxis(ranks, axis, -1).reshape(-1, size)
        mine = None
        for line in lines:
            group = dist.group.WORLD if size == world else dist.new_group(line.tolist())
            if _world()[1] in line:
                mine = group
        groups[name] = mine
    return Mesh(ranks, axis_names, rank_device() if device is None else device, groups)


def chain_mesh(devices=None, device=None):
    """1-D mesh over the ranks ``devices`` (every rank of the world by
    default): axis ``chains``.  ``device`` is this rank's device
    (:func:`rank_device` by default; ``"cpu"`` for gloo on the CPU)."""
    ranks = np.arange(_world()[0]) if devices is None else np.asarray(devices)
    return _mesh(ranks.reshape(-1), ("chains",), device)


def chain_data_mesh(num_chain_shards=None, num_data_shards=None, devices=None, device=None):
    """2-D mesh ``(chains, data)``; rank ``r`` of the list sits at chain
    shard ``r // num_data_shards`` and data shard ``r % num_data_shards``.
    By default every rank is a chain shard and ``data`` has size 1."""
    ranks = np.arange(_world()[0]) if devices is None else np.asarray(devices).reshape(-1)
    n = len(ranks)
    if num_chain_shards is None and num_data_shards is None:
        num_chain_shards, num_data_shards = n, 1
    elif num_chain_shards is None:
        num_chain_shards = n // num_data_shards
    elif num_data_shards is None:
        num_data_shards = n // num_chain_shards
    if num_chain_shards * num_data_shards != n:
        raise ValueError(f"mesh {num_chain_shards}x{num_data_shards} != {n} devices")
    return _mesh(ranks.reshape(num_chain_shards, num_data_shards), ("chains", "data"), device)


# ---------------------------------------------------------------------------
# Chain shards


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class ChainShard:
    """Rows ``[start, stop)`` of a chain panel of ``padded`` rows held by this
    rank; the first ``num_chains`` rows are real chains, the rest padding
    (copies of real chains that draw from a generator of their own and count
    in no statistic).  ``group`` is the chain axis's process group."""

    def __init__(self, start, stop, num_chains, padded, group):
        self.start, self.stop = start, stop
        self.num_chains, self.padded = num_chains, padded
        self.group = group

    @property
    def size(self):
        return self.stop - self.start

    @property
    def num_real(self):
        """How many of this rank's rows are real chains (they come first)."""
        return max(0, min(self.stop, self.num_chains) - self.start)

    def take(self, x):
        """This rank's rows of a panel of the ``num_chains`` real chains; a
        pad row copies real chain ``(row - num_chains) % num_chains``."""
        rows = torch.arange(self.start, self.stop)
        rows = torch.where(rows < self.num_chains, rows, (rows - self.num_chains) % self.num_chains)
        return x.index_select(0, rows.to(x.device))

    def gather(self, x):
        """The real chains' full panel from every rank's rows ``x``, equal
        bit for bit to the panel one process holds: each rank writes its
        rows into a zero-filled buffer, and the buffers are summed as
        integers of the same bits."""
        if self.group is None:
            return x[: self.num_chains]
        bits = x.contiguous().view(_INT_OF_SIZE[x.element_size()])
        wide = bits.to(torch.int32) if bits.element_size() < 4 else bits
        full = wide.new_zeros((self.padded,) + tuple(x.shape[1:]))
        full[self.start : self.stop] = wide
        all_reduce(full, self.group)
        return full[: self.num_chains].to(bits.dtype).view(x.dtype)

    def all(self, mask):
        """Whether ``mask`` ``(size,)`` holds for every real chain of every
        rank (one host read)."""
        left = (~mask[: self.num_real]).sum().reshape(1)
        if self.group is not None:
            all_reduce(left, self.group)
        return int(left) == 0


def _first_panel(tree):
    for leaf in tree_leaves(tree):
        if leaf.dim() >= 1:
            return leaf
    raise ValueError("the state has no tensor with a chain axis")


def _local_shard(mesh, x):
    """The :class:`ChainShard` of a panel whose rows ``x`` this rank holds
    (its chain count is summed over the chain group)."""
    total = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    if mesh.chain_group is not None:
        all_reduce(total, mesh.chain_group)
    shard = mesh.chain_shard(int(total))
    if shard.size != x.shape[0]:
        raise ValueError(f"rank {mesh.rank} holds {x.shape[0]} chains; as chain shard "
                         f"{mesh.coords['chains']} of {mesh.num_chain_shards} of "
                         f"{int(total)} chains it should hold {shard.size}")
    return shard


def shard_chain_state(state, mesh, num_chains=None):
    """This rank's block of ``state``, a tree whose tensor leaves with a
    leading axis of ``num_chains`` (by default the leading size of its first
    tensor with an axis) are chain panels; other leaves stay whole.  Chains
    ``[i C / S, (i + 1) C / S)`` go to chain shard ``i``.  The state's
    generators become an ``infer.hmc_core.ShardedDraws`` that remembers the
    rows, so the state's later draws are those rows of the full panel's."""
    # imported here: numpyro_tpu_torch.infer imports this module
    from numpyro_tpu_torch.infer.hmc_core import shard_state

    num_chains = _first_panel(state).shape[0] if num_chains is None else num_chains
    return shard_state(state, mesh.chain_shard(num_chains))


class DataShard:
    """Rows ``[start, stop)`` along ``axis``, held by this rank of the data
    axis's process ``group``."""

    def __init__(self, start, stop, axis, group):
        self.start, self.stop, self.axis, self.group = start, stop, axis, group


def shard_data(data, mesh, axis=0):
    """This rank's rows of ``data`` along ``axis`` over the mesh's ``data``
    axis (replicated over ``chains``), on the mesh's device: rows
    ``[j N / S, (j + 1) N / S)`` on data shard ``j`` of ``S``, so a count that
    does not divide evenly leaves the first shards a row fewer.  The result
    carries a ``data_shard`` (:class:`DataShard`) with the data group, which
    ``ops.glm.prepare_glm_data`` reads: the GLM op then sums its partial
    log-likelihood and gradient over the group."""
    data = torch.as_tensor(data)
    n = data.shape[axis]
    j, s = mesh.coords.get("data", 0), mesh.num_data_shards
    start, stop = j * n // s, (j + 1) * n // s
    rows = data.narrow(axis, start, stop - start).to(mesh.device).contiguous()
    rows.data_shard = DataShard(start, stop, axis, mesh.data_group)
    return rows


# ---------------------------------------------------------------------------
# Cross-chain reductions


def _gathered(x, mesh):
    if mesh is None or mesh.chain_group is None:
        return x
    return _local_shard(mesh, x).gather(x)


def cross_chain_diagnostics(samples_by_chain, mesh=None):
    """Split R-hat and effective sample size of every ``(C, N, ...)`` leaf of
    ``samples_by_chain``, as a ``(r_hat, ess)`` pair per leaf, computed where
    the draws are.  Under a ``mesh`` with more than one chain shard each leaf
    holds this rank's chains, and every rank gets the values of the whole
    panel (gathered over the chain group)."""

    def both(x):
        x = _gathered(x, mesh)
        return split_gelman_rubin(x), effective_sample_size(x)

    return tree_map(both, samples_by_chain)


def pooled_step_size(adapt_state, mesh=None):
    """The chains' step sizes pooled by their harmonic mean: ``adapt_state``
    is an adaptation state with a ``(C,)`` ``step_size`` or that tensor
    itself.  Under a ``mesh`` with more than one chain shard it holds this
    rank's chains, and the mean is over every rank's."""
    ss = torch.as_tensor(getattr(adapt_state, "step_size", adapt_state))
    return 1.0 / torch.mean(1.0 / _gathered(ss, mesh))
