"""MCMC driver (port of ``numpyro_tpu/infer/mcmc.py``).

Chain methods:

- ``"vectorized"``: all chains advance together in one batched program.
- ``"parallel"``: the vectorized program with its chain axis sharded over
  the ranks of a process group, one process per device (the JAX package
  shards it over a device mesh).  Each rank of the mesh's ``chains`` axis
  (``mesh=``, by default every rank of the world: ``parallel.chain_mesh``)
  initializes all chains from the seed, runs its rows of them on a
  ``hmc_core.ShardedDraws`` source, which draws the full panel and keeps the
  rank's rows, and the collected fields, ``last_state`` and the summary hold
  the full panel on every rank (gathered over the chain group): the same
  seed gives the draws of the vectorized run.  ``num_chains`` that the chain
  shards do not divide is padded with copies of the first chains, which draw
  from a generator of their own, count in no pooled statistic and in no
  loop's end, and are dropped at collection, so the real chains' draws are
  an unpadded run's; a run resumed from ``post_warmup_state`` is not padded
  and runs unsharded then.  With one rank, or no process group, it is the
  vectorized program.  Kernels whose transition couples chains gather what
  couples them over the chain group: ChEES its adaptation's panels, the
  ensembles the walkers (``infer/chees.py``, ``infer/ensemble.py``); an
  ensemble's pad walkers join its moves (their own generator places them
  at the start) and are dropped at collection, as in the JAX package.
- ``"sequential"``: one single-chain run per chain, one after another, with
  the results stacked on a leading chain axis.  Chain ``i`` runs on its own
  generator, seeded with the ``i``-th of ``num_chains`` integers that the
  run's generator draws first (:func:`chain_generators`).
- A callable ``chain_method`` maps a one-chain run over the chains:
  ``chain_method(one_chain)(generators, init_params)``, where ``generators``
  is the list of the chains' generators (those of ``"sequential"``),
  ``init_params`` the initial params with a leading chain axis or ``None``,
  and ``one_chain(generator, params)`` runs one chain as ``"sequential"``
  runs it and returns its collected fields and last state without a chain
  axis; the callable stacks them on a new leading axis, as ``jax.vmap``
  does in the JAX package.  A callable that maps in order therefore gives
  ``"sequential"``'s draws.

With ``progress_bar=True`` a ``tqdm`` bar follows the transitions (the fused
run reports each warmup transition and, while sampling, the transitions
that every chain has finished); without ``tqdm`` the run goes on without a
bar, as in the JAX package.

A kernel with a fused run (plain ``HMC``/``NUTS``) is driven through it.
Any other kernel, and a run that resumes from ``post_warmup_state`` or
collects a field the fused run does not bank, goes through the per-step API:
``init``, then a Python loop over ``sample`` that writes the collected fields
into ``(C, n, ...)`` buffers on the device (the counterpart of the JAX
package's ``fori_collect``).

Postprocessing (constraining the draws, and replaying the model for its
deterministic sites) is written for one draw and mapped over chains and
draws with ``util.soft_vmap``, as the JAX package maps it with
``vmap(vmap(postprocess_fn))``.
"""

from __future__ import annotations

import math
import time
import warnings
from abc import ABC, abstractmethod
from operator import attrgetter

import torch

from numpyro_tpu_torch.diagnostics import print_summary
from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.util import chain_generators
from numpyro_tpu_torch.parallel import mesh as mesh_lib
from numpyro_tpu_torch.util import identity, soft_vmap, tree_leaves, tree_map

__all__ = ["MCMC", "MCMCKernel", "chain_generators"]


class MCMCKernel(ABC):
    """Kernel interface (parity: ``numpyro_tpu.infer.mcmc.MCMCKernel``).
    ``init`` takes ``num_chains`` beside the JAX signature: ``None`` is one
    chain with unbatched state, an integer that many chains on a leading
    axis (JAX reads the same from the shape of its keys)."""

    def postprocess_fn(self, model_args, model_kwargs):
        return identity

    @abstractmethod
    def init(self, rng_key, num_warmup, init_params, model_args, model_kwargs, num_chains=None):
        raise NotImplementedError

    @abstractmethod
    def sample(self, state, model_args, model_kwargs):
        raise NotImplementedError

    @property
    def sample_field(self):
        raise NotImplementedError

    @property
    def default_fields(self):
        return (self.sample_field,)

    def get_diagnostics_str(self, state):
        return ""

    @property
    def is_ensemble_kernel(self):
        """An ensemble kernel pairs its chains inside ``sample``, over the
        whole ``(C, ...)`` panel; the driver hands it the panel as it does
        for any kernel."""
        return False


def _stack_chains(parts, batched):
    """Per-chain results on a new leading chain axis: ``batched`` parts carry
    a chain axis of one already (a fused run's), the others none.  Leaves
    that are not tensors (the step index, a generator) come from the first
    chain."""
    join = torch.cat if batched else torch.stack
    return tree_map(lambda *xs: join(xs), parts[0], *parts[1:])


# draws per vmap call of the postprocessing: bounds the memory of a replay
POSTPROCESS_CHUNK = 4096


def _postprocess_draws(postprocess_fn, draws):
    """``postprocess_fn`` of one draw, mapped over the ``(C, n)`` leading
    axes of ``draws``."""
    lead = tuple(tree_leaves(draws)[0].shape[:2])
    if math.prod(lead) == 0:
        return draws
    out = soft_vmap(postprocess_fn, draws, 2, POSTPROCESS_CHUNK)
    if math.prod(lead) == 1:  # soft_vmap calls fn on the one draw as it is
        out = tree_map(lambda y: y.reshape(lead + tuple(y.shape)), out)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MCMC:
    """MCMC driver.

    :param sampler: an :class:`MCMCKernel`.
    :param chain_method: ``"vectorized"``, ``"parallel"`` (the vectorized
        program sharded over ranks), ``"sequential"`` or a callable (see the
        module docstring).
    :param progress_bar: follow the run with a ``tqdm`` bar.
    :param device: where the chains run.  ``None`` is the mesh's device, or
        ``torch.device("cuda")``; :meth:`run` raises when that device is not
        there and never carries on on the CPU.
    :param mesh: the ``parallel.mesh.Mesh`` whose ``chains`` axis
        ``"parallel"`` shards over; ``None`` is every rank of the world.
    """

    def __init__(
        self,
        sampler,
        *,
        num_warmup,
        num_samples,
        num_chains=1,
        thinning=1,
        postprocess_fn=None,
        chain_method="vectorized",
        progress_bar=False,
        device=None,
        mesh=None,
    ):
        if chain_method not in ("parallel", "vectorized", "sequential") and not callable(
            chain_method
        ):
            raise ValueError(
                "Only supporting the following methods to draw chains:"
                ' "sequential", "parallel", "vectorized", or a callable'
            )
        if not isinstance(thinning, int) or thinning < 1:
            raise ValueError("thinning must be a positive integer")
        self.sampler = sampler
        self._sample_field = sampler.sample_field
        self._default_fields = sampler.default_fields
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.thinning = thinning
        self.postprocess_fn = postprocess_fn
        self.chain_method = chain_method
        self.progress_bar = progress_bar
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.device = torch.device(device)
        self.mesh = mesh
        self._states = None
        self._states_flat = None
        self._last_state = None
        self._warmup_state = None
        self._collection_params = {}
        self._set_collection_params()
        # wall clock and batched potential evaluations of the last run
        self.last_run_stats = {}

    def _set_collection_params(self, lower=None, upper=None, phase=None):
        self._collection_params = {
            "lower": self.num_warmup if lower is None else lower,
            "upper": self.num_warmup + self.num_samples if upper is None else upper,
            "phase": phase,
        }

    @property
    def post_warmup_state(self):
        """Set this to ``.last_state`` to skip warmup on the next run."""
        return self._warmup_state

    @post_warmup_state.setter
    def post_warmup_state(self, state):
        self._warmup_state = state

    @property
    def last_state(self):
        return self._last_state

    def _generator(self, rng_key):
        """The run's generator: made from an int seed on the run's device, or
        the caller's, which must live there."""
        return infer_util.device_generator(rng_key, self.device, "MCMC")

    def warmup(self, rng_key, *args, extra_fields=(), collect_warmup=False, init_params=None,
               **kwargs):
        """Run warmup only; sets ``post_warmup_state``."""
        self._warmup_state = None
        if collect_warmup:
            self._set_collection_params(0, self.num_warmup, phase="warmup")
        else:
            self._set_collection_params(self.num_warmup, self.num_warmup, phase="warmup")
        self.run(rng_key, *args, extra_fields=extra_fields, init_params=init_params, **kwargs)
        self._warmup_state = self._last_state
        self._set_collection_params()

    def _can_fuse(self, collect_fields, init_state):
        return (
            getattr(self.sampler, "supports_fused_run", False)
            and init_state is None
            and self._collection_params["lower"] == self.num_warmup
            and self._collection_params["upper"] == self.num_warmup + self.num_samples
            and set(collect_fields) <= set(self.sampler.FUSED_FIELDS)
        )

    def _shard_over_chains(self, allow_pad=True):
        """This rank's :class:`~numpyro_tpu_torch.parallel.mesh.ChainShard`
        of the run's chains over the mesh's ``chains`` axis, or ``None``
        where that axis has one shard.  ``num_chains`` that the shards do not
        divide is padded to the next multiple (the extra chains are dropped
        at collection), except for a run that resumes from an unpadded
        state (``allow_pad=False``), which then runs unsharded, as in the JAX
        package."""
        mesh = mesh_lib.chain_mesh(device=self.device) if self.mesh is None else self.mesh
        n = mesh.num_chain_shards
        if n <= 1:
            return None
        pad = (-self.num_chains) % n
        if pad and not allow_pad:
            warnings.warn(
                f"num_chains={self.num_chains} is not divisible by the {n} chain shards and the "
                "run resumes from an existing state, so the chain axis cannot be padded; "
                "running unsharded.", stacklevel=3,
            )
            return None
        if pad:
            warnings.warn(
                f"num_chains={self.num_chains} is not divisible by the {n} chain shards; "
                f"padding the chain axis to {self.num_chains + pad} (extras dropped at "
                "collection).", stacklevel=3,
            )
        return mesh.chain_shard(self.num_chains, self.num_chains + pad)

    def _run_per_step(self, rng_key, init_state, init_params, args, kwargs, collect_fields,
                      num_chains):
        """``init`` and a loop over ``sample``; every ``thinning``-th state
        of the collected range is written into preallocated buffers."""
        sampler = self.sampler
        batched = num_chains > 1
        lower, upper = self._collection_params["lower"], self._collection_params["upper"]
        stats = {}
        evals0 = infer_util.potential_evals
        t0 = time.perf_counter()
        shard = rng_key.shard if isinstance(rng_key, core.ShardedDraws) else None
        if init_state is None:
            # sharded, every rank initializes the full panel and keeps its
            # rows; an ensemble makes its pad walkers and keeps its rows itself
            own = shard is not None and getattr(sampler, "inits_own_shard", False)
            state = sampler.init(
                rng_key if shard is None or own else rng_key.generator, self.num_warmup,
                init_params, model_args=args, model_kwargs=kwargs,
                num_chains=num_chains if batched else None,
            )
            if shard is not None and not own:
                state = core.shard_state(state, shard, rng_key.pad_generator)
            _sync(self.device)
            stats["init_s"] = time.perf_counter() - t0
            stats["potential_evals_init"] = infer_util.potential_evals - evals0
        else:
            state = init_state if shard is None else core.shard_state(init_state, shard)
        if shard is not None:
            num_chains = shard.size
        remove_sites = tuple(getattr(sampler, "collect_exclude_sites", ()) or ())
        getters = [attrgetter(f) for f in collect_fields]

        def collect(state):
            out = [g(state) for g in getters]
            if remove_sites and isinstance(out[0], dict):
                out[0] = {k: v for k, v in out[0].items() if k not in remove_sites}
            return out

        # as the JAX package's ``fori_collect``: whole strides only, counted
        # back from ``upper``, and the last state of each stride is kept
        n_collect = (upper - lower) // self.thinning
        start = lower + (upper - lower) % self.thinning
        lead = (num_chains, n_collect) if batched else (1, n_collect)
        buffers = None
        t_phase, evals_phase = time.perf_counter(), infer_util.potential_evals
        warm_end = self.num_warmup if init_state is None else 0
        bar = infer_util.tqdm_bar(upper) if self.progress_bar else None
        for i in range(upper):
            if bar is not None:
                bar.set_description("warmup" if i < warm_end else "sample", refresh=False)
            if i == warm_end and i > 0:
                _sync(self.device)
                stats["warmup_s"] = time.perf_counter() - t_phase
                stats["potential_evals_warmup"] = infer_util.potential_evals - evals_phase
                t_phase, evals_phase = time.perf_counter(), infer_util.potential_evals
            state = sampler.sample(state, args, kwargs)
            if i >= start and (i - start) % self.thinning == self.thinning - 1:
                values = collect(state)
                if not batched:
                    values = tree_map(lambda x: x[None], values)
                if buffers is None:
                    buffers = tree_map(
                        lambda x: x.new_empty(lead + tuple(x.shape[1:])), values
                    )
                slot = (i - start) // self.thinning

                def write(buf, value):
                    buf[:, slot] = value
                    return buf

                tree_map(write, buffers, values)
            if bar is not None:
                bar.set_postfix_str(sampler.get_diagnostics_str(state), refresh=False)
                bar.update()
        if bar is not None:
            bar.close()
        _sync(self.device)
        phase = "warmup" if upper <= warm_end else "sample"
        stats[f"{phase}_s"] = time.perf_counter() - t_phase
        stats[f"potential_evals_{phase}"] = infer_util.potential_evals - evals_phase
        if buffers is None:
            buffers = [None] * len(collect_fields)
        return dict(zip(collect_fields, buffers)), state, stats

    def _run_chains(self, rng_key, init_state, init_params, args, kwargs, collect_fields,
                    num_chains):
        """``num_chains`` chains in one program: the kernel's fused run where
        it has one, else the per-step loop.  Returns the fields, the last
        state, the run's statistics and whether the fused run took it."""
        if self._can_fuse(collect_fields, init_state):
            total = self.num_warmup + self.num_samples
            bar = infer_util.tqdm_bar(total) if self.progress_bar else None
            progress = None
            if bar is not None:

                def progress(phase, done, total):
                    bar.n = (0 if phase == "warmup" else self.num_warmup) + done
                    bar.set_description(phase, refresh=False)
                    bar.refresh()

            try:
                fields, last_state = self.sampler.fused_run(
                    rng_key,
                    num_chains,
                    self.num_warmup,
                    self.num_samples,
                    thinning=self.thinning,
                    init_params=init_params,
                    model_args=args,
                    model_kwargs=kwargs,
                    collect_fields=collect_fields,
                    progress=progress,
                )
            finally:
                if bar is not None:
                    bar.close()
            return fields, last_state, dict(self.sampler.last_fused_stats), True
        fields, last_state, stats = self._run_per_step(
            rng_key, init_state, init_params, args, kwargs, collect_fields, num_chains
        )
        return fields, last_state, stats, False

    def _run_sequential(self, rng_key, init_state, init_params, args, kwargs, collect_fields):
        """One single-chain run per chain (as ``num_chains=1`` runs it), on
        the chain's generator (:func:`chain_generators`), stacked.  A state
        to resume from is sliced per chain, and its generators are replaced
        by the chains' generators of this run."""
        generators = chain_generators(rng_key, self.device, self.num_chains)
        outs, fused = [], []
        for i, generator in enumerate(generators):
            state_i = params_i = None
            if init_state is not None:
                state_i = core.replace_draw_sources(tree_map(lambda x: x[i], init_state), generator)
            if init_params is not None:
                # a fused run takes params with a chain axis, the per-step
                # API one chain's without
                one = slice(i, i + 1) if self._can_fuse(collect_fields, state_i) else i
                params_i = tree_map(lambda x: x[one], init_params)
            fields, last, stats, was_fused = self._run_chains(
                generator, state_i, params_i, args, kwargs, collect_fields, 1
            )
            outs.append((fields, last, stats))
            fused.append(was_fused)
        fields = {
            k: None if outs[0][0][k] is None else _stack_chains([o[0][k] for o in outs], True)
            for k in collect_fields
        }
        last_state = _stack_chains([o[1] for o in outs], fused[0])
        return fields, last_state, _sum_stats(o[2] for o in outs)

    def _run_mapped(self, rng_key, init_state, init_params, args, kwargs, collect_fields):
        """The chains through the callable ``chain_method``: each lane runs
        one chain as :meth:`_run_sequential` does, on the same generator."""
        if init_state is not None:
            raise ValueError("post_warmup_state is not supported with a callable chain_method")
        generators = chain_generators(rng_key, self.device, self.num_chains)
        chain_stats = []

        def one_chain(generator, params):
            if params is not None and self._can_fuse(collect_fields, None):
                params = tree_map(lambda x: x[None], params)  # a fused run takes a chain axis
            fields, last, stats, fused = self._run_chains(
                generator, None, params, args, kwargs, collect_fields, 1
            )
            chain_stats.append(stats)
            fields = {k: None if v is None else tree_map(lambda x: x[0], v)
                      for k, v in fields.items()}
            return fields, tree_map(lambda x: x[0], last) if fused else last

        fields, last_state = self.chain_method(one_chain)(generators, init_params)
        return fields, last_state, _sum_stats(chain_stats)

    def run(self, rng_key, *args, extra_fields=(), init_params=None, **kwargs):
        """Run warmup + sampling and collect fields.  ``rng_key`` is an int
        seed, from which the run makes a generator on its device, or a
        ``torch.Generator`` on that device."""
        rng_key = self._generator(rng_key)
        infer_util.pin_full_f32_matmul()
        t0 = time.perf_counter()
        init_state = self._warmup_state
        if init_state is not None:
            # resuming from a warmed-up state: no warmup steps to skip
            self._set_collection_params(0, self.num_samples, phase="sample")
        collect_fields = tuple(
            set((self._sample_field,) + tuple(self._default_fields) + tuple(extra_fields))
        )
        collect_fields = (self._sample_field,) + tuple(
            sorted(f for f in collect_fields if f != self._sample_field)
        )
        shard = None
        if self.chain_method == "parallel" and self.num_chains > 1:
            shard = self._shard_over_chains(allow_pad=init_state is None)
        if shard is not None:
            pad_generator = None
            if shard.padded > shard.num_chains:
                pad_generator = torch.Generator(device=self.device).manual_seed(
                    (rng_key.initial_seed() * 1_000_003 + self.num_chains) % 2**63
                )
            rng_key = core.ShardedDraws(rng_key, shard, pad_generator)
        if self.chain_method == "sequential" and self.num_chains > 1:
            fields, last_state, stats = self._run_sequential(
                rng_key, init_state, init_params, args, kwargs, collect_fields
            )
        elif callable(self.chain_method) and self.num_chains > 1:
            fields, last_state, stats = self._run_mapped(
                rng_key, init_state, init_params, args, kwargs, collect_fields
            )
        else:
            fields, last_state, stats, _ = self._run_chains(
                rng_key, init_state, init_params, args, kwargs, collect_fields, self.num_chains
            )
        if shard is not None:
            fields = tree_map(shard.gather, fields)
            last_state = core.gather_state(last_state)
        postprocess_fn = (
            self.sampler.postprocess_fn(args, kwargs)
            if self.postprocess_fn is None
            else self.postprocess_fn
        )
        if fields[self._sample_field] is not None and postprocess_fn is not identity:
            fields[self._sample_field] = _postprocess_draws(
                postprocess_fn, fields[self._sample_field]
            )
        self._last_state = last_state
        self._states = fields
        self._states_flat = {k: _flatten_chains(v) for k, v in fields.items()}
        stats["potential_evals"] = sum(
            v for k, v in stats.items() if k.startswith("potential_evals_")
        )
        stats["total_s"] = time.perf_counter() - t0
        self.last_run_stats = stats

    def get_samples(self, group_by_chain=False):
        """Posterior samples in constrained space."""
        states = self._states if group_by_chain else self._states_flat
        return states[self._sample_field]

    def get_extra_fields(self, group_by_chain=False):
        states = self._states if group_by_chain else self._states_flat
        return {k: v for k, v in states.items() if k != self._sample_field}

    def print_summary(self, prob=0.90, exclude_deterministic=True):
        """Print the summary table of the samples (sites whose names start
        with ``_`` left out) and the number of divergences.
        ``exclude_deterministic`` is accepted and not used, as in the JAX
        package: deterministic sites are in the table."""
        states = self._states[self._sample_field]
        if not isinstance(states, dict):
            states = {self._sample_field: states}
        print_summary({k: v for k, v in states.items() if not k.startswith("_")}, prob=prob)
        extra_fields = self.get_extra_fields()
        if "diverging" in extra_fields:
            print("Number of divergences: {}".format(int(extra_fields["diverging"].sum())))

    def transfer_states_to_host(self):
        """Move the collected states, their chain-flattened view and the last
        state to the CPU, freeing their device memory.  Generators in the
        last state stay where they are."""
        to_host = lambda tree: tree_map(lambda x: x.cpu(), tree)  # noqa: E731
        self._states = to_host(self._states)
        self._states_flat = to_host(self._states_flat)
        self._last_state = to_host(self._last_state)


def _sum_stats(parts):
    """The run statistics of the chains' runs, added key by key."""
    stats = {}
    for one in parts:
        for k, v in one.items():
            stats[k] = stats.get(k, 0) + v
    return stats


def _flatten_chains(x):
    return tree_map(lambda v: v.reshape((-1,) + tuple(v.shape[2:])), x)
