"""Chain-batched HMC/NUTS engine (port of ``numpyro_tpu/infer/hmc_core.py``
for NUTS and fixed-trajectory HMC with diagonal, dense and structured mass
matrices).

As in the JAX package the chain axis is the first dimension of every
tensor: positions and momenta are ``(C, D)`` panels, and one NUTS "tick"
advances every chain by one leapfrog (one batched potential-and-gradient
evaluation) plus masked tree bookkeeping; the doubling structure is tracked
with integer registers and ``K = max_tree_depth`` U-turn checkpoint slots
(see the JAX module docstring).

What differs from the JAX engine:

- Random numbers come from a draw source (:class:`GeneratorDraws`, one
  ``torch.Generator`` drawing ``(C,)`` or ``(C, D)`` tensors per call) and
  are passed into :func:`_nuts_tick` and :func:`_init_nuts_carry` as
  arguments, so a test can feed them JAX's draws.
- ``lax.while_loop`` / ``fori_loop`` are Python loops that do not read the
  host condition at every tick (each read is a device sync): the harvest loop
  and the step-size search read it every ``CHECK_EVERY`` ticks, a synchronous
  transition where a tree can be whole (after 1, 3, 7, 15, ... ticks).  The
  extra ticks are harmless: every
  state update of a finished chain is masked by ``active = ~done``, except
  the subtree registers ``s_logw`` and ``s_prefix``, which are never read for
  a finished chain.
- ``lax.cond`` at warmup window ends is a plain ``if`` on the step index.
- The harvest loop banks draws with ``index_put`` into buffers that carry one
  spare slot (JAX's ``mode="drop"``), cut off at the end; the buffers are
  updated in place.
- A structured mass matrix gathers a panel once into block order and back
  (``MassBlocks.permutation``), where JAX takes and scatters each block.

Chains sharded over ranks (``parallel.mesh``) run on a :class:`ShardedDraws`
source, which draws the full panel on every rank and keeps the rank's rows.
The loops' host conditions then hold for every rank's real chains (one
``all_reduce`` of a count at each read, so every rank runs the ticks that one
process would run and draws the same panels), and pooled adaptation (the
step-size search's harmonic mean, the geometric mean of the accept
probabilities, the Welford merge) gathers its per-chain inputs over the chain
group and computes the one-process numbers on every rank.
"""

from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from numpyro_tpu_torch.distributions.util import cholesky as _cholesky
from numpyro_tpu_torch.infer.util import batched_value_and_grad
from numpyro_tpu_torch.util import tree_map

__all__ = [
    "FlatLayout",
    "GeneratorDraws",
    "ShardedDraws",
    "gather_state",
    "MassBlocks",
    "AdaptPanel",
    "batched_potential",
    "batched_step_size_search",
    "build_fused_run",
    "build_mass_blocks",
    "build_warmup",
    "adapt_from_numpy",
    "covariance_factors",
    "dual_averaging_step",
    "carry_from_numpy",
    "hmc_transition",
    "init_mass",
    "integrate_segment",
    "leapfrog",
    "nuts_transition",
    "popcount",
    "replace_draw_sources",
    "shard_state",
    "stan_windows",
    "welford_step",
]

# ticks between two reads of a loop's host condition (each read is a device
# sync); finished chains are masked, so the extra ticks change no result
CHECK_EVERY = 8


# ---------------------------------------------------------------------------
# Flat (C, D) layout


class FlatLayout:
    """How a dict of latent sites (or one bare tensor, a ``potential_fn``'s
    params) packs into a flat vector, built once from a single-chain prototype
    (sites in sorted-key order, as JAX flattens).  Integer and boolean sites
    (a Gibbs sweep's discrete values beside real ones) are cast back to their
    dtype on the way out, as JAX's ``ravel_pytree`` does; real sites keep the
    panel's dtype."""

    def __init__(self, z_proto):
        self.is_tensor = isinstance(z_proto, torch.Tensor)
        if not self.is_tensor and not isinstance(z_proto, dict):
            raise NotImplementedError("FlatLayout needs a dict of latent sites or a tensor")
        proto = {None: z_proto} if self.is_tensor else z_proto
        self.names = (None,) if self.is_tensor else tuple(sorted(z_proto))
        self.shapes = tuple(tuple(proto[k].shape) for k in self.names)
        self.dtypes = tuple(
            None if proto[k].dtype.is_floating_point else proto[k].dtype for k in self.names
        )
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        self.dim = int(sum(self.sizes))
        offsets = np.cumsum((0,) + self.sizes[:-1]).tolist()
        self._slices = tuple(zip(offsets, self.sizes))
        self.site_ranges = {} if self.is_tensor else dict(zip(self.names, self._slices))

    def _out(self, parts):
        parts = [x if dt is None or x.dtype == dt else x.to(dt)
                 for x, dt in zip(parts, self.dtypes)]
        return parts[0] if self.is_tensor else dict(zip(self.names, parts))

    def unravel_one(self, flat):
        return self._out([
            flat[o : o + s].reshape(shape) for shape, (o, s) in zip(self.shapes, self._slices)
        ])

    def ravel_batch(self, tree):
        """Dict of ``(C, *s)`` tensors (or one tensor) -> ``(C, D)`` panel."""
        if self.is_tensor:
            return tree.reshape(tree.shape[0], -1)
        c = tree[self.names[0]].shape[0]
        return torch.cat([tree[k].reshape(c, -1) for k in self.names], dim=1)

    def unravel_batch(self, panel):
        """``(C, D)`` panel -> dict of ``(C, *s)`` tensors (or one tensor)."""
        c = panel.shape[0]
        return self._out([
            panel[:, o : o + s].reshape((c,) + shape)
            for shape, (o, s) in zip(self.shapes, self._slices)
        ])


def batched_potential(potential_fn, layout, per_chain=None, forward_mode=False):
    """(C, D) panel -> potential (C,) and gradient panel (C, D): the
    one-chain ``potential_fn`` through ``vmap(grad_and_value(...))``, or with
    ``forward_mode`` through ``vmap(jacfwd(...))``.

    With ``per_chain`` (a pytree whose leaves carry a leading chain axis)
    ``potential_fn`` is a function of one chain's slice of that pytree which
    returns the chain's potential, and the pytree is mapped beside the panel."""

    if per_chain is None:

        def pe_flat(flat):
            return potential_fn(layout.unravel_one(flat))

        extra = ()
    else:

        def pe_flat(flat, pc):
            return potential_fn(pc)(layout.unravel_one(flat))

        extra = (per_chain,)

    vg = batched_value_and_grad(pe_flat, forward_mode=forward_mode)

    def pe_grad(panel):
        if layout.dim == 0:
            return panel.new_zeros(panel.shape[:1]), panel
        return vg(panel, *extra)

    return pe_grad


# ---------------------------------------------------------------------------
# Mass-matrix blocks
#
# The mass matrix is a direct sum of blocks over index sets of the flat
# dimension; each block is diagonal ``(C, b)`` or dense ``(C, b, b)``.  The
# mass structure is exposed as a bare tensor for one block and as a dict keyed
# by the blocks' site-name tuples otherwise, as in the JAX package.


class MassBlocks(namedtuple("MassBlocks", ["names", "indices", "dense", "full"])):
    """Static block structure (the JAX ``MassBlocks``).  ``names``: tuple of
    site-name tuples (or None), ``indices``: tuple of numpy index arrays into
    the flat dim, ``dense``: tuple of bools, ``full``: one block covering every
    dim in order.  With more than one block a panel is gathered once into block
    order, where each block is a contiguous slice, and gathered back once: the
    two index tensors are made once per device (:meth:`permutation`)."""

    def permutation(self, device):
        """(order, undo) index tensors on ``device``: ``x[..., order]`` puts
        the blocks one after another, ``y[..., undo]`` puts them back."""
        cache = self.__dict__.setdefault("_permutation", {})
        if device not in cache:
            order = np.concatenate(self.indices)
            cache[device] = (
                torch.as_tensor(order, device=device),
                torch.as_tensor(np.argsort(order, kind="stable"), device=device),
            )
        return cache[device]


def build_mass_blocks(layout, dense_mass):
    """``dense_mass``: a bool (one block over every dim) or a list of tuples of
    site names, each a dense block; the sites left over form a diagonal one."""
    d = layout.dim
    if isinstance(dense_mass, bool):
        names = (tuple(sorted(layout.site_ranges)) or None,)
        return MassBlocks(names, (np.arange(d),), (dense_mass,), True)
    if not layout.site_ranges:
        raise ValueError(
            "structured `dense_mass` requires a dict-structured latent "
            "(use a model, not a raw potential_fn)"
        )
    def flat_indices(sites):
        return np.concatenate(
            [np.arange(o, o + s) for o, s in (layout.site_ranges[k] for k in sites)]
        )

    names = [tuple(group) for group in dense_mass]
    dense = [True] * len(names)
    rest = tuple(sorted(set(layout.site_ranges).difference(*names)))
    if rest:
        names.append(rest)
        dense.append(False)
    indices = [flat_indices(group) for group in names]
    full = len(indices) == 1 and np.array_equal(indices[0], np.arange(d))
    return MassBlocks(tuple(names), tuple(indices), tuple(dense), bool(full))


def _as_parts(blocks, exposed):
    """Exposed mass structure (bare tensor or name-keyed dict) -> block list."""
    if isinstance(exposed, dict):
        return [exposed[k] for k in blocks.names]
    return [exposed]


def _expose(blocks, parts):
    if len(parts) == 1:
        return parts[0]
    return dict(zip(blocks.names, parts))


def _block_slices(blocks, x):
    """Each block's entries of the panel ``x`` ``(C, ..., D)``."""
    if blocks.full:
        return [x]
    order, _ = blocks.permutation(x.device)
    return list(x.index_select(-1, order).split([len(i) for i in blocks.indices], -1))


def _unblock(blocks, parts):
    """Inverse of :func:`_block_slices`."""
    if blocks.full:
        return parts[0]
    _, undo = blocks.permutation(parts[0].device)
    return torch.cat(parts, -1).index_select(-1, undo)


def _times_block(m, x):
    """A diagonal ``(C, b)`` or dense ``(C, b, b)`` block times the panel
    ``x`` ``(C, ..., b)`` (extra axes broadcast)."""
    if m.dim() == 2:
        return m.reshape(m.shape[:1] + (1,) * (x.dim() - 2) + m.shape[1:]) * x
    # JAX's einsum("cij,c...j->c...i") as one batched product, the same
    # arithmetic at less host time per call than einsum on the CPU
    rows = x.reshape(x.shape[0], -1, x.shape[-1])
    return torch.bmm(rows, m.transpose(1, 2)).reshape(x.shape)


def apply_inv_mass(blocks, inv_mass, r):
    """v = M^{-1} r over panels ``(C, ..., D)`` (extra axes broadcast)."""
    return _unblock(blocks, [
        _times_block(m, x) for m, x in zip(_as_parts(blocks, inv_mass), _block_slices(blocks, r))
    ])


def kinetic(blocks, inv_mass, r):
    """K(r) = r^T M^{-1} r / 2, batched over (C, ..., D) -> (C, ...)."""
    return 0.5 * (apply_inv_mass(blocks, inv_mass, r) * r).sum(-1)


def draw_momentum(blocks, sqrt_mass, eps):
    """r = chol(M) eps for standard normals eps (C, D)."""
    return apply_inv_mass(blocks, sqrt_mass, eps)


def _precision_factors(cov):
    """(S, S^{-1}) with S lower-triangular and S S^T = cov^{-1}, batched.

    The flip-reorder trick (JAX's ``[..., ::-1, ::-1]`` is ``torch.flip``): no
    explicit inverse of cov is formed, and S^{-1} comes out exactly as the
    flipped factor's transpose."""
    rev = _cholesky(cov.flip(-2, -1)).flip(-2, -1)
    sqrt_inv = rev.transpose(-2, -1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device).expand(cov.shape)
    sqrt = torch.linalg.solve_triangular(sqrt_inv, eye, upper=False)
    return sqrt, sqrt_inv


def init_mass(blocks, num_chains, like, init_inverse=None):
    """Identity (or user-provided) mass on the device and in the dtype of
    ``like``; returns the exposed (inv, sqrt, sqrt_inv).

    ``init_inverse`` may be a bare tensor or array (for the sole block) or a
    dict keyed by block site-name tuples; a 1-d value for a dense block is its
    diagonal, and values without a chain axis broadcast over chains."""
    inv_p, sqrt_p, sqrt_inv_p = [], [], []
    for name, idx, dense in zip(blocks.names, blocks.indices, blocks.dense):
        b = len(idx)
        given = None
        if init_inverse is not None:
            given = init_inverse.get(name) if isinstance(init_inverse, dict) else init_inverse
        if given is None:
            if dense:
                inv = torch.eye(b, dtype=like.dtype, device=like.device).expand(num_chains, b, b)
            else:
                inv = like.new_ones((num_chains, b))
            sqrt = sqrt_inv = inv
        else:
            inv = torch.as_tensor(given, dtype=like.dtype, device=like.device)
            if dense and inv.dim() == 1:
                inv = torch.diag(inv)
            if inv.dim() == (2 if dense else 1):
                inv = inv.expand((num_chains,) + tuple(inv.shape))
            if dense:
                sqrt, sqrt_inv = _precision_factors(inv)
            else:
                sqrt_inv = inv.sqrt()
                sqrt = 1.0 / sqrt_inv
        inv_p.append(inv)
        sqrt_p.append(sqrt)
        sqrt_inv_p.append(sqrt_inv)
    return _expose(blocks, inv_p), _expose(blocks, sqrt_p), _expose(blocks, sqrt_inv_p)


# ---------------------------------------------------------------------------
# Random draws


class GeneratorDraws:
    """The engine's random numbers from one ``torch.Generator``: every call
    draws for all chains at once, on the device and in the dtype of ``like``
    (a ``(C, D)`` panel).  Every draw goes through :meth:`_draw`, which a
    sharded source (:class:`ShardedDraws`) overrides."""

    shard = None

    def __init__(self, generator):
        self.generator = generator

    def _draw(self, draw, shape):
        """``draw(generator, shape)``."""
        return draw(self.generator, tuple(shape))

    def _rand(self, like, shape, dtype=None):
        dtype = like.dtype if dtype is None else dtype
        return self._draw(
            lambda g, s: torch.rand(s, generator=g, device=like.device, dtype=dtype), shape
        )

    def normal(self, like):
        return self.normals(like.shape, like)

    def rademacher(self, like):
        return torch.where(self._rand(like, like.shape[:1]) < 0.5, 1.0, -1.0).to(like.dtype)

    def start(self, like):
        """Momentum noise and first direction of a new trajectory."""
        return self.normal(like), self.rademacher(like)

    def tick(self, like):
        """(u_swap, u_merge, direction) of one NUTS tick."""
        c = like.shape[:1]
        return self._rand(like, c), self._rand(like, c), self.rademacher(like)

    def uniform(self, like):
        """One uniform per chain (an accept test)."""
        return self._rand(like, like.shape[:1])

    def hmc_start(self, like):
        """Momentum noise and accept uniform of a fixed-length trajectory."""
        return self.normal(like), self.uniform(like)

    def block(self, idx, num_blocks, block_size, size):
        """A block refresh of the subsample index vectors ``idx`` ``(..., m)``:
        the number of the block to redraw ``(...)`` and its ``block_size``
        replacement rows below ``size`` ``(..., block_size)``, as ``int64``."""
        lead = tuple(idx.shape[:-1])

        def randint(high):
            return lambda g, s: torch.randint(high, s, generator=g, device=idx.device)

        blocks = self._draw(randint(num_blocks), lead)
        return blocks, self._draw(randint(size), lead + (block_size,))

    def fork(self):
        """The source of the adaptation's draws within one transition (JAX
        splits the chain keys in two there; one generator serves both)."""
        return self

    # The draws of the other kernels (SMC, the Gibbs sweeps, MixedHMC,
    # BarkerMH, SA and the ensembles): plain shapes on the device and in the
    # dtype of ``like``.  Each kernel documents the order of its calls, which
    # a test's draw source follows to hand the port JAX's draws.

    def normals(self, shape, like):
        return self._draw(
            lambda g, s: torch.randn(s, generator=g, device=like.device, dtype=like.dtype), shape
        )

    def uniforms(self, shape, like):
        return self._rand(like, shape)

    def exponentials(self, shape, like):
        return -torch.log1p(-self._rand(like, shape))

    def gumbels(self, shape, like):
        """Standard Gumbel noise (``random.categorical`` is the argmax of the
        logits plus this)."""
        u = self._rand(like, shape).clamp(min=torch.finfo(like.dtype).tiny)
        return -torch.log(-torch.log(u))

    def randints(self, low, high, shape, like):
        """``int64`` uniform in ``[low, high)``; ``high`` is a number or a
        tensor that broadcasts against ``shape`` (one bound per chain)."""
        u = self._rand(like, shape, torch.float64)
        if not isinstance(high, torch.Tensor):
            # a number stays on the host: no copy to the device
            span = high - low
            return (low + torch.clamp(torch.floor(u * span), max=span - 1)).to(torch.int64)
        span = high.to(like.device) - low
        return (low + torch.minimum(torch.floor(u * span), span - 1)).to(torch.int64)

    def permutations(self, shape, like):
        """Independent uniform permutations of ``range(shape[-1])``, one per
        leading index."""
        return self._rand(like, shape).argsort(-1)

    def choice(self, weights):
        """An index drawn with probability proportional to ``weights``, as a
        host integer (one sync)."""
        return int(torch.multinomial(weights, 1, generator=self.generator))

    def categorical(self, weights, shape):
        """``int64`` indices of ``shape`` drawn with replacement in
        proportion to ``weights``."""
        n = math.prod(shape)
        idx = torch.multinomial(weights, n, replacement=True, generator=self.generator)
        return idx.reshape(shape)

    def prior(self, draw_fn, num):
        """``num`` independent runs of ``draw_fn(generator)`` under one
        ``vmap`` (each draws its own values)."""
        dummy = torch.zeros(num, device=self.generator.device)
        return torch.func.vmap(lambda _: draw_fn(self.generator), randomness="different")(dummy)


class ShardedDraws(GeneratorDraws):
    """This rank's rows of the draws of a chain panel that is sharded over
    ranks (``shard``: a ``parallel.mesh.ChainShard``).  Every draw is made
    for all ``shard.num_chains`` real chains from ``generator``, as
    :class:`GeneratorDraws` makes it in one process, then for the pad rows
    from ``pad_generator`` (only on the rank that holds them), and the rank
    keeps its rows: a sharded run draws what the one-process run draws, row
    for row, and the pad draws nothing from the real chains' generator.
    Every rank's ``generator`` goes through the same states.

    A draw without a leading chain axis (``choice``, ``categorical``,
    ``prior``, an ensemble's half-panel draws) raises: the kernels that make
    one couple their chains and do not run sharded."""

    def __init__(self, generator, shard, pad_generator=None):
        super().__init__(generator)
        self.shard = shard
        self.pad_generator = pad_generator

    def _draw(self, draw, shape):
        shard = self.shard
        shape = tuple(shape)
        if not shape or shape[0] != shard.size:
            raise NotImplementedError(
                f"a draw of shape {shape} has no leading axis of this rank's {shard.size} "
                "chains, so it cannot be taken from the full panel's draws"
            )
        rest = shape[1:]
        full = draw(self.generator, (shard.num_chains,) + rest)
        if shard.stop > shard.num_chains:
            if self.pad_generator is None:
                raise ValueError("this rank holds pad chains but has no pad generator")
            full = torch.cat([full, draw(self.pad_generator, (shard.padded - shard.num_chains,)
                                         + rest)])
        return full[shard.start : shard.stop]

    def _unsharded(self, *args, **kwargs):
        raise NotImplementedError(
            "this draw has no chain axis to shard: the kernel that makes it couples its "
            "chains and runs on one process (ROADMAP.md)"
        )

    choice = categorical = prior = _unsharded


def _draw_sources(tree):
    """The generators and draw sources in ``tree``, in order."""
    if isinstance(tree, torch.Generator) or hasattr(tree, "generator"):
        return [tree]
    if isinstance(tree, dict):
        return [g for v in tree.values() for g in _draw_sources(v)]
    if isinstance(tree, (tuple, list)):
        return [g for v in tree for g in _draw_sources(v)]
    return []


def replace_draw_sources(tree, source):
    """``tree`` with every generator or draw source in it replaced by
    ``source``."""
    if isinstance(tree, torch.Generator) or hasattr(tree, "generator"):
        return source
    if isinstance(tree, dict):
        return {k: replace_draw_sources(v, source) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replace_draw_sources(v, source) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replace_draw_sources(v, source) for v in tree)
    return tree


def shard_state(state, shard, pad_generator=None):
    """This rank's rows (``shard.take``) of every tensor leaf of ``state``
    with a leading axis of ``shard.num_chains``; its generators (or draw
    sources) become one :class:`ShardedDraws` on the first one's generator."""
    rows = tree_map(
        lambda x: shard.take(x) if x.dim() >= 1 and x.shape[0] == shard.num_chains else x, state
    )
    sources = _draw_sources(state)
    if not sources:
        return rows
    generator = getattr(sources[0], "generator", sources[0])
    return replace_draw_sources(rows, ShardedDraws(generator, shard, pad_generator))


def gather_state(state):
    """The full panel of a state that :func:`shard_state` sharded (``state``
    as it is otherwise): every rank's rows of its chain fields gathered over
    the chain group, the pad dropped, and its sharded draw source
    (:class:`ShardedDraws`) replaced by the generator under it, which every
    rank holds in the same state."""
    found = [g for g in _draw_sources(state) if getattr(g, "shard", None) is not None]
    if not found:
        return state
    shard = found[0].shard
    whole = tree_map(
        lambda x: shard.gather(x) if x.dim() >= 1 and x.shape[0] == shard.size else x, state
    )
    return replace_draw_sources(whole, found[0].generator)


def refuse_sharded(rng_key, kernel):
    """Raise for a kernel whose transition couples its chains when its state
    is sharded over more than one rank."""
    shard = getattr(rng_key, "shard", None)
    if shard is not None and shard.group is not None:
        raise NotImplementedError(
            f"{kernel} couples its chains in every transition and does not run with its "
            "chains sharded over ranks yet (ROADMAP.md)"
        )


def _all_chains(draws, mask):
    """Whether ``mask`` ``(C,)`` holds for every chain: this process's, or
    with a sharded draw source every rank's real chains (one host read)."""
    shard = getattr(draws, "shard", None)
    return bool(mask.all()) if shard is None else shard.all(mask)


def _full_panel(draws, x):
    """Every chain's ``x``: this process's, or gathered over the chain group
    where ``draws`` is sharded (the real chains only)."""
    shard = getattr(draws, "shard", None)
    return x if shard is None else shard.gather(x)


def as_draws(rng_key):
    """A draw source from a ``torch.Generator``; a draw source passes."""
    return GeneratorDraws(rng_key) if isinstance(rng_key, torch.Generator) else rng_key


# ---------------------------------------------------------------------------
# Leapfrog


def leapfrog(pe_grad, blocks, inv_mass, eps, z, r, grad):
    """One velocity-Verlet step with per-chain signed step size eps (C,)."""
    e = eps[:, None]
    r_half = r - 0.5 * e * grad
    z_new = z + e * apply_inv_mass(blocks, inv_mass, r_half)
    pe_new, grad_new = pe_grad(z_new)
    r_new = r_half - 0.5 * e * grad_new
    return z_new, r_new, pe_new, grad_new


def popcount(n):
    """Bits set in each int32 (SWAR; torch has no population count)."""
    n = n - ((n >> 1) & 0x55555555)
    n = (n & 0x33333333) + ((n >> 2) & 0x33333333)
    n = (n + (n >> 4)) & 0x0F0F0F0F
    n = n + (n >> 8)
    n = n + (n >> 16)
    return n & 0x3F


# ---------------------------------------------------------------------------
# NUTS transition: all chains, one loop, one gradient per tick

NutsCarry = namedtuple(
    "NutsCarry",
    [
        # building edge (the point the next leapfrog starts from)
        "z", "r", "grad", "pe",
        # trajectory ends in time order (bwd = earliest, fwd = latest)
        "zb", "rb", "gradb", "peb",
        "zf", "rf", "gradf", "pef",
        "rho",  # (C, D) total momentum sum over the trajectory
        # current multinomial proposal over the whole trajectory
        "prop_z", "prop_grad", "prop_pe", "prop_energy",
        "logw",  # (C,) log total weight of the trajectory
        # subtree under construction
        "s_logw", "s_prop_z", "s_prop_grad", "s_prop_pe", "s_prop_energy",
        "s_prefix",  # (C, D) running momentum sum inside the subtree
        "ck_r", "ck_s",  # (C, K, D) checkpoint momenta / prefix sums
        "leaf", "depth",  # (C,) int32
        "direction",  # (C,) +-1.0
        "e0", "accept_sum", "n_leaf",  # (C,)
        "diverging", "done",  # (C,) bool
    ],
)
"""The JAX ``NutsCarry`` without its ``key`` field."""


def carry_from_numpy(fields, device="cpu"):
    """The port's carry from the fields of a JAX ``NutsCarry`` given as numpy
    arrays (a mapping or namedtuple; its ``key`` field is dropped), so that
    one tick can be run from the same state in both packages."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    return NutsCarry(
        **{k: torch.from_numpy(np.array(fields[k])).to(device) for k in NutsCarry._fields}
    )


def _turning(blocks, inv_mass, r_first, r_last, rho):
    """Generalized U-turn criterion; supports extra broadcast axes."""
    vf = apply_inv_mass(blocks, inv_mass, r_first)
    vl = apply_inv_mass(blocks, inv_mass, r_last)
    return ((rho * vf).sum(-1) <= 0) | ((rho * vl).sum(-1) <= 0)


def _sel(mask, new, old):
    """Per-chain select with broadcasting over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _init_nuts_carry(z, pe, grad, blocks, inv_mass, sqrt_mass, k_slots, eps, direction):
    """Fresh trajectory from ``z`` with momentum noise ``eps`` (C, D) and
    first direction ``direction`` (C,)."""
    c, d = z.shape
    r0 = draw_momentum(blocks, sqrt_mass, eps)
    e0 = pe + kinetic(blocks, inv_mass, r0)
    zeros_i = torch.zeros((c,), dtype=torch.int32, device=z.device)
    false = torch.zeros((c,), dtype=torch.bool, device=z.device)
    return NutsCarry(
        z=z, r=r0, grad=grad, pe=pe,
        zb=z, rb=r0, gradb=grad, peb=pe,
        zf=z, rf=r0, gradf=grad, pef=pe,
        rho=r0,
        prop_z=z, prop_grad=grad, prop_pe=pe, prop_energy=e0,
        logw=-e0,
        s_logw=torch.full_like(pe, -math.inf),
        s_prop_z=z, s_prop_grad=grad, s_prop_pe=pe, s_prop_energy=e0,
        s_prefix=torch.zeros_like(z),
        ck_r=z.new_zeros((c, k_slots, d)),
        ck_s=z.new_zeros((c, k_slots, d)),
        leaf=zeros_i, depth=zeros_i,
        direction=direction.to(z.dtype),
        e0=e0,
        accept_sum=torch.zeros_like(pe),
        n_leaf=zeros_i,
        diverging=false, done=false,
    )


def _nuts_tick(
    t, blocks, pe_grad, inv_mass, step_size, max_depth, max_delta_energy,
    u_swap, u_merge, new_direction,
):
    """One batched leapfrog + tree bookkeeping for every chain.  The draws
    are uniforms ``u_swap``, ``u_merge`` (C,) and a +-1 ``new_direction``
    (C,) (JAX draws them from the carry's keys at hmc_core.py:452)."""
    active = ~t.done
    eps = t.direction * step_size
    z_n, r_n, pe_n, grad_n = leapfrog(pe_grad, blocks, inv_mass, eps, t.z, t.r, t.grad)
    energy = pe_n + kinetic(blocks, inv_mass, r_n)
    energy = torch.where(torch.isnan(energy), math.inf, energy)
    delta = energy - t.e0
    div_leaf = delta > max_delta_energy
    logw_leaf = -energy
    accept_leaf = torch.exp(torch.clamp(-delta, max=0.0))
    accept_sum = t.accept_sum + torch.where(active, accept_leaf, 0.0)
    n_leaf = t.n_leaf + active.to(torch.int32)

    # --- iterative U-turn machinery, vectorized over checkpoint slots
    n = t.leaf
    pc = popcount(n)
    is_even = (n & 1) == 0
    k_slots = t.ck_r.shape[1]
    slot_ids = torch.arange(k_slots, dtype=torch.int32, device=n.device)
    # even leaf: store (momentum, prefix-before) at slot popcount(n)
    store = (active & is_even)[:, None] & (slot_ids[None, :] == pc[:, None])
    ck_r = torch.where(store[..., None], r_n[:, None, :], t.ck_r)
    ck_s = torch.where(store[..., None], t.s_prefix[:, None, :], t.ck_s)
    s_after = t.s_prefix + r_n
    # odd leaf: check slots [pc - trailing_ones, pc)
    t_ones = popcount(n ^ (n + 1)) - 1
    check = (
        (active & ~is_even)[:, None]
        & (slot_ids[None, :] >= (pc - t_ones)[:, None])
        & (slot_ids[None, :] < pc[:, None])
    )
    rho_k = s_after[:, None, :] - ck_s  # momentum sum over each subspan
    turn_k = _turning(blocks, inv_mass, ck_r, r_n[:, None, :], rho_k)
    turn_within = (check & turn_k).any(1)

    # --- progressive multinomial inside the subtree
    s_logw = torch.logaddexp(t.s_logw, logw_leaf)
    take = active & (torch.log(u_swap) < (logw_leaf - s_logw))
    s_prop_z = _sel(take, z_n, t.s_prop_z)
    s_prop_grad = _sel(take, grad_n, t.s_prop_grad)
    s_prop_pe = torch.where(take, pe_n, t.s_prop_pe)
    s_prop_energy = torch.where(take, energy, t.s_prop_energy)

    invalid = div_leaf | turn_within
    leaf_next = n + 1
    complete = leaf_next == (1 << t.depth)
    a_bad = active & invalid  # transition over, discard subtree
    b_merge = active & ~invalid & complete  # subtree done, merge into tree
    c_cont = active & ~invalid & ~complete  # keep building the subtree

    # --- merge: biased progressive sampling between tree and subtree
    merge_take = b_merge & (torch.log(u_merge) < (s_logw - t.logw))
    prop_z = _sel(merge_take, s_prop_z, t.prop_z)
    prop_grad = _sel(merge_take, s_prop_grad, t.prop_grad)
    prop_pe = torch.where(merge_take, s_prop_pe, t.prop_pe)
    prop_energy = torch.where(merge_take, s_prop_energy, t.prop_energy)
    logw = torch.where(b_merge, torch.logaddexp(t.logw, s_logw), t.logw)
    rho = _sel(b_merge, t.rho + s_after, t.rho)

    fwd = b_merge & (t.direction > 0)
    bwd = b_merge & (t.direction < 0)
    zf = _sel(fwd, z_n, t.zf)
    rf = _sel(fwd, r_n, t.rf)
    gradf = _sel(fwd, grad_n, t.gradf)
    pef = torch.where(fwd, pe_n, t.pef)
    zb = _sel(bwd, z_n, t.zb)
    rb = _sel(bwd, r_n, t.rb)
    gradb = _sel(bwd, grad_n, t.gradb)
    peb = torch.where(bwd, pe_n, t.peb)

    turn_tree = b_merge & _turning(blocks, inv_mass, rb, rf, rho)
    depth = t.depth + b_merge.to(torch.int32)
    done = t.done | a_bad | turn_tree | (b_merge & (depth >= max_depth))
    diverging = t.diverging | (active & div_leaf)

    # --- next building edge: new subtree starts at a trajectory end
    start_new = b_merge & ~done
    direction = torch.where(start_new, new_direction.to(t.direction.dtype), t.direction)
    go_fwd = direction > 0
    z = _sel(c_cont, z_n, _sel(go_fwd, zf, zb))
    r = _sel(c_cont, r_n, _sel(go_fwd, rf, rb))
    grad = _sel(c_cont, grad_n, _sel(go_fwd, gradf, gradb))
    pe = torch.where(c_cont, pe_n, torch.where(go_fwd, pef, peb))

    reset = b_merge | a_bad
    return NutsCarry(
        z=z, r=r, grad=grad, pe=pe,
        zb=zb, rb=rb, gradb=gradb, peb=peb,
        zf=zf, rf=rf, gradf=gradf, pef=pef,
        rho=rho,
        prop_z=prop_z, prop_grad=prop_grad, prop_pe=prop_pe, prop_energy=prop_energy,
        logw=logw,
        s_logw=torch.where(reset, -math.inf, s_logw),
        s_prop_z=s_prop_z, s_prop_grad=s_prop_grad,
        s_prop_pe=s_prop_pe, s_prop_energy=s_prop_energy,
        s_prefix=_sel(reset, torch.zeros_like(s_after), s_after),
        ck_r=ck_r, ck_s=ck_s,
        leaf=torch.where(reset, 0, torch.where(active, leaf_next, n)).to(torch.int32),
        depth=depth,
        direction=direction,
        e0=t.e0,
        accept_sum=accept_sum,
        n_leaf=n_leaf,
        diverging=diverging,
        done=done,
    )


TransitionOut = namedtuple(
    "TransitionOut", ["z", "pe", "grad", "energy", "num_steps", "accept_prob", "diverging"]
)
"""The JAX ``TransitionOut`` without its ``key`` field."""


def nuts_transition(
    pe_grad, blocks, draws, z, pe, grad, inv_mass, sqrt_mass, step_size, max_depth,
    max_delta_energy=1000.0, k_slots=None,
):
    """One multinomial-NUTS transition for all chains (parity target:
    ``numpyro_tpu.infer.hmc_core.nuts_transition``)."""
    k_slots = k_slots if k_slots is not None else max(int(max_depth), 1)
    eps, direction = draws.start(z)
    t = _init_nuts_carry(z, pe, grad, blocks, inv_mass, sqrt_mass, k_slots, eps, direction)
    c, d = z.shape
    if d == 0:
        return TransitionOut(
            z, pe, grad, t.e0, torch.ones((c,), dtype=torch.int32, device=z.device),
            torch.ones_like(pe), torch.zeros((c,), dtype=torch.bool, device=z.device),
        )
    # a tree of depth d is whole after 2^d - 1 leapfrogs, so the host reads
    # the loop's condition after ticks 1, 3, 7, 15, ...: shallow trees cost no
    # tick beyond their last, and a tree at the depth cap costs log2 reads
    ticks, next_check = 0, 1
    while True:
        t = _nuts_tick(
            t, blocks, pe_grad, inv_mass, step_size, max_depth, max_delta_energy,
            *draws.tick(z),
        )
        ticks += 1
        if ticks == next_check:
            if _all_chains(draws, t.done):
                break
            next_check = 2 * next_check + 1
    accept_prob = t.accept_sum / t.n_leaf.clamp(min=1)
    return TransitionOut(
        t.prop_z, t.prop_pe, t.prop_grad, t.prop_energy, t.n_leaf, accept_prob, t.diverging
    )


# ---------------------------------------------------------------------------
# Fixed-trajectory HMC transition (per-chain trajectory lengths)


def integrate_segment(pe_grad, blocks, inv_mass, step_size, num_steps, z, r, pe, grad):
    """Leapfrog every chain for its own ``num_steps`` (C,) (lagging chains are
    masked; the momentum is carried, not refreshed).  The loop's length is
    the largest count, read from the device once."""
    step = torch.zeros_like(num_steps)
    for _ in range(int(num_steps.max())):
        live = step < num_steps
        z_n, r_n, pe_n, grad_n = leapfrog(pe_grad, blocks, inv_mass, step_size, z, r, grad)
        z, r, grad = _sel(live, z_n, z), _sel(live, r_n, r), _sel(live, grad_n, grad)
        pe = torch.where(live, pe_n, pe)
        step = step + live.to(step.dtype)
    return z, r, pe, grad


def hmc_transition(
    pe_grad, blocks, draws, z, pe, grad, inv_mass, sqrt_mass, step_size,
    trajectory_length=None, num_steps=None, max_delta_energy=1000.0,
):
    """One batched HMC transition; each chain runs ceil(length / step size)
    leapfrogs (parity target: ``numpyro_tpu.infer.hmc_core.hmc_transition``)."""
    c, d = z.shape
    if d == 0:
        return TransitionOut(
            z, pe, grad, pe, torch.ones((c,), dtype=torch.int32, device=z.device),
            torch.ones_like(pe), torch.zeros((c,), dtype=torch.bool, device=z.device),
        )
    eps, u_accept = draws.hmc_start(z)
    r0 = draw_momentum(blocks, sqrt_mass, eps)
    e0 = pe + kinetic(blocks, inv_mass, r0)
    if num_steps is None:
        lengths = torch.ceil(trajectory_length / step_size).to(torch.int32).clamp(min=1)
    else:
        lengths = torch.full((c,), num_steps, dtype=torch.int32, device=z.device)
    z1, r1, pe1, grad1 = integrate_segment(
        pe_grad, blocks, inv_mass, step_size, lengths, z, r0, pe, grad
    )
    e1 = pe1 + kinetic(blocks, inv_mass, r1)
    delta = torch.where(torch.isnan(e1), math.inf, e1) - e0
    accept_prob = torch.exp(torch.clamp(-delta, max=0.0))
    take = torch.log(u_accept) < -delta
    return TransitionOut(
        _sel(take, z1, z), torch.where(take, pe1, pe), _sel(take, grad1, grad),
        torch.where(take, e1, e0), lengths, accept_prob, delta > max_delta_energy,
    )


# ---------------------------------------------------------------------------
# Batched reasonable-step-size search (all chains search simultaneously)


def batched_step_size_search(
    pe_grad, blocks, draws, z, pe, grad, inv_mass, sqrt_mass, init_step_size,
    target=0.8,
):
    """Per-chain doubling/halving search for a step size whose single-step
    acceptance crosses ``target``, as one masked loop over all chains."""
    c, d = z.shape
    ss = torch.as_tensor(init_step_size, dtype=z.dtype, device=z.device).expand(c).clone()
    if d == 0:
        return ss
    log_target = math.log(target)
    finfo = torch.finfo(z.dtype)
    prev_dir = torch.zeros_like(ss)
    cur_dir = torch.zeros_like(ss)
    settled = torch.zeros((c,), dtype=torch.bool, device=z.device)
    while True:
        for _ in range(CHECK_EVERY):
            ss_new = torch.where(settled, ss, ss * 2.0**cur_dir)
            r = draw_momentum(blocks, sqrt_mass, draws.normal(z))
            _, r1, pe1, _ = leapfrog(pe_grad, blocks, inv_mass, ss_new, z, r, grad)
            e0 = pe + kinetic(blocks, inv_mass, r)
            e1 = pe1 + kinetic(blocks, inv_mass, r1)
            delta = torch.where(torch.isnan(e1), math.inf, e1 - e0)
            new_dir = torch.where(log_target < -delta, 1.0, -1.0).to(z.dtype)
            crossed = (prev_dir != 0.0) & (new_dir != prev_dir)
            extreme = (ss_new <= finfo.tiny) | (ss_new >= finfo.max)
            ss = torch.where(settled, ss, ss_new)
            prev_dir = torch.where(settled, prev_dir, new_dir)
            cur_dir = torch.where(settled, cur_dir, new_dir)
            settled = settled | crossed | extreme
        if _all_chains(draws, settled):
            return ss


# ---------------------------------------------------------------------------
# Warmup adaptation, batched over chains: Stan windows (75 / 25*2^k / 50),
# per-chain dual averaging and Welford (co)variance estimates per mass block

AdaptPanel = namedtuple(
    "AdaptPanel",
    [
        "step_size",  # (C,)
        "inverse_mass_matrix", "mass_matrix_sqrt", "mass_matrix_sqrt_inv",
        "da_log", "da_log_avg", "da_grad_avg", "da_count", "da_anchor",  # (C,)
        "wf_mean", "wf_m2", "wf_count",  # welford (structured like the mass)
    ],
)
"""The JAX ``AdaptPanel`` without its ``rng_key`` field."""


def _numpy_tree(x, device):
    """numpy arrays (in dicts) -> tensors on ``device``."""
    if isinstance(x, dict):
        return {k: _numpy_tree(v, device) for k, v in x.items()}
    return None if x is None else torch.from_numpy(np.array(x)).to(device)


def adapt_from_numpy(fields, device="cpu"):
    """The port's ``AdaptPanel`` from the fields of a JAX ``AdaptPanel``
    given as numpy arrays (a mapping or namedtuple; its ``rng_key`` field is
    dropped); a mass field may be a dict of them keyed by site-name tuples."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    return AdaptPanel(**{k: _numpy_tree(fields[k], device) for k in AdaptPanel._fields})


def stan_windows(num_steps):
    """(start, end) inclusive windows; list shrinks for short warmups."""
    if num_steps < 20:
        return [(0, num_steps - 1)]
    head, tail, first = 75, 50, 25
    if head + tail + first > num_steps:
        head = int(0.15 * num_steps)
        tail = int(0.1 * num_steps)
        first = num_steps - head - tail
    windows = [(0, head - 1)]
    pos, width = head, first
    last_start = num_steps - tail
    while pos < last_start:
        end = pos + width if 3 * width <= last_start - pos else last_start
        windows.append((pos, end - 1))
        pos, width = end, 2 * width
    windows.append((last_start, num_steps - 1))
    return windows


def _window_masks(num_warmup):
    """Per-step host masks: inside a middle window / at a middle-window end."""
    in_middle = np.zeros(max(num_warmup, 1), bool)
    at_end = np.zeros(max(num_warmup, 1), bool)
    windows = stan_windows(num_warmup)
    for w_idx, (start, end) in enumerate(windows):
        if 0 < w_idx < len(windows) - 1:
            in_middle[start : end + 1] = True
            at_end[end] = True
    return in_middle, at_end


def _welford_init(blocks, num_chains, like):
    means, m2s = [], []
    for idx, dense in zip(blocks.indices, blocks.dense):
        b = len(idx)
        means.append(like.new_zeros((num_chains, b)))
        m2s.append(like.new_zeros((num_chains, b, b) if dense else (num_chains, b)))
    return _expose(blocks, means), _expose(blocks, m2s), like.new_zeros((num_chains,))


def welford_step(mean, m2, n, x, dense):
    """One Welford update of ``(mean, m2)`` by the sample ``x``; ``n`` is the
    count with ``x``, broadcast against ``mean``.  The engine's per-chain
    panels and ``hmc_util.welford_covariance`` share it."""
    pre = x - mean
    mean = mean + pre / n
    post = x - mean
    return mean, m2 + (post[..., :, None] * pre[..., None, :] if dense else post * pre)


def covariance_factors(m2, n, dense, regularize=True):
    """Welford's ``m2`` over ``n`` samples -> ``(cov, sqrt, sqrt_inv)``: the
    covariance, shrunk towards ``1e-3`` times the identity when
    ``regularize``, and the mass-matrix factors (``sqrt`` the Cholesky factor
    of its inverse, ``sqrt_inv`` that factor's inverse).  ``n`` broadcasts
    against ``m2``."""
    cov = m2 / torch.clamp(n - 1, min=1)
    if regularize:
        shrink = (n / (n + 5.0)) * cov
        ridge = 1e-3 * (5.0 / (n + 5.0))
        if dense:
            eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
            cov = shrink + ridge * eye
        else:
            cov = shrink + ridge
    if dense:
        sqrt, sqrt_inv = _precision_factors(cov)
    else:
        sqrt_inv = torch.sqrt(cov)
        sqrt = 1.0 / sqrt_inv
    return cov, sqrt, sqrt_inv


def _welford_update(blocks, wf, z_flat):
    means, m2s, count = wf
    count = count + 1
    new_means, new_m2s = [], []
    for dense, mean, m2, x in zip(
        blocks.dense, _as_parts(blocks, means), _as_parts(blocks, m2s),
        _block_slices(blocks, z_flat),
    ):
        mean, m2 = welford_step(mean, m2, count[:, None], x, dense)
        new_means.append(mean)
        new_m2s.append(m2)
    return _expose(blocks, new_means), _expose(blocks, new_m2s), count


def _welford_finalize(blocks, wf, regularize=True):
    """Per-chain covariance estimate -> exposed (inv_mass, sqrt, sqrt_inv)."""
    _, m2s, count = wf
    inv_p, sqrt_p, sqrt_inv_p = [], [], []
    for dense, m2 in zip(blocks.dense, _as_parts(blocks, m2s)):
        n = count.reshape(count.shape + (1,) * (m2.dim() - 1))
        cov, sqrt, sqrt_inv = covariance_factors(m2, n, dense, regularize)
        inv_p.append(cov)
        sqrt_p.append(sqrt)
        sqrt_inv_p.append(sqrt_inv)
    return _expose(blocks, inv_p), _expose(blocks, sqrt_p), _expose(blocks, sqrt_inv_p)


def _welford_pool(blocks, wf, draws=None):
    """Pool per-chain Welford states into one estimate broadcast over chains
    (parallel-Welford merge with the between-chain spread).  With a sharded
    ``draws`` the states of every rank's real chains are pooled, as one
    process pools them, and broadcast over this rank's rows."""
    local_means, local_m2s, local_count = wf
    means, m2s, count = tree_map(lambda x: _full_panel(draws, x), wf)
    pooled_means, pooled_m2s = [], []
    for dense, mean, m2, local_mean, local_m2 in zip(
        blocks.dense, _as_parts(blocks, means), _as_parts(blocks, m2s),
        _as_parts(blocks, local_means), _as_parts(blocks, local_m2s),
    ):
        grand = mean.mean(0, keepdim=True)  # equal per-chain counts
        spread = mean - grand
        n = count.reshape(count.shape + (1,) * (m2.dim() - 1))
        between = spread[:, :, None] * spread[:, None, :] if dense else spread**2
        pooled_means.append(grand.expand_as(local_mean))
        pooled_m2s.append((m2 + n * between).sum(0, keepdim=True).expand_as(local_m2))
    return (
        _expose(blocks, pooled_means), _expose(blocks, pooled_m2s),
        count.sum().expand_as(local_count),
    )


def dual_averaging_step(g, t, g_avg, x_avg, prox_center, t0=10.0, kappa=0.75, gamma=0.05):
    """One step of Nesterov's dual averaging on the noisy gradient ``g``:
    ``(x_t, x_avg, g_avg, t)`` after it, from the step count ``t`` (a float
    or an integer tensor), the running gradient ``g_avg``, the averaged
    iterate ``x_avg`` and the centre ``prox_center``.  The engine's step-size
    warmup and ``hmc_util.dual_averaging`` share it."""
    t = t + 1
    n = t if t.is_floating_point() else t.to(g_avg.dtype)
    g_avg = (1 - 1 / (n + t0)) * g_avg + g / (n + t0)
    x_t = prox_center - torch.sqrt(n) / gamma * g_avg
    w = n ** (-kappa)
    x_avg = (1 - w) * x_avg + w * x_t
    return x_t, x_avg, g_avg, t


def _pool_step_size(ss, draws=None):
    """Harmonic-mean pooled step size, broadcast over chains (every rank's
    real chains with a sharded ``draws``)."""
    return (1.0 / (1.0 / _full_panel(draws, ss)).mean()).expand_as(ss)


def build_warmup(
    pe_grad, blocks, num_warmup, *, adapt_step_size=True, adapt_mass_matrix=True,
    target_accept_prob=0.8, regularize_mass_matrix=True, da_t0=10.0, da_kappa=0.75,
    da_gamma=0.05, find_step_size=True, pool_chains=False,
):
    """Returns ``(init_fn, update_fn)`` for chain-batched warmup adaptation
    (parity target: ``numpyro_tpu.infer.hmc_core.build_warmup``)."""
    in_middle, at_end = _window_masks(num_warmup)

    def da_reset(step_size):
        z = torch.zeros_like(step_size)
        return (z, z, z, z, torch.log(10.0 * step_size))

    def search(draws, z, pe, grad, inv, sqrt, ss):
        ss = batched_step_size_search(
            pe_grad, blocks, draws, z, pe, grad, inv, sqrt, ss, target=target_accept_prob
        )
        return _pool_step_size(ss, draws) if pool_chains else ss

    def init_fn(draws, z, pe, grad, step_size, inverse_mass_matrix=None):
        c, d = z.shape
        inv, sqrt, sqrt_inv = init_mass(blocks, c, z, init_inverse=inverse_mass_matrix)
        ss = torch.as_tensor(step_size, dtype=z.dtype, device=z.device).expand(c)
        if adapt_step_size and find_step_size and d > 0:
            ss = search(draws, z, pe, grad, inv, sqrt, ss)
        return AdaptPanel(ss, inv, sqrt, sqrt_inv, *da_reset(ss), *_welford_init(blocks, c, z))

    def _da_update(adapt, accept_prob, is_last, draws):
        if pool_chains:
            # geometric mean: one stuck chain vetoes equilibrium
            # (numpyro_tpu/infer/hmc_core.py:1011)
            full = _full_panel(draws, accept_prob)
            pooled = torch.exp(torch.log(torch.clamp(full, min=1e-6)).mean())
            accept_prob = pooled.expand_as(accept_prob)
        log_ss, log_avg, grad_avg, count = dual_averaging_step(
            target_accept_prob - accept_prob, adapt.da_count, adapt.da_grad_avg,
            adapt.da_log_avg, adapt.da_anchor, da_t0, da_kappa, da_gamma,
        )
        step_size = torch.exp(log_avg if is_last else log_ss)
        finfo = torch.finfo(step_size.dtype)
        step_size = torch.clamp(step_size, finfo.tiny, finfo.max)
        return adapt._replace(
            step_size=step_size, da_log=log_ss, da_log_avg=log_avg,
            da_grad_avg=grad_avg, da_count=count,
        )

    def _window_end(adapt, z, pe, grad, draws):
        inv, sqrt, sqrt_inv = (
            adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt, adapt.mass_matrix_sqrt_inv
        )
        if adapt_mass_matrix:
            wf = (adapt.wf_mean, adapt.wf_m2, adapt.wf_count)
            if pool_chains:
                wf = _welford_pool(blocks, wf, draws)
            inv, sqrt, sqrt_inv = _welford_finalize(blocks, wf, regularize=regularize_mass_matrix)
        ss = adapt.step_size
        if adapt_step_size:
            if find_step_size:
                ss = search(draws, z, pe, grad, inv, sqrt, ss)
            da = da_reset(ss)
        else:
            da = (adapt.da_log, adapt.da_log_avg, adapt.da_grad_avg,
                  adapt.da_count, adapt.da_anchor)
        return AdaptPanel(ss, inv, sqrt, sqrt_inv, *da, *_welford_init(blocks, z.shape[0], z))

    def update_fn(i, adapt, accept_prob, z, pe, grad, draws):
        """``i``: the warmup step index, the same for every chain."""
        idx = min(i, max(num_warmup - 1, 0))
        if adapt_step_size:
            adapt = _da_update(adapt, accept_prob, i == num_warmup - 1, draws)
        if adapt_mass_matrix and num_warmup > 0 and in_middle[idx]:
            wf = _welford_update(blocks, (adapt.wf_mean, adapt.wf_m2, adapt.wf_count), z)
            adapt = adapt._replace(wf_mean=wf[0], wf_m2=wf[1], wf_count=wf[2])
        if num_warmup > 0 and at_end[idx]:
            adapt = _window_end(adapt, z, pe, grad, draws)
        return adapt

    return init_fn, update_fn


# ---------------------------------------------------------------------------
# Whole run: synchronous warmup, then asynchronous harvest sampling


class FusedRun:
    """Warmup + sampling for all chains (port of ``build_fused_run``).

    Warmup is synchronous at transition granularity; sampling is the
    asynchronous harvest loop: every tick advances every chain one leapfrog,
    and a chain that completes a transition banks its draw and starts the
    next trajectory at once.  A run then costs the slowest chain's total
    leapfrogs, not the sum over transitions of the longest tree.
    """

    def __init__(
        self, pe_grad, blocks, *, algo="NUTS", num_warmup, num_samples, thinning=1,
        max_depth=10, warmup_max_depth=None, trajectory_length=None, fixed_num_steps=None,
        max_delta_energy=1000.0, **adapt_kwargs,
    ):
        self.pe_grad, self.blocks, self.algo = pe_grad, blocks, algo
        self.trajectory_length, self.fixed_num_steps = trajectory_length, fixed_num_steps
        self.num_warmup, self.num_samples, self.thinning = num_warmup, num_samples, thinning
        self.max_depth = max_depth
        self.warmup_max_depth = warmup_max_depth or max_depth
        self.max_delta_energy = max_delta_energy
        self.k_slots = max(max_depth, self.warmup_max_depth, 1)
        self.wa_init, self.wa_update = build_warmup(pe_grad, blocks, num_warmup, **adapt_kwargs)

    def transition(self, draws, z, pe, grad, adapt, depth_cap):
        if self.algo == "NUTS":
            return nuts_transition(
                self.pe_grad, self.blocks, draws, z, pe, grad,
                adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt, adapt.step_size,
                depth_cap, self.max_delta_energy, k_slots=self.k_slots,
            )
        return hmc_transition(
            self.pe_grad, self.blocks, draws, z, pe, grad,
            adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt, adapt.step_size,
            self.trajectory_length, self.fixed_num_steps, self.max_delta_energy,
        )

    def warmup(self, draws, z, pe, grad, step_size, inverse_mass_matrix=None, progress=None):
        """Warmup transitions in lockstep; ``progress("warmup", done, total)``
        is called after each one."""
        adapt = self.wa_init(draws, z, pe, grad, step_size, inverse_mass_matrix)
        mean_acc = torch.zeros_like(pe)
        # divergent warmup transitions of each chain, counted on the device
        divergent = torch.zeros(pe.shape, dtype=torch.int64, device=z.device)
        for i in range(self.num_warmup):
            out = self.transition(draws, z, pe, grad, adapt, self.warmup_max_depth)
            z, pe, grad = out.z, out.pe, out.grad
            adapt = self.wa_update(i, adapt, out.accept_prob, z, pe, grad, draws)
            mean_acc = mean_acc + (out.accept_prob - mean_acc) / (i + 1)
            divergent = divergent + out.diverging
            if progress is not None:
                progress("warmup", i + 1, self.num_warmup)
        return {"z": z, "pe": pe, "grad": grad, "adapt": adapt, "mean_accept_prob": mean_acc,
                "num_divergent": _full_panel(draws, divergent).sum()}

    def _buffers(self, z, slots):
        c, d = z.shape
        dev = z.device
        return z.new_zeros((c, slots, d)), {
            "energy": z.new_zeros((c, slots)),
            "diverging": torch.zeros((c, slots), dtype=torch.bool, device=dev),
            "num_steps": torch.zeros((c, slots), dtype=torch.int32, device=dev),
            "accept_prob": z.new_zeros((c, slots)),
            "mean_accept_prob": z.new_zeros((c, slots)),
        }

    def _sample_sync(self, draws, z, pe, grad, adapt, progress=None):
        """Fixed-trajectory HMC: transitions in lockstep, every ``thinning``-th
        banked."""
        num_collect = (self.num_samples + self.thinning - 1) // self.thinning
        buf_z, buf = self._buffers(z, num_collect)
        mean_acc = torch.zeros_like(pe)
        for i in range(self.num_samples):
            out = self.transition(draws, z, pe, grad, adapt, self.max_depth)
            z, pe, grad = out.z, out.pe, out.grad
            mean_acc = mean_acc + (out.accept_prob - mean_acc) / (i + 1)
            if i % self.thinning == 0:
                slot = i // self.thinning
                buf_z[:, slot] = z
                for name, value in (
                    ("energy", out.energy), ("diverging", out.diverging),
                    ("num_steps", out.num_steps), ("accept_prob", out.accept_prob),
                    ("mean_accept_prob", mean_acc),
                ):
                    buf[name][:, slot] = value
            if progress is not None:
                progress("sample", i + 1, self.num_samples)
        return {
            "z": z, "pe": pe, "grad": grad, "samples_z": buf_z, "extras": buf,
            "adapt": adapt, "mean_accept_prob": mean_acc,
        }

    def sample(self, draws, z, pe, grad, adapt, progress=None):
        """Harvest loop until every chain has ``num_samples`` transitions;
        ``progress("sample", done, total)`` is called at each check with the
        transitions that every chain has finished (a host read)."""
        if self.algo != "NUTS":
            return self._sample_sync(draws, z, pe, grad, adapt, progress)
        blocks, inv, sqrt = self.blocks, adapt.inverse_mass_matrix, adapt.mass_matrix_sqrt
        c, d = z.shape
        num_samples, thinning = self.num_samples, self.thinning
        num_collect = (num_samples + thinning - 1) // thinning
        dev = z.device
        # slot num_collect is the spare that takes every non-banked write
        buf_z, buf = self._buffers(z, num_collect + 1)
        t = _init_nuts_carry(z, pe, grad, blocks, inv, sqrt, max(self.max_depth, 1),
                             *draws.start(z))
        trans_idx = torch.zeros((c,), dtype=torch.int32, device=dev)
        mean_acc = torch.zeros_like(pe)
        rows = torch.arange(c, device=dev)
        while True:
            for _ in range(CHECK_EVERY):
                finished = trans_idx >= num_samples
                t = t._replace(done=t.done | finished)
                t = _nuts_tick(
                    t, blocks, self.pe_grad, inv, adapt.step_size, self.max_depth,
                    self.max_delta_energy, *draws.tick(z),
                )
                boundary = t.done & ~finished
                acc = t.accept_sum / t.n_leaf.clamp(min=1)
                n1 = trans_idx + 1
                mean_acc = torch.where(boundary, mean_acc + (acc - mean_acc) / n1, mean_acc)
                keep = boundary & (trans_idx % thinning == 0)
                slot = torch.where(keep, trans_idx // thinning, num_collect)
                buf_z[rows, slot] = t.prop_z
                for name, value in (
                    ("energy", t.prop_energy), ("diverging", t.diverging),
                    ("num_steps", t.n_leaf), ("accept_prob", acc),
                    ("mean_accept_prob", mean_acc),
                ):
                    buf[name][rows, slot] = value
                trans_idx = torch.where(boundary, n1, trans_idx)
                # refresh momentum and restart the machines at boundaries
                restart = boundary & (trans_idx < num_samples)
                fresh = _init_nuts_carry(
                    t.prop_z, t.prop_pe, t.prop_grad, blocks, inv, sqrt,
                    t.ck_r.shape[1], *draws.start(z),
                )._replace(ck_r=t.ck_r, ck_s=t.ck_s)
                t = NutsCarry(*(_sel(restart, f, o) for f, o in zip(fresh, t)))
            if progress is not None:
                progress("sample", min(int(trans_idx.min()), num_samples), num_samples)
            if _all_chains(draws, trans_idx >= num_samples):
                break
        return {
            "z": t.prop_z,
            "pe": t.prop_pe,
            "grad": t.prop_grad,
            "samples_z": buf_z[:, :num_collect],
            "extras": {k: v[:, :num_collect] for k, v in buf.items()},
            "adapt": adapt,
            "mean_accept_prob": mean_acc,
        }


def build_fused_run(pe_grad, blocks, *, algo="NUTS", **kwargs):
    """The run object for ``algo`` (``"NUTS"`` or ``"HMC"``)."""
    if algo not in ("HMC", "NUTS"):
        raise ValueError("`algo` must be one of `HMC`, `NUTS`.")
    return FusedRun(pe_grad, blocks, algo=algo, **kwargs)
