"""Fused Bernoulli-logits GLM log-likelihood + gradient (port of
``numpyro_tpu/ops/glm.py``).

``bernoulli_logits_loglik(w, data)`` is a differentiable scalar function of
``w`` for use inside a model via ``numpyro_tpu_torch.factor``.  It is a
``torch.autograd.Function`` whose forward returns the log-likelihood and its
gradient together (the gradient is saved for backward, like the JAX
``custom_vjp``), and whose ``vmap`` rule sends all chains of a
``torch.func.vmap`` to ONE evaluation (the JAX ``custom_vmap`` rule).

Where it runs is decided by the tensor's device, never guessed:

- CUDA: the hand-written kernels of ``numpyro_tpu_torch/csrc/glm.cu``
  (``glm_split`` for ``dtype="split"``, ``glm_fused`` for float32 and
  bfloat16 storage).  A build or launch failure raises.
- CPU: the plain PyTorch version of the same function
  (:func:`plain_value_and_grad`), which the CPU tests hold against JAX.
- Any other device raises.

Precision modes (``prepare_glm_data(..., dtype=...)``), as in the JAX
package: ``torch.float32`` (f32-accurate model; no TF32 anywhere: the kernel
splits ``w``, X and the residual into three bf16 pieces each and sums the six
products that matter, see :func:`six_product_matmul`; the plain version keeps
the exact f32 product), ``"split"`` (bf16-stored design matrix with
f32-accurate hi+lo ``w``) and ``torch.bfloat16`` (all-bf16, including ``w``
and the residual).

Data sharded over ranks (``parallel.shard_data`` of X and y, then
:func:`prepare_glm_data`) gives each rank GLM data of its own rows, with its
own ``n``, padding and TMA descriptor.  The op then runs the kernel (or the
plain version) on those rows and adds one ``all_reduce`` of the partial
``(loglik (B,), grad (B, D))`` over the mesh's data group per evaluation,
for all chains at once (:func:`sum_data_shards`): the result is the whole
data set's, as the JAX package computes it for a ``shard_data``-placed X.
Each partial is float32 (the kernel sums its own partials in float64 and
rounds once), so the sum of ``S`` shards may differ from one card's value by
about ``S`` roundings of the partials, far inside ``kernel_tolerances``.

The kernels' launch plan (:func:`glm_launch_plan`) and one call's count of
operations and bytes (:func:`glm_work`) are pure functions, tested on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from numpyro_tpu_torch.ops.provenance import ProvenanceTensor, get_provenance
from numpyro_tpu_torch.parallel.data_shard import local_rows
from numpyro_tpu_torch.parallel.mesh import all_reduce

__all__ = [
    "BernoulliLogitsGLMData",
    "bernoulli_logits_loglik",
    "from_numpy_glm_data",
    "GLMLaunchPlan",
    "glm_launch_plan",
    "glm_value_and_grad",
    "glm_tensor_core_flops",
    "glm_work",
    "kernel_tolerances",
    "launch_counts",
    "plain_bernoulli_logits_loglik",
    "plain_value_and_grad",
    "prepare_glm_data",
    "reset_launch_counts",
    "six_product_matmul",
    "split_hi_lo",
    "split_hi_mid_lo",
    "sum_data_shards",
]

# same layout as the JAX package, so both score the same padded matrix; the
# CUDA kernel needs N_pad to be a multiple of its 64-column tile
_N_PAD = 32768
_LOG2 = math.log(2.0)

# the kernel's tiling (numpyro_tpu_torch/csrc/glm.cu holds the same numbers
# and refuses a plan that disagrees with them)
TILE_COLUMNS = 64  # columns of X^T per staged tile
SEGMENT_TILES = 128  # tiles per f32 accumulator run: 8,192 columns
MAX_F32_RUN_COLUMNS = TILE_COLUMNS * SEGMENT_TILES
MAX_SHARED_BYTES = 232448  # what one block may use on an H100
MAX_D_PAD = 256
_GROUP = 64  # chains per warpgroup product
_D_BLOCK = 64  # rows of X^T per d-block
_BLOCK_BYTES = _D_BLOCK * TILE_COLUMNS * 2  # one bf16 d-block
_PARTS = {"bf16": 1, "split": 2, "f32": 3}  # bf16 pieces of w and the residual

# launches of each kernel entry point (and calls of the plain version); a
# wrapper adds one where it launches, and nowhere else
launch_counts = {"glm_split": 0, "glm_fused_f32": 0, "glm_fused_bf16": 0, "plain": 0}


# how closely a kernel must agree with the plain version (kernel_tolerances)
LL_RTOL, G_RTOL = 1e-5, 1e-3


def kernel_tolerances(mode, n):
    """``(loglik rtol, gradient rtol, gradient atol)`` within which a kernel
    agrees with :func:`plain_value_and_grad` on ``n`` rows.  The GPU tests and
    the smoke run share them.

    Kernel and plain version add the same exact products of bf16 pieces in
    another order, so they differ by summation rounding only: ~1e-7 relative on
    the potential, and far less than the rtol on any gradient component of size.
    The atol is for the components near zero, and is three times the most that
    an H100 showed over eight shapes and three datasets of 581,012 rows:

    - split and f32 mode: the tensor cores' f32 accumulator truncates, so each
      64-column tile's product carries an error towards zero of about an ulp
      of the tile's sum; over the tiles of a component near zero these have
      random signs and add to ~1.8e-6 sqrt(n) at most (1.4e-3 at n = 581,012).
    - bf16 mode rounds every residual to bf16, which is discontinuous: where
      the two versions' logits differ in the last f32 bit, a residual at a
      rounding boundary lands on the other side and moves a component by
      2^-9 |r| |x| ~ 2e-3.  A component collects a few of these whatever the
      shape: 8.7e-3 at most from n = 33,000 to 581,012, where the plain
      version itself stands 4.6e-3 beyond the rtol from a float64 reference."""
    atol = 2.5e-2 if mode == "bf16" else 5e-6 * math.sqrt(n)
    return LL_RTOL, G_RTOL, atol


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _mode(dtype):
    if dtype == "split":
        return "split"
    if dtype in (torch.float32, "float32"):
        return "f32"
    if dtype in (torch.bfloat16, "bfloat16"):
        return "bf16"
    raise ValueError(f"unsupported GLM dtype {dtype!r}")


class BernoulliLogitsGLMData:
    """Pre-laid-out design matrix: Xᵀ padded to ``(D_pad, N_pad)`` with the
    observation row padded to match.  Build once via :func:`prepare_glm_data`
    (or :func:`from_numpy_glm_data`); reused across every leapfrog step.
    ``group``: the data group whose ranks hold the other rows (``None``: the
    rows are the whole data set)."""

    def __init__(self, x_t, y_row, n, d, dtype, group=None):
        if x_t.device != y_row.device:
            raise ValueError("x_t and y_row must be on the same device")
        self.x_t = x_t  # (D_pad, N_pad) float32 or bfloat16
        self.y_row = y_row  # (1, N_pad) float32
        self.n = n
        self.d = d
        self.dtype = dtype
        self.mode = _mode(dtype)
        self.group = group
        self._tensor_maps = {}  # TMA descriptors of x_t, made once each

    @property
    def device(self):
        return self.x_t.device


def prepare_glm_data(X, y, dtype=torch.float32):
    """Lay out an (N, D) design matrix and (N,) binary observations on the
    device of ``X`` (see the module docstring for ``dtype``).  Rows from
    ``parallel.shard_data`` (of X and y alike) give this rank's GLM data,
    whose op sums over the data group."""
    x_shard, y_shard = getattr(X, "data_shard", None), getattr(y, "data_shard", None)
    if (x_shard is None) != (y_shard is None) or (
        x_shard is not None and (x_shard.start, x_shard.stop) != (y_shard.start, y_shard.stop)
    ):
        raise ValueError("X and y must be the same rows: both from shard_data on one mesh, "
                         "or neither")
    if x_shard is not None and x_shard.axis != 0:
        raise ValueError("the GLM data is sharded by rows (shard_data(..., axis=0))")
    # the op sums over the data group itself: it reads the plain rows
    X, y = local_rows(X), local_rows(y)
    N, D = X.shape
    mode = _mode(dtype)
    d_pad = max(8 * ((D + 7) // 8), 8)
    n_pad = _N_PAD * ((N + _N_PAD - 1) // _N_PAD)
    store = torch.float32 if mode == "f32" else torch.bfloat16
    x_t = torch.zeros((d_pad, n_pad), dtype=store, device=X.device)
    x_t[:D, :N] = X.T.to(store)
    y_row = torch.zeros((1, n_pad), dtype=torch.float32, device=X.device)
    y_row[0, :N] = y.to(torch.float32)
    return BernoulliLogitsGLMData(x_t, y_row, N, D, dtype,
                                  None if x_shard is None else x_shard.group)


def from_numpy_glm_data(x_t, y_row, n, d, dtype, device="cpu"):
    """The port's data object from the numpy arrays of a JAX
    ``BernoulliLogitsGLMData`` (bf16 ``x_t`` arrives as numpy's 2-byte
    ``bfloat16`` extension type and is reinterpreted bit for bit)."""
    import numpy as np

    if x_t.dtype.name == "bfloat16":
        x = torch.from_numpy(x_t.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        x = torch.from_numpy(np.array(x_t, dtype=np.float32))
    y = torch.from_numpy(np.array(y_row, dtype=np.float32))
    return BernoulliLogitsGLMData(x.to(device), y.to(device), int(n), int(d), dtype)


def split_hi_lo(w):
    """Split f32 ``w`` into bf16 ``(hi, lo)`` with ``hi + lo == w`` to
    ~2^-17 relative.  ``hi`` is round-to-nearest-even on the int32 bits (the
    kernel's arithmetic, and ``lax.reduce_precision``'s); an f32->bf16->f32
    round trip would do too in eager torch, but the bit form is the one the
    kernels use and cannot be simplified away by a compiler."""
    bits = w.contiguous().view(torch.int32)
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) & -65536  # 0xFFFF0000
    hi = rne.view(torch.float32)
    return hi.to(torch.bfloat16), (w - hi).to(torch.bfloat16)


def split_hi_mid_lo(v):
    """Split f32 ``v`` into three bf16 pieces ``(hi, mid, lo)``, each the
    round-to-nearest-even of what the ones before left over (24 mantissa bits
    in all, so ``hi + mid + lo == v`` to ~2^-24 relative).  This is how the
    f32-mode kernel splits ``w``, the staged tile of X and the residual."""
    pieces = []
    rest = v.contiguous()
    for _ in range(3):
        bits = rest.view(torch.int32)
        piece = ((bits + 0x7FFF + ((bits >> 16) & 1)) & -65536).view(torch.float32)
        pieces.append(piece.to(torch.bfloat16))
        rest = rest - piece
    return tuple(pieces)


def six_product_matmul(a, b):
    """``a @ b`` in f32 from bf16 pieces, as the f32-mode kernel computes both
    of its products: each operand split by :func:`split_hi_mid_lo`, and the six
    products of weight >= 2^-16 (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid)
    summed smallest first.  Each piece product is exact in f32."""
    a_hi, a_mid, a_lo = (t.to(torch.float32) for t in split_hi_mid_lo(a))
    b_hi, b_mid, b_lo = (t.to(torch.float32) for t in split_hi_mid_lo(b))
    return (a_lo @ b_hi + a_hi @ b_lo + a_mid @ b_mid
            + a_mid @ b_hi + a_hi @ b_mid + a_hi @ b_hi)


def glm_work(mode, b, d_pad, n_pad):
    """``(operations, bytes)`` of one call: the two products (forward and
    backward) of ``b`` chains over the padded matrix, four in split mode (hi
    and lo each way), and every input read once (X^T, y, w) and every output
    written once (loglik, grad)."""
    products = {"f32": 2, "bf16": 2, "split": 4}[mode]
    flops = products * 2 * b * d_pad * n_pad
    x_bytes = d_pad * n_pad * (4 if mode == "f32" else 2)
    return flops, x_bytes + 4 * n_pad + 4 * b * d_pad + 4 * b * (d_pad + 1)


def glm_tensor_core_flops(mode, b, d_pad, n_pad):
    """Operations of one call when every product is a bf16 product on the
    tensor cores.  Split and bf16 mode have no other kind (:func:`glm_work`'s
    count); f32 mode then makes the six piece products of
    :func:`six_product_matmul` each way, twelve in all, which at the tensor
    cores' rate is less work for the card than two f32 products outside them."""
    products = {"f32": 12, "bf16": 2, "split": 4}[mode]
    return products * 2 * b * d_pad * n_pad


class GLMLaunchPlan(NamedTuple):
    """How one kernel call is laid out (see :func:`glm_launch_plan`)."""

    chain_tile: int  # chains per block: 64, 128 or 256
    grid_x: int  # blocks along the columns, each with a contiguous tile range
    grid_y: int  # chain tiles
    col_split: int  # 1: the block's two warpgroups take alternate column tiles
    stages: int  # depth of the shared-memory ring of X tiles
    segs: int  # accumulator runs (segments of SEGMENT_TILES tiles) per block
    smem_bytes: int  # dynamic shared memory of a block

    @property
    def slots(self):
        """Scratch slots: one per (block along x, warpgroup if split, segment)."""
        return self.grid_x * (2 if self.col_split else 1) * self.segs

    def tile_range(self, block_x, n_tiles):
        """The column tiles ``[t0, t1)`` that block ``block_x`` walks."""
        return block_x * n_tiles // self.grid_x, (block_x + 1) * n_tiles // self.grid_x

    def scratch_shapes(self, b, d_pad):
        return (self.slots, b), (self.slots, b, d_pad)


def _smem_bytes(mode, chain_tile, d_blocks, stages):
    w_tiles = (chain_tile // _GROUP) * _PARTS[mode] * d_blocks * _BLOCK_BYTES
    if mode == "f32":  # three bf16 tiles, and a ring of f32 d-blocks
        split_tiles, stage = 3 * d_blocks * _BLOCK_BYTES, 2 * _BLOCK_BYTES
    else:
        split_tiles, stage = 0, d_blocks * _BLOCK_BYTES
    # 1024 to align the base; per stage the tile, y (256) and two barriers
    return 1024 + w_tiles + split_tiles + stages * (stage + 4 * TILE_COLUMNS + 16)


def glm_launch_plan(mode, b, d_pad, n_pad, sm_count):
    """The kernel's launch plan, a pure function of the shapes and the number
    of SMs.  The wrapper allocates scratch from it and hands it to the kernel.

    - The chain tile is the one of 64, 128, 256 that pads ``b`` least (the
      larger on a tie, so that X^T is read fewer times); 256 needs
      ``d_pad <= 64`` (registers), and every choice must leave room in shared
      memory for a ring of at least three X tiles (two 16 KiB f32 blocks in
      f32 mode).
    - About one block per SM: ``grid_x * grid_y <= sm_count`` where possible,
      each block walking a fixed contiguous range of 64-column tiles.
    - With a chain tile of 64 (bf16 modes) the block's two consumer
      warpgroups take alternate tiles, each with scratch slots of its own.
    - No f32 accumulator runs over more than ``SEGMENT_TILES`` tiles."""
    if mode not in _PARTS:
        raise ValueError(f"unknown GLM mode {mode!r}")
    if b < 1 or d_pad < 8 or d_pad % 8 or d_pad > MAX_D_PAD:
        raise ValueError(f"need b >= 1 and D_pad a multiple of 8 in [8, {MAX_D_PAD}]")
    if n_pad < TILE_COLUMNS or n_pad % TILE_COLUMNS:
        raise ValueError(f"N_pad={n_pad} is not a multiple of {TILE_COLUMNS}")
    d_blocks = -(-d_pad // _D_BLOCK)
    min_stages = 2 if mode == "f32" else 3
    best = None
    for chain_tile in (64, 128, 256) if d_blocks == 1 else (64, 128):
        room = MAX_SHARED_BYTES - _smem_bytes(mode, chain_tile, d_blocks, 0)
        stages = min(8, room // (_smem_bytes(mode, chain_tile, d_blocks, 1)
                                 - _smem_bytes(mode, chain_tile, d_blocks, 0)))
        if stages < min_stages:
            continue
        key = (-(-b // chain_tile) * chain_tile, -chain_tile)
        if best is None or key < best[0]:
            best = (key, chain_tile, stages)
    _, chain_tile, stages = best
    grid_y = -(-b // chain_tile)
    n_tiles = n_pad // TILE_COLUMNS
    grid_x = max(1, min(sm_count // grid_y, n_tiles))
    segs = -(-(-(-n_tiles // grid_x)) // SEGMENT_TILES)
    return GLMLaunchPlan(
        chain_tile, grid_x, grid_y, int(mode != "f32" and chain_tile == 64), stages, segs,
        _smem_bytes(mode, chain_tile, d_blocks, stages),
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan_for_kernel(mode, b, d_pad, n_pad, sm_count):
    plan = glm_launch_plan(mode, b, d_pad, n_pad, sm_count)
    return plan, (ctypes.c_int * len(plan))(*plan)


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library, once it has confirmed the tiling this module
    plans with."""
    from numpyro_tpu_torch.ops import _cuda

    lib = _cuda.load()
    tiling = (lib.glm_tile_columns(), lib.glm_segment_tiles())
    if tiling != (TILE_COLUMNS, SEGMENT_TILES):
        raise RuntimeError(f"the kernels tile by {tiling}, ops/glm.py plans for "
                           f"{(TILE_COLUMNS, SEGMENT_TILES)}")
    return lib


def _tensor_map(lib, data, d_pad, n_pad):
    """The TMA descriptor of ``data.x_t``: made once per (pointer, shape) and
    kept on the data object (the kernel is launched thousands of times)."""
    is_bf16 = data.x_t.dtype == torch.bfloat16
    box_rows = _D_BLOCK * -(-d_pad // _D_BLOCK)
    key = (data.x_t.data_ptr(), d_pad, n_pad, is_bf16)
    found = data._tensor_maps.get(key)
    if found is None:
        found = ctypes.create_string_buffer(128)
        err = lib.glm_make_tensor_map(
            found, data.x_t.data_ptr(), int(is_bf16), d_pad, n_pad, box_rows
        )
        if err != 0:
            raise RuntimeError(f"encoding the TMA descriptor of X^T failed with error {err}")
        data._tensor_maps[key] = found
    return found


def _round_bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def plain_value_and_grad(w, data):
    """Plain PyTorch version of the kernels: ``(B, d)`` f32 ``w`` ->
    ``(loglik (B,), grad (B, d))`` with the kernels' hi/lo arithmetic."""
    launch_counts["plain"] += 1
    b, d = w.shape
    d_pad, n_pad = data.x_t.shape
    x = data.x_t.to(torch.float32)
    w_pad = torch.zeros((b, d_pad), dtype=torch.float32, device=w.device)
    w_pad[:, :d] = w
    if data.mode == "split":
        hi, lo = split_hi_lo(w_pad)
        logits = hi.to(torch.float32) @ x + lo.to(torch.float32) @ x
    elif data.mode == "bf16":
        logits = _round_bf16(w_pad) @ x
    else:
        logits = w_pad @ x
    y = data.y_row
    e = torch.exp(-logits.abs())
    nll = logits.clamp(min=0) + torch.log1p(e) - y * logits
    # f64 sum in a fixed order: the potential reaches ~2e5 at covtype scale
    nll = nll.sum(-1, dtype=torch.float64) - (n_pad - data.n) * _LOG2
    r = torch.where(logits >= 0, 1.0, e) / (1.0 + e) - y
    if data.mode == "split":
        r_hi, r_lo = split_hi_lo(r)
        grad = r_hi.to(torch.float32) @ x.T + r_lo.to(torch.float32) @ x.T
    elif data.mode == "bf16":
        grad = _round_bf16(r) @ x.T
    else:
        grad = r @ x.T
    return (-nll).to(torch.float32), -grad[:, :d]


def _kernel_value_and_grad(w, data):
    """Launch the CUDA kernel for ``data.mode`` on ``w``'s current stream."""
    x_t, y_row = data.x_t, data.y_row
    if w.dtype != torch.float32 or w.dim() != 2 or not w.is_contiguous():
        raise ValueError("w must be a contiguous (B, D) float32 tensor")
    if x_t.device != w.device:
        raise ValueError(f"w is on {w.device} but the GLM data on {x_t.device}")
    if not (x_t.is_contiguous() and y_row.is_contiguous()):
        raise ValueError("GLM data tensors must be contiguous")
    b, d = w.shape
    d_pad, n_pad = x_t.shape
    if d != data.d or d_pad > MAX_D_PAD:
        raise ValueError(
            f"w has {d} columns; the data has {data.d} (D_pad {d_pad} <= {MAX_D_PAD})"
        )
    want = torch.float32 if data.mode == "f32" else torch.bfloat16
    if x_t.dtype != want:
        raise ValueError(f"{data.mode} mode needs {want} x_t, got {x_t.dtype}")
    lib = _kernel_library()
    dev = w.device
    with torch.cuda.device(dev):
        plan, plan_ints = _plan_for_kernel(
            data.mode, b, d_pad, n_pad, _sm_count(torch.cuda.current_device())
        )
        tmap = _tensor_map(lib, data, d_pad, n_pad)
        pe_shape, g_shape = plan.scratch_shapes(b, d_pad)
        pe_part = torch.empty(pe_shape, dtype=torch.float32, device=dev)
        g_part = torch.empty(g_shape, dtype=torch.float32, device=dev)
        ll = torch.empty((b,), dtype=torch.float32, device=dev)
        grad = torch.empty((b, d), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        common = (y_row.data_ptr(), n_pad, data.n, plan_ints, pe_part.data_ptr(),
                  g_part.data_ptr(), ll.data_ptr(), grad.data_ptr(), stream)
        if data.mode == "split":
            name = "glm_split"
            err = lib.glm_split_launch(w.data_ptr(), b, d, d_pad, tmap, *common)
        else:
            name = "glm_fused_" + data.mode
            err = lib.glm_fused_launch(
                w.data_ptr(), b, d, d_pad, tmap, int(data.mode == "bf16"), *common
            )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    launch_counts[name] += 1
    return ll, grad


def glm_value_and_grad(w, data):
    """(B, D) chains -> (loglik (B,), grad (B, D)): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if w.device.type == "cuda":
        return _kernel_value_and_grad(w, data)
    if w.device.type == "cpu":
        if data.device.type != "cpu":
            raise ValueError(f"w is on the CPU but the GLM data on {data.device}")
        return plain_value_and_grad(w, data)
    raise NotImplementedError(f"no GLM kernel for device {w.device}")


def sum_data_shards(ll, grad, data):
    """The whole data set's ``(loglik, grad)`` from this rank's partials:
    one ``all_reduce`` of both over ``data``'s data group (nothing without
    one)."""
    if data.group is None:
        return ll, grad
    both = torch.cat([ll[:, None], grad], 1)
    all_reduce(both, data.group, over_data=True)
    return both[:, 0], both[:, 1:]


_NO_SECOND_DERIVATIVE = (
    "bernoulli_logits_loglik has no forward-mode derivative and no second derivative "
    "(nor has the JAX package's custom_vjp op), so forward mode and Hessians (jacfwd or "
    "jacrev over the gradient, AutoLaplaceApproximation, AutoDAIS) cannot pass through it"
)


class _GLMLoglik(torch.autograd.Function):
    """(loglik, grad) with grad saved for backward; ``vmap`` batches chains
    into one evaluation.  ``value_and_grad`` computes both for ``(B, D)``
    rows of ``w``.

    The saved gradient is a differentiable output, so that a derivative of
    the backward (reverse over reverse: ``jacrev(grad)``, ``create_graph``)
    reaches this function's backward with a cotangent on it and raises,
    where marking it non-differentiable would give a silent zero Hessian."""

    @staticmethod
    def forward(w, data, value_and_grad):
        flat = w.reshape(-1, w.shape[-1]).contiguous()
        ll, g = sum_data_shards(*value_and_grad(flat, data), data)
        return ll.reshape(w.shape[:-1]), g.reshape(w.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, ct, ct_grad):
        if ct_grad is not None:
            raise NotImplementedError(_NO_SECOND_DERIVATIVE)
        (g,) = ctx.saved_tensors
        return ct[..., None] * g, None, None

    @staticmethod
    def jvp(ctx, w_tangent, _data_tangent, _vg_tangent):
        raise NotImplementedError(_NO_SECOND_DERIVATIVE)

    @staticmethod
    def vmap(info, in_dims, w, data, value_and_grad):
        if in_dims[0] is None:
            w = w.expand(info.batch_size, *w.shape)
        else:
            w = w.movedim(in_dims[0], 0)
        return _GLMLoglik.apply(w, data, value_and_grad), (0, 0)


def _loglik(w, data, value_and_grad):
    """The op on ``w``.  A ``ProvenanceTensor`` ``w`` (a provenance pass:
    model inspection, ``TraceGraph_ELBO``) reaches the kernel as its plain
    tensor, and the result carries ``w``'s names: ``autograd.Function``
    does not pass a tensor subclass through."""
    names = get_provenance(w)
    if names:
        return ProvenanceTensor(_loglik(w._t, data, value_and_grad), names)
    # the kernels and the plain version compute in float32: a float64 ``w``
    # (under ``enable_x64``) is cast here, as the JAX op casts it into its
    # float32 padding, and the log-likelihood comes out in float32
    return _GLMLoglik.apply(w.to(torch.float32), data, value_and_grad)[0]


def bernoulli_logits_loglik(w, data):
    """Σ_n log Bernoulli(y_n | logits = x_n · w), fused with its gradient.

    Differentiable in ``w`` only; ``data`` must come from
    :func:`prepare_glm_data`.  Use inside a model as
    ``numpyro_tpu_torch.factor("lik", bernoulli_logits_loglik(w, data))``.
    """
    return _loglik(w, data, glm_value_and_grad)


def plain_bernoulli_logits_loglik(w, data):
    """:func:`bernoulli_logits_loglik` through :func:`plain_value_and_grad`
    on any device: the reference against which a model's gradients through
    the kernel are checked on the card.  Never on a model's path."""
    return _loglik(w, data, plain_value_and_grad)
