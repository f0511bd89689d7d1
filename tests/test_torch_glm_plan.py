"""The GLM kernels' host side, checked without a GPU: the count of one call's
work against the JAX kernels' own cost estimates, the launch plan over a sweep
of shapes, and the three-way bf16 split of f32 mode against JAX.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from numpyro_tpu.ops import glm as jglm
from numpyro_tpu_torch.ops import glm

torch.set_num_threads(1)

SM_COUNT = 132  # an H100 SXM
# published peaks of one H100 SXM (dense bf16 on the tensor cores, f32
# outside them, device memory), as chip_smoke.py uses them
PEAK_FLOPS = {"split": 989e12, "bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
COVTYPE = (256, 56, 589_824)  # chains, D_pad, N_pad
JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16, "split": "split"}


def _pallas_cost(mode, b_pad=16, n=1000, d=7):
    """The CostEstimate the JAX package hands to ``pl.pallas_call``, read off
    the traced (not lowered) kernel call."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=JAX_DTYPE[mode])
    fn = jglm._pallas_split if mode == "split" else jglm._pallas_fused
    w = jnp.zeros((b_pad, jd.x_t.shape[0]), jnp.float32)
    eqns = jax.make_jaxpr(lambda w: fn(w, jd))(w).jaxpr.eqns
    (call,) = [e for e in eqns if e.primitive.name == "pallas_call"]
    return call.params["cost_estimate"], b_pad, jd.x_t.shape


@pytest.mark.parametrize("mode", ["f32", "bf16", "split"])
def test_glm_work_matches_the_pallas_cost_estimate(mode):
    cost, b, (d_pad, n_pad) = _pallas_cost(mode)
    flops, nbytes = glm.glm_work(mode, b, d_pad, n_pad)
    # the TPU's split kernel packs hi and lo into one pass and states
    # 4 b d n; the port counts the hi and the lo product each way
    assert flops == cost.flops * (2 if mode == "split" else 1)
    assert flops == (8 if mode == "split" else 4) * b * d_pad * n_pad
    # X^T's bytes as JAX states them, plus y, w and the two outputs
    assert nbytes == cost.bytes_accessed + 4 * n_pad + 4 * b * d_pad + 4 * b * (d_pad + 1)


@pytest.mark.parametrize("mode,by_ops_ms,by_bytes_ms", [
    ("split", 0.068, 0.020), ("bf16", 0.034, 0.020), ("f32", 0.205, 0.040)])
def test_glm_work_gives_the_covtype_bounds(mode, by_ops_ms, by_bytes_ms):
    flops, nbytes = glm.glm_work(mode, *COVTYPE)
    pieces = glm.glm_tensor_core_flops(mode, *COVTYPE)
    by_ops = pieces / PEAK_FLOPS["bf16"] * 1e3
    if mode == "f32":
        # two f32 products outside the tensor cores take 0.505 ms, twelve
        # products of bf16 pieces on them 0.205: the bound is the cheaper route
        assert pieces == 6 * flops
        assert flops / PEAK_FLOPS["f32"] * 1e3 == pytest.approx(0.505, abs=6e-4)
        by_ops = min(by_ops, flops / PEAK_FLOPS["f32"] * 1e3)
    else:
        assert pieces == flops
    assert by_ops == pytest.approx(by_ops_ms, abs=6e-4)
    assert nbytes / PEAK_BYTES * 1e3 == pytest.approx(by_bytes_ms, abs=6e-4)
    assert by_ops > nbytes / PEAK_BYTES * 1e3  # operations bound every mode


@pytest.mark.parametrize("mode", ["f32", "bf16", "split"])
def test_kernel_tolerances(mode):
    """One place states how closely kernel and plain version agree: the
    relative tolerances at every size, bf16 mode's atol whatever the size, the
    others' growing with sqrt(n)."""
    small, large = glm.kernel_tolerances(mode, 70_000), glm.kernel_tolerances(mode, 581_012)
    assert small[:2] == large[:2] == (1e-5, 1e-3)
    if mode == "bf16":
        assert small[2] == large[2] == 2.5e-2
    else:
        assert large[2] == pytest.approx(3.8e-3, rel=0.01)
        assert large[2] / small[2] == pytest.approx((581_012 / 70_000) ** 0.5)


def _check_plan(mode, b, d_pad, n_pad, sm_count):
    plan = glm.glm_launch_plan(mode, b, d_pad, n_pad, sm_count)
    d_blocks = -(-d_pad // 64)
    assert plan.smem_bytes <= glm.MAX_SHARED_BYTES == 232448
    assert plan.stages >= (2 if mode == "f32" else 3)
    assert plan.chain_tile in (64, 128, 256) and (plan.chain_tile < 256 or d_blocks == 1)
    # every chain in exactly one (chain tile, 64-chain group, row)
    owners = np.zeros(b, int)
    for tile in range(plan.grid_y):
        for group in range(plan.chain_tile // 64):
            lo = tile * plan.chain_tile + group * 64
            owners[lo:min(lo + 64, b)] += 1
    assert (owners == 1).all()
    assert (plan.grid_y - 1) * plan.chain_tile < b  # no empty chain tile
    # a chain tile never pads more than the smallest tile would
    assert plan.grid_y * plan.chain_tile <= -(-b // 64) * 64 + (plan.chain_tile - 64)
    # every column tile in exactly one block's range, ranges contiguous
    n_tiles = n_pad // glm.TILE_COLUMNS
    edges = [plan.tile_range(bx, n_tiles) for bx in range(plan.grid_x)]
    assert edges[0][0] == 0 and edges[-1][1] == n_tiles
    assert all(a[1] == c[0] for a, c in zip(edges, edges[1:]))
    longest = max(t1 - t0 for t0, t1 in edges)
    assert min(t1 - t0 for t0, t1 in edges) >= 1
    # no f32 sum over more than 8,192 columns: a range has room in its segments
    assert longest <= plan.segs * glm.SEGMENT_TILES
    assert (plan.segs - 1) * glm.SEGMENT_TILES < longest
    assert glm.MAX_F32_RUN_COLUMNS == 8192
    # about one block per SM
    if plan.grid_y <= sm_count:
        assert plan.grid_x * plan.grid_y <= sm_count
        assert plan.grid_x == min(sm_count // plan.grid_y, n_tiles)
    else:
        assert plan.grid_x == 1
    assert plan.col_split == int(mode != "f32" and plan.chain_tile == 64)
    pe_shape, g_shape = plan.scratch_shapes(b, d_pad)
    assert pe_shape == (plan.slots, b) and g_shape == (plan.slots, b, d_pad)
    assert plan.slots == plan.grid_x * (2 if plan.col_split else 1) * plan.segs
    return plan


@pytest.mark.parametrize("mode", ["split", "bf16", "f32"])
@pytest.mark.parametrize("b", [1, 5, 40, 64, 65, 100, 128, 129, 200, 256, 257, 300, 1024, 4096])
def test_launch_plan_covers_chains_and_columns(mode, b):
    for d_pad in (8, 56, 64, 72, 128, 136, 192, 200, 256):
        for n_pad in (32768, 589_824, 32768 * 301):
            for sm_count in (132, 108):
                _check_plan(mode, b, d_pad, n_pad, sm_count)


def test_launch_plan_at_the_covtype_shape_reads_x_once():
    for mode in ("split", "bf16", "f32"):
        plan = _check_plan(mode, *COVTYPE, SM_COUNT)
        assert (plan.chain_tile, plan.grid_x, plan.grid_y) == (256, 132, 1)
    # 40 or 100 chains do not pay for 256
    assert glm.glm_launch_plan("split", 40, 56, 589_824, SM_COUNT).chain_tile == 64
    assert glm.glm_launch_plan("split", 100, 56, 589_824, SM_COUNT).chain_tile == 128


@pytest.mark.parametrize("bad", [
    dict(b=0), dict(d_pad=7), dict(d_pad=264), dict(n_pad=100), dict(mode="f16")])
def test_launch_plan_refuses_what_the_kernel_does_not_take(bad):
    args = dict(mode="split", b=4, d_pad=56, n_pad=32768, sm_count=SM_COUNT)
    args.update(bad)
    with pytest.raises(ValueError):
        glm.glm_launch_plan(**args)


def test_plan_constants_match_the_kernel_source():
    src = (Path(glm.__file__).parent.parent / "csrc" / "glm.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kTileN"] == glm.TILE_COLUMNS
    assert const["kSegTiles"] == glm.SEGMENT_TILES
    assert const["kMaxDPad"] == glm.MAX_D_PAD
    assert const["kMaxSmem"] == glm.MAX_SHARED_BYTES
    assert const["kGroup"] == 64 and const["kDBlock"] == 64 and const["kConsumers"] == 2
    # both products are tensor-core instructions
    assert src.count("wgmma.mma_async") >= 2


def test_split_hi_mid_lo_matches_reduce_precision_bitwise():
    v = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32) * 0.5
    pieces = glm.split_hi_mid_lo(torch.from_numpy(v))
    rest = jnp.asarray(v)
    total = np.zeros_like(v, dtype=np.float64)
    for piece in pieces:
        want = jax.lax.reduce_precision(rest, exponent_bits=8, mantissa_bits=7)
        np.testing.assert_array_equal(
            piece.view(torch.int16).numpy().view(np.uint16),
            np.asarray(want.astype(jnp.bfloat16)).view(np.uint16))
        rest = rest - want
        total += piece.float().numpy()
        assert piece.float().abs().max() > 0
    # three pieces of 8 bits carry the 24-bit mantissa
    np.testing.assert_allclose(total, v, rtol=2.0**-23, atol=1e-30)


def test_six_product_version_matches_jax_plain_path():
    """The f32-mode kernel's arithmetic (six bf16-piece products each way)
    against JAX's ``_xla_fused`` in f32.  The three dropped products weigh
    <= 3 x 2^-24 of |w| . |x| per term and the sums run in another order
    (~1e-7 per sqrt(K) terms), so 1e-6 relative to the largest logit; the
    likelihood and gradient then agree as the exact-f32 plain version does."""
    rng = np.random.default_rng(1)
    n, d, c = 5000, 7, 5
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = (0.3 * rng.standard_normal((c, d))).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    jd = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype=jnp.float32)
    x_t = torch.from_numpy(np.array(jd.x_t))
    w_pad = np.zeros((8, x_t.shape[0]), np.float32)
    w_pad[:c, :d] = W
    logits_j = np.asarray(jnp.asarray(w_pad) @ jd.x_t)  # _xla_fused's first line
    logits_t = glm.six_product_matmul(torch.from_numpy(w_pad), x_t).numpy()
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-6,
                               atol=1e-6 * np.abs(logits_j).max())
    ll_j, g_j = jglm._xla_fused(jnp.asarray(w_pad), jd)
    lt = torch.from_numpy(logits_t)
    y_row = torch.from_numpy(np.asarray(jd.y_row))
    r = torch.sigmoid(lt) - y_row
    g_t = -glm.six_product_matmul(r, x_t.T.contiguous())
    nll = (torch.nn.functional.softplus(lt) - y_row * lt).sum(-1, dtype=torch.float64)
    ll_t = -(nll - (x_t.shape[1] - n) * np.log(2.0))
    np.testing.assert_allclose(ll_t.numpy()[:c], np.asarray(ll_j)[:c], rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy()[:c], np.asarray(g_j)[:c], rtol=1e-3, atol=1e-3)


def test_tensor_map_is_made_once_per_data(monkeypatch):
    """The wrapper keeps the TMA descriptor on the data object."""
    calls = []

    class Lib:
        @staticmethod
        def glm_make_tensor_map(out, ptr, is_bf16, d_pad, n_pad, box_rows):
            calls.append((ptr, is_bf16, d_pad, n_pad, box_rows))
            return 0

    X = torch.zeros((100, 70))
    data = glm.prepare_glm_data(X, torch.zeros(100), dtype="split")
    first = glm._tensor_map(Lib, data, *data.x_t.shape)
    assert glm._tensor_map(Lib, data, *data.x_t.shape) is first
    assert calls == [(data.x_t.data_ptr(), 1, 72, 32768, 128)]
