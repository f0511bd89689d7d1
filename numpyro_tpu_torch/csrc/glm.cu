// Fused Bernoulli-logits GLM log-likelihood and gradient for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of numpyro_tpu/ops/glm.py:
//   glm_split_launch  <- _pallas_split (glm.py:144, pallas_call at :264):
//                        bf16 X, f32 w carried as a bf16 hi+lo pair, the
//                        residual split hi+lo by round-to-nearest-even.
//   glm_fused_launch  <- _pallas_fused (glm.py:299, pallas_call at :370):
//                        bf16 X with bf16 w and bf16 residual, or f32 X with
//                        f32-accurate products (w, X and the residual each
//                        split into three bf16 pieces, six products summed;
//                        never TF32).
// Both compute, for every chain c in one pass over the tiles of X^T:
//   l[c, n]  = sum_k w[c, k] x[k, n]
//   nll[c]   = sum_n max(l, 0) + log1p(exp(-|l|)) - y l      (one shared exp)
//   r[c, n]  = sigmoid(l) - y
//   g[c, k]  = sum_n r[c, n] x[k, n]
// and return loglik = -(nll - (n_pad - n) log 2) and grad = -g.
//
// What bounds it on an H100: at 256 chains and the covtype shape (D_pad 56,
// N_pad 589,824) one product is 2 C D_pad N_pad = 16.9 GFLOP.  Split mode makes
// four (hi and lo, each way): 67.6 GFLOP, 0.068 ms at the tensor cores' 989
// TFLOP/s, against 66 MB of bf16 X (0.020 ms at 3.35 TB/s): operations bound
// it.  bf16 mode makes two (0.034 ms); f32 mode twelve bf16 products (0.205
// ms, its bound: two f32 products outside the tensor cores at 67 TFLOP/s
// would take 0.505 ms, and the kernel is faster than that).  Above all of these
// stands the epilogue: 151 million logits a call each need an exp, a log and
// a reciprocal on the special-function units (16 a clock on each of 132 SMs:
// 0.11 ms at the 1.98 GHz an H100 holds under this kernel), beside the ~15
// f32 operations around them.  That floor, not the roofline bound, is what a
// faster version can approach; timed inside the kernel with clock64, the
// epilogue takes about half of a tile's time and issuing and awaiting the
// products most of the rest.
//
// Design:
// - Both products run on the tensor cores (wgmma, bf16 operands, f32
//   accumulation), 64 chains to a warpgroup.  The forward product takes w
//   from shared memory (K-major A) and the staged X^T tile (d rows, 64
//   columns, columns contiguous) as an MN-major B.  Its f32 accumulator, the
//   logits, stays in registers through the epilogue; the residual, packed to
//   bf16 in the layout of a register A operand, feeds the backward product,
//   for which the SAME shared-memory tile is a K-major B.  Neither logits nor
//   residual touch shared or device memory (the two products of an attention
//   kernel, S = Q K^T kept in registers, then P V).  hi and lo pieces are
//   further wgmma into the same accumulators.
// - X^T is read from device memory once for up to 256 chains: a block holds
//   two consumer warpgroups, each with one or two 64-chain groups, and all of
//   them work on the tile one producer thread brought in by TMA (128-byte
//   swizzle, rows past D_pad filled with zeros by the hardware) into a ring of
//   stages guarded by full/empty mbarriers; y travels with its tile.  Loads
//   run ahead of compute by the depth of the ring.
// - Persistent blocks: about one per SM, each walking a fixed contiguous range
//   of column tiles, so there is no tail wave.  With at most 64 chains the two
//   warpgroups take alternate tiles instead of idling one of them.
// - f32 mode: the f32 tile is brought in by TMA one 64-row block at a time and
//   split by the consumers into three bf16 tiles (hi, mid, lo by
//   round-to-nearest-even on the bits) in the swizzled layout; w and the
//   residual are split the same way and the six products that matter (hi hi,
//   hi mid, mid hi, hi lo, lo hi, mid mid) are summed, smallest first.
// - No large f32 sum (glm.py:212-221): every accumulator run ends after 128
//   tiles (8,192 columns), its partial goes to a scratch slot keyed by (block,
//   warpgroup, segment), and a second kernel adds the slots in f64 in a fixed
//   order.  No float atomics: two calls give the same bits.
// - Chains past B are masked (zero w, no writes, whole empty groups skipped);
//   padded columns of X^T are zero, contribute log 2 each to nll and nothing
//   to the gradient, and the log 2 is taken back out in the reduction.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTileN = 64;        // columns per staged tile (128 B of bf16)
constexpr int kGroup = 64;        // chains per wgmma (its M)
constexpr int kDBlock = 64;       // rows of X^T per d-block
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSegTiles = 128;    // tiles per accumulator run (8,192 columns)
constexpr int kMaxDPad = 256;
constexpr int kBlockBytes = kDBlock * kTileN * 2;   // one bf16 d-block: 8 KiB
constexpr int kYBytes = kTileN * 4;
constexpr int kF32SlotBytes = kDBlock * kTileN * 4; // one staged f32 d-block
constexpr int kMaxSmem = 232448;

enum Mode { kF32 = 0, kBF16 = 1, kSplit = 2 };

__host__ __device__ constexpr int parts_of(int mode) {
  return mode == kF32 ? 3 : (mode == kSplit ? 2 : 1);
}

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// waits until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumer_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving uses of an accumulator across a wgmma wait,
// and from reusing the registers of an A operand before it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle, 8-row groups 1024 bytes
// apart (both the K-major and the MN-major reading of a tile whose rows are
// 128 bytes long).  The leading offset is unused at these shapes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define GLM_ACC8(o)                                                                          \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define GLM_ACC_REGS                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_fwd(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GLM_ACC_REGS
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : GLM_ACC8(0), GLM_ACC8(8), GLM_ACC8(16), GLM_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) (+)= A (64 x 16, registers) B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_bwd(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GLM_ACC_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : GLM_ACC8(0), GLM_ACC8(8), GLM_ACC8(16), GLM_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Round-to-nearest-even to bf16 on the f32 bits, returned as the f32 value
// (the same rounding as glm.py:232-238 and as lax.reduce_precision).
__device__ __forceinline__ float bf16_rne(float v) {
  uint32_t b = __float_as_uint(v);
  b = (b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(b);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Rounds v0 and v1 to bf16 (to nearest even, as bf16_rne does), returns the
// pair packed with v0 in the low half, and leaves in v0 and v1 what the
// rounding left over: called again, it yields the next piece.
__device__ __forceinline__ uint32_t split_pair(float& v0, float& v1) {
  uint32_t packed;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(packed) : "f"(v1), "f"(v0));
  v0 -= __uint_as_float(packed << 16);
  v1 -= __uint_as_float(packed & 0xFFFF0000u);
  return packed;
}

// byte offset of element (row, k) in a 64-row x 64-element bf16 block with
// 128-byte rows and the 128-byte swizzle (16-byte chunk index XOR row mod 8)
__device__ __forceinline__ int swizzled(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

// ------------------------------------------------------------------ the kernel
//
// Shared memory, from a 1024-aligned base:
//   w tiles    [groups][PARTS][DB] x 8 KiB   (K-major, swizzled)
//   bf16 modes: ring of [stages] x (DB x 8 KiB X tile), then [stages] x 256 B y
//   f32 mode:   bf16 tiles [3][DB] x 8 KiB, then a ring of [stages] x 16 KiB
//               f32 d-blocks, then [stages] x 256 B y
//   full[stages], empty[stages] mbarriers

template <int MODE, int DB, int H>
__global__ void __launch_bounds__(kThreads, 1)
glm_partials_kernel(const __grid_constant__ CUtensorMap tmap, const float* __restrict__ w,
                    const float* __restrict__ y, int b, int d, int d_pad, int n_tiles,
                    int groups, int col_split, int stages, int segs,
                    float* __restrict__ pe_part, float* __restrict__ g_part) {
  constexpr int PARTS = parts_of(MODE);
  constexpr int KD = DB * kDBlock;
  constexpr int kStageX = MODE == kF32 ? kF32SlotBytes : DB * kBlockBytes;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* w_tiles = base;
  uint8_t* xb_tiles = w_tiles + groups * PARTS * DB * kBlockBytes;  // f32 mode only
  uint8_t* ring = xb_tiles + (MODE == kF32 ? 3 * DB * kBlockBytes : 0);
  uint8_t* ring_y = ring + stages * kStageX;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_y + stages * kYBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + stages);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int c0 = blockIdx.y * groups * kGroup;
  const int t0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * n_tiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * n_tiles / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // w, split into its bf16 pieces, in the layout of a K-major A operand
  for (int i = tid; i < groups * kGroup * KD; i += kThreads) {
    const int c = i / KD, k = i % KD;
    const int chain = c0 + c;
    float v = (chain < b && k < d) ? w[static_cast<size_t>(chain) * d + k] : 0.f;
    const int grp = c / kGroup, row = c % kGroup;
    const int at = (k / kDBlock) * kBlockBytes + swizzled(row, k % kDBlock);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      const float piece = bf16_rne(v);
      *reinterpret_cast<uint16_t*>(w_tiles + (grp * PARTS + p) * DB * kBlockBytes + at) =
          static_cast<uint16_t>(__float_as_uint(piece) >> 16);
      v -= piece;
    }
  }
  fence_async_smem();
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t) {
#pragma unroll 1
        for (int j = 0; j < (MODE == kF32 ? DB : 1); ++j) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, kStageX + kYBytes);
          tma_load_2d(smem_u32(ring + stage * kStageX), &tmap, full0 + 8 * stage, t * kTileN,
                      j * kDBlock);
          bulk_load(smem_u32(ring_y + stage * kYBytes), y + static_cast<size_t>(t) * kTileN,
                    kYBytes, full0 + 8 * stage);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31;
    const int quad = lane & 3;
    const int row0 = ((tid >> 5) & 3) * 16 + (lane >> 2);  // and row0 + 8

    // this warpgroup's chain groups; empty ones are skipped
    int grp_of[H];
    bool active[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      grp_of[h] = col_split ? 0 : wg * H + h;
      active[h] = grp_of[h] < groups && c0 + grp_of[h] * kGroup < b;
    }
    const int slot_base = (blockIdx.x * (col_split ? kConsumers : 1) + (col_split ? wg : 0)) * segs;

    float g_acc[H][DB][32];
    float pe[H][2];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      pe[h][0] = pe[h][1] = 0.f;
#pragma unroll
      for (int j = 0; j < DB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) g_acc[h][j][i] = 0.f;
    }

    // writes this warpgroup's partials of one segment and clears them
    auto flush = [&](int seg) {
      const size_t slot = static_cast<size_t>(slot_base + seg);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (!active[h]) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float v = pe[h][rr];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int chain = c0 + grp_of[h] * kGroup + row0 + 8 * rr;
          if (chain < b) {
            if (quad == 0) pe_part[slot * b + chain] = v;
            float* out = g_part + (slot * b + chain) * d_pad;
#pragma unroll
            for (int j = 0; j < DB; ++j)
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int col = j * kDBlock + 8 * i + 2 * quad;
                if (col < d_pad)
                  *reinterpret_cast<float2*>(out + col) =
                      make_float2(g_acc[h][j][4 * i + 2 * rr], g_acc[h][j][4 * i + 2 * rr + 1]);
              }
          }
          pe[h][rr] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < DB; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i) g_acc[h][j][i] = 0.f;
      }
    };

    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int stage = 0;
    uint32_t phase = 0;
    int seg = 0;
    for (int t = t0; t < t1; ++t) {
      if (t > t0 && (t - t0) % kSegTiles == 0) flush(seg++);
      const bool mine = !col_split || ((t - t0) & 1) == wg;
      const uint8_t* x_tile;  // bf16 tile(s) the products read
      const float* ys = nullptr;
      float yreg[MODE == kF32 ? 16 : 1];
      if constexpr (MODE == kF32) {
        // split the staged f32 d-blocks into three bf16 tiles
        if (t > t0) consumer_bar(1);  // the tile before is done with xb_tiles
#pragma unroll 1
        for (int j = 0; j < DB; ++j) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint8_t* slot = ring + stage * kStageX;
          if (j == 0) {
            const float* yv = reinterpret_cast<const float*>(ring_y + stage * kYBytes);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float2 v = *reinterpret_cast<const float2*>(yv + 8 * i + 2 * quad);
              yreg[2 * i] = v.x;
              yreg[2 * i + 1] = v.y;
            }
          }
          // consumer threads are 0..255: they come first in the block
          for (int i = tid; i < kDBlock * 8; i += 128 * kConsumers) {
            const int row = i >> 3, chunk = i & 7;
            const float4* src = reinterpret_cast<const float4*>(slot + row * 256 + chunk * 32);
            const float4 a = src[0], c = src[1];
            float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
            const int at = j * kBlockBytes + swizzled(row, chunk * 8);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              uint32_t packed[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) packed[e] = split_pair(v[2 * e], v[2 * e + 1]);
              *reinterpret_cast<uint4*>(xb_tiles + p * DB * kBlockBytes + at) =
                  make_uint4(packed[0], packed[1], packed[2], packed[3]);
            }
          }
          release(empty0 + 8 * stage);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
        fence_async_smem();
        consumer_bar(2);
        x_tile = xb_tiles;
      } else {
        mbar_wait(full0 + 8 * stage, phase);
        x_tile = ring + stage * kStageX;
        ys = reinterpret_cast<const float*>(ring_y + stage * kYBytes);
      }

      if (mine) {
        const uint32_t xa = smem_u32(x_tile);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if (!active[h]) continue;
          const uint32_t wa = smem_u32(w_tiles + grp_of[h] * PARTS * DB * kBlockBytes);
          // forward: logits of 64 chains x 64 columns.  An A k-step is 32
          // bytes along the row, a B k-step 16 rows of 128 bytes.  The
          // largest product (hi x hi) is summed in two halves of its k-steps,
          // l and l2, added after: fewer truncating accumulations in a row
          // (measured: a quarter less error on near-zero components; four
          // runs gain another tenth and cost 8% of the kernel's time).
          float l[32], l2[32];
          wgmma_fence();
          bool first = true, first2 = true;
          auto forward = [&](int wp, int xp) {
#pragma unroll
            for (int ks = 0; ks < KD / 16; ++ks) {
              const uint32_t a_at =
                  wa + (wp * DB + ks / 4) * kBlockBytes + (ks % 4) * 32;
              const uint32_t b_at = xa + xp * DB * kBlockBytes + ks * 16 * 128;
              if (wp == 0 && xp == 0 && ks >= KD / 32) {
                wgmma_fwd(l2, smem_desc(a_at), smem_desc(b_at), first2 ? 0 : 1);
                first2 = false;
                continue;
              }
              wgmma_fwd(l, smem_desc(a_at), smem_desc(b_at), first ? 0 : 1);
              first = false;
            }
          };
          if constexpr (MODE == kF32) {  // smallest products first
            forward(2, 0); forward(0, 2); forward(1, 1);
            forward(1, 0); forward(0, 1); forward(0, 0);
          } else {
            if constexpr (MODE == kSplit) forward(1, 0);
            forward(0, 0);
          }
          wgmma_commit();
          wgmma_wait0();
          fence_regs(l);
          fence_regs(l2);

          // epilogue: nll terms summed per tile, the residual left in l[].
          // Three special-function operations a logit (ex2, lg2, rcp); the
          // exact expf/log1pf/division change no output beyond 1e-7 relative
          // and cost 2.5 times the kernel's time.
          float tile_lin[2] = {0.f, 0.f}, tile_lg[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float y0, y1;
            if constexpr (MODE == kF32) {
              y0 = yreg[2 * i];
              y1 = yreg[2 * i + 1];
            } else {
              const float2 v = *reinterpret_cast<const float2*>(ys + 8 * i + 2 * quad);
              y0 = v.x;
              y1 = v.y;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float yv = (q & 1) ? y1 : y0;
              const float lv = l[4 * i + q] + l2[4 * i + q];
              const float e = ex2_approx(-1.4426950408889634f * fabsf(lv));
              const float u = 1.f + e;
              const float s = rcp_approx(u);
              tile_lin[q >> 1] += fmaf(-yv, lv, fmaxf(lv, 0.f));
              tile_lg[q >> 1] += lg2_approx(u);
              l[4 * i + q] = (lv >= 0.f ? s : e * s) - yv;
            }
          }
          pe[h][0] += fmaf(0.6931471805599453f, tile_lg[0], tile_lin[0]);
          pe[h][1] += fmaf(0.6931471805599453f, tile_lg[1], tile_lin[1]);

          // backward: g (64 chains x d) += r (registers) x tile^T.  A B
          // k-step is 32 bytes along the 128-byte row of 64 columns.  The
          // tensor cores' f32 accumulator truncates where an f32 add rounds,
          // which biases a long-running sum towards zero (measured: 1.6e-5 of
          // the largest component over 4,480 columns).  So each tile's
          // product starts from zero in `gt` and is added to the running sum
          // with a rounding f32 add.
          float gt[32];
          if constexpr (MODE == kF32) {
            // The five small products go to `gt` and hi x hi to `gt2`, so
            // that no small product is added to (and truncated at the size
            // of) a sum that already holds large ones.
            float gt2[32];
#pragma unroll
            for (int j = 0; j < DB; ++j) {
              // one k-step at a time: its 12 A registers are reused by the next
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
                uint32_t a[3][4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  float v[2] = {l[8 * ks + 2 * q], l[8 * ks + 2 * q + 1]};
#pragma unroll
                  for (int p = 0; p < 3; ++p) a[p][q] = split_pair(v[0], v[1]);
                }
                const uint32_t b_at = xa + j * kBlockBytes + ks * 32;
                wgmma_fence();
                wgmma_bwd(gt, a[2], smem_desc(b_at), ks > 0);
                wgmma_bwd(gt, a[0], smem_desc(b_at + 2 * DB * kBlockBytes), 1);
                wgmma_bwd(gt, a[1], smem_desc(b_at + DB * kBlockBytes), 1);
                wgmma_bwd(gt, a[1], smem_desc(b_at), 1);
                wgmma_bwd(gt, a[0], smem_desc(b_at + DB * kBlockBytes), 1);
                wgmma_bwd(gt2, a[0], smem_desc(b_at), ks > 0);
                wgmma_commit();
                wgmma_wait0();
                fence_regs(a[0]); fence_regs(a[1]); fence_regs(a[2]);
              }
              fence_regs(gt);
              fence_regs(gt2);
#pragma unroll
              for (int i = 0; i < 32; ++i) g_acc[h][j][i] += gt[i] + gt2[i];
            }
          } else {
            uint32_t a_hi[16], a_lo[16];
#pragma unroll
            for (int p = 0; p < 16; ++p) {
              float v0 = l[2 * p], v1 = l[2 * p + 1];
              a_hi[p] = split_pair(v0, v1);
              if constexpr (MODE == kSplit) a_lo[p] = split_pair(v0, v1);
            }
#pragma unroll
            for (int j = 0; j < DB; ++j) {
              wgmma_fence();
              if constexpr (MODE == kSplit) {  // the small pieces first
#pragma unroll
                for (int ks = 0; ks < 4; ++ks)
                  wgmma_bwd(gt, reinterpret_cast<const uint32_t(&)[4]>(a_lo[4 * ks]),
                            smem_desc(xa + j * kBlockBytes + ks * 32), ks > 0);
              }
#pragma unroll
              for (int ks = 0; ks < 4; ++ks)
                wgmma_bwd(gt, reinterpret_cast<const uint32_t(&)[4]>(a_hi[4 * ks]),
                          smem_desc(xa + j * kBlockBytes + ks * 32), MODE == kSplit || ks > 0);
              wgmma_commit();
              wgmma_wait0();
              fence_regs(gt);
#pragma unroll
              for (int i = 0; i < 32; ++i) g_acc[h][j][i] += gt[i];
            }
            fence_regs(a_hi);
            if constexpr (MODE == kSplit) fence_regs(a_lo);
          }
        }
      }
      if constexpr (MODE != kF32) {
        release(empty0 + 8 * stage);
        if (++stage == stages) { stage = 0; phase ^= 1; }
      }
    }
    flush(seg++);
    // segments this block's range did not reach hold zeros
    for (; seg < segs; ++seg) flush(seg);
  }
}

// Second pass: one block per chain adds the slots in f64, in slot order,
// removes the padded columns' log 2 and flips the signs.
__global__ void glm_reduce_kernel(const float* __restrict__ pe_part,
                                  const float* __restrict__ g_part, int n_slots, int b, int d,
                                  int d_pad, double pad_nll, float* __restrict__ ll,
                                  float* __restrict__ grad) {
  const int c = blockIdx.x;
  for (int k = threadIdx.x; k <= d; k += blockDim.x) {
    double s = 0.0;
    if (k < d) {
      for (int sl = 0; sl < n_slots; ++sl)
        s += g_part[(static_cast<size_t>(sl) * b + c) * d_pad + k];
      grad[static_cast<size_t>(c) * d + k] = static_cast<float>(-s);
    } else {
      for (int sl = 0; sl < n_slots; ++sl) s += pe_part[static_cast<size_t>(sl) * b + c];
      ll[c] = static_cast<float>(pad_nll - s);
    }
  }
}

// ------------------------------------------------------------------- the host

// The launch plan, as ops/glm.py::glm_launch_plan computes it.
struct Plan {
  int chain_tile, grid_x, grid_y, col_split, stages, segs, smem_bytes;
};

int stage_bytes(int mode, int db) {
  return (mode == kF32 ? kF32SlotBytes : db * kBlockBytes) + kYBytes;
}

bool plan_is_valid(int mode, const Plan& p, int b, int d, int d_pad, int n_pad, int n) {
  if (b <= 0 || d <= 0 || d > d_pad || d_pad % 8 != 0 || d_pad > kMaxDPad || n_pad <= 0 ||
      n_pad % kTileN != 0 || n > n_pad)
    return false;
  const int db = (d_pad + kDBlock - 1) / kDBlock;
  const int ct = p.chain_tile;
  if (ct != 64 && ct != 128 && !(ct == 256 && db == 1)) return false;
  if (p.grid_y != (b + ct - 1) / ct || p.grid_x < 1 || p.grid_x > n_pad / kTileN) return false;
  if (p.col_split != (mode != kF32 && ct == 64 ? 1 : 0)) return false;
  const int per_block = (n_pad / kTileN + p.grid_x - 1) / p.grid_x;
  if (p.segs != (per_block + kSegTiles - 1) / kSegTiles) return false;
  const int need = 1024 + (ct / kGroup) * parts_of(mode) * db * kBlockBytes +
                   (mode == kF32 ? 3 * db * kBlockBytes : 0) +
                   p.stages * (stage_bytes(mode, db) + 16);
  return p.stages >= 2 && p.smem_bytes == need && need <= kMaxSmem;
}

template <int MODE, int DB, int H>
cudaError_t launch_partials(const Plan& p, cudaStream_t stream, const CUtensorMap& tmap,
                            const float* w, const float* y, int b, int d, int d_pad, int n_pad,
                            float* pe_part, float* g_part) {
  auto kernel = glm_partials_kernel<MODE, DB, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y), kThreads, p.smem_bytes, stream>>>(
      tmap, w, y, b, d, d_pad, n_pad / kTileN, p.chain_tile / kGroup, p.col_split, p.stages,
      p.segs, pe_part, g_part);
  return cudaGetLastError();
}

template <int MODE>
int launch(const float* w, int b, int d, int d_pad, const void* tmap_bytes, const float* y,
           int n_pad, int n, const int* plan, float* pe_part, float* g_part, float* ll,
           float* grad, void* stream_ptr) {
  const Plan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  if (!plan_is_valid(MODE, p, b, d, d_pad, n_pad, n))
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap tmap;
  memcpy(&tmap, tmap_bytes, sizeof(tmap));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int db = (d_pad + kDBlock - 1) / kDBlock;
  cudaError_t err;
#define GLM_LAUNCH(DB_, H_) \
  launch_partials<MODE, DB_, H_>(p, stream, tmap, w, y, b, d, d_pad, n_pad, pe_part, g_part)
  if (p.chain_tile == 256) err = GLM_LAUNCH(1, 2);
  else if (db == 1) err = GLM_LAUNCH(1, 1);
  else if (db == 2) err = GLM_LAUNCH(2, 1);
  else if (db == 3) err = GLM_LAUNCH(3, 1);
  else err = GLM_LAUNCH(4, 1);
#undef GLM_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slots = p.grid_x * (p.col_split ? kConsumers : 1) * p.segs;
  const double pad_nll = static_cast<double>(n_pad - n) * 0.69314718055994530942;
  glm_reduce_kernel<<<b, 64, 0, stream>>>(pe_part, g_part, n_slots, b, d, d_pad, pad_nll, ll,
                                          grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch: pe_part (slots, b) f32 and g_part (slots, b, d_pad) f32, with
// slots = grid_x * (2 if col_split else 1) * segs.  `plan` is seven ints
// (chain_tile, grid_x, grid_y, col_split, stages, segs, smem_bytes) and
// `tmap` the 128 bytes glm_make_tensor_map wrote for this X^T.
// Outputs: ll (b,) f32, grad (b, d) f32.  Returns a cudaError_t.
int glm_split_launch(const float* w, int b, int d, int d_pad, const void* tmap, const float* y,
                     int n_pad, int n, const int* plan, float* pe_part, float* g_part,
                     float* ll, float* grad, void* stream) {
  return launch<kSplit>(w, b, d, d_pad, tmap, y, n_pad, n, plan, pe_part, g_part, ll, grad,
                        stream);
}

int glm_fused_launch(const float* w, int b, int d, int d_pad, const void* tmap, int x_is_bf16,
                     const float* y, int n_pad, int n, const int* plan, float* pe_part,
                     float* g_part, float* ll, float* grad, void* stream) {
  if (x_is_bf16)
    return launch<kBF16>(w, b, d, d_pad, tmap, y, n_pad, n, plan, pe_part, g_part, ll, grad,
                         stream);
  return launch<kF32>(w, b, d, d_pad, tmap, y, n_pad, n, plan, pe_part, g_part, ll, grad,
                      stream);
}

// Encodes the TMA descriptor of X^T (d_pad, n_pad) into `out` (128 bytes):
// bf16 X in boxes of box_rows x 64 columns with the 128-byte swizzle, f32 X in
// boxes of 64 x 64 without.  libcuda's encoder is fetched through the
// runtime, so the library links against the runtime alone.  Returns 0, or a
// CUDA error code.
int glm_make_tensor_map(void* out, const void* x, int x_is_bf16, int d_pad, int n_pad,
                        int box_rows) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaError_t err =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t elem = x_is_bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_pad), static_cast<cuuint64_t>(d_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n_pad) * elem};
  const cuuint32_t box[2] = {kTileN, static_cast<cuuint32_t>(x_is_bf16 ? box_rows : kDBlock)};
  const cuuint32_t ones[2] = {1, 1};
  alignas(64) CUtensorMap map;
  const CUresult res = reinterpret_cast<Encode>(fn)(
      &map, x_is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
      const_cast<void*>(x), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      x_is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 100000 + static_cast<int>(res);
  memcpy(out, &map, sizeof(map));
  return 0;
}

int glm_tile_columns() { return kTileN; }
int glm_segment_tiles() { return kSegTiles; }

}  // extern "C"
