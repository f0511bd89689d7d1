// Fused Bernoulli-logits GLM log-likelihood and gradient for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of numpyro_tpu/ops/glm.py:
//   glm_split_launch  <- _pallas_split (glm.py:144, pallas_call at :264):
//                        bf16 X, f32 w carried as a bf16 hi+lo pair, the
//                        residual split hi+lo by round-to-nearest-even.
//   glm_fused_launch  <- _pallas_fused (glm.py:299, pallas_call at :370):
//                        f32 X with exact-f32 products (no TF32 anywhere), or
//                        bf16 X with bf16 w and bf16 residual.
// Both compute, for every chain c in one pass over the tiles of X^T:
//   l[c, n]  = sum_k w[c, k] x[k, n]
//   nll[c]   = sum_n max(l, 0) + log1p(exp(-|l|)) - y l      (one shared exp)
//   r[c, n]  = sigmoid(l) - y
//   g[c, k]  = sum_n r[c, n] x[k, n]
// and return loglik = -(nll - (n_pad - n) log 2) and grad = -g.
//
// What bounds it on an H100: at 256 chains and the covtype shape (D_pad 56,
// N_pad 589,824) one call is 8 C D_pad N_pad ~ 68 GFLOP in split mode (hi and
// lo products each way) against 66 MB of bf16 X, i.e. ~1000 FLOP per byte:
// compute, not memory, bounds it.  This first version runs the products as
// f32 FMAs on the CUDA cores (67 TFLOP/s peak, so >= ~1 ms per call); bf16
// products of bf16 operands are exact in f32, so the function is the TPU
// kernel's and a later tensor-core (mma.sync / wgmma) version can replace the
// inner loops without changing results beyond summation order.
//
// Design (simple, deterministic):
// - Grid = (N chunks of 4096 columns) x (tiles of 32 chains); 256 threads.
//   A block loops over its chunk in 64-column sub-tiles: X^T sub-tile and
//   y staged in shared memory as f32, logits in registers (8 chains x 1
//   column per thread), the residual sub-tile in shared memory, then the
//   gradient contraction (1 chain x D_pad/8 columns of X per thread).
// - Float4 shared loads with a row stride of 68 floats keep both the forward
//   (column-contiguous) and backward (row-strided) reads free of bank
//   conflicts.
// - No large f32 sum in the kernel (glm.py:212-221): a block's potential
//   partial covers 4096 terms (magnitude ~1e3); the partials of all chunks go
//   to scratch and a second kernel adds them in f64 in a fixed order.  No
//   float atomics, so two runs give the same bits.
// - Chains past B are masked (zero w, no writes); padded columns of X^T are
//   zero, contribute log 2 each to nll and nothing to the gradient, and the
//   log 2 is taken back out in the reduction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;                 // columns per sub-tile
constexpr int kTileC = 32;                 // chains per block
constexpr int kChunkN = 4096;              // columns per block
constexpr int kStride = kTileN + 4;        // shared row stride (floats)
constexpr int kGroups = kThreads / kTileN; // forward chain groups
constexpr int kChainsPerThread = kTileC / kGroups;  // 8
constexpr int kMaxDPad = 256;

enum Mode { kF32 = 0, kBF16 = 1, kSplit = 2 };

// Round-to-nearest-even to bf16 on the f32 bits, returned as the f32 value
// (the same rounding as glm.py:232-238 and as lax.reduce_precision).
__device__ __forceinline__ float bf16_rne(float v) {
  uint32_t b = __float_as_uint(v);
  b = (b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(b);
}

__device__ __forceinline__ float load_x(const float* x, size_t i) { return x[i]; }
__device__ __forceinline__ float load_x(const uint16_t* x, size_t i) {
  return __uint_as_float(static_cast<uint32_t>(x[i]) << 16);
}

__host__ __device__ constexpr size_t smem_floats(int d_pad) {
  return static_cast<size_t>(d_pad) * kStride  // X^T sub-tile
         + 2 * kTileC * d_pad                  // w hi, w lo
         + 2 * kTileC * kStride                // residual hi, lo
         + kTileN                              // y
         + kThreads;                           // potential reduction
}

template <typename XT, int MODE, int MAXJ>
__global__ void __launch_bounds__(kThreads)
glm_partials_kernel(const float* __restrict__ w, int b, int d, int d_pad,
                    const XT* __restrict__ x, const float* __restrict__ y,
                    int n_pad, float* __restrict__ pe_part,
                    float* __restrict__ g_part) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws_hi = xs + d_pad * kStride;
  float* ws_lo = ws_hi + kTileC * d_pad;
  float* rs_hi = ws_lo + kTileC * d_pad;
  float* rs_lo = rs_hi + kTileC * kStride;
  float* ys = rs_lo + kTileC * kStride;
  float* red = ys + kTileN;

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int c0 = blockIdx.y * kTileC;

  for (int i = tid; i < kTileC * d_pad; i += kThreads) {
    const int c = i / d_pad, k = i % d_pad;
    const float v = (c0 + c < b && k < d) ? w[static_cast<size_t>(c0 + c) * d + k] : 0.f;
    if (MODE == kF32) {
      ws_hi[i] = v;
    } else {
      const float hi = bf16_rne(v);
      ws_hi[i] = hi;
      if (MODE == kSplit) ws_lo[i] = bf16_rne(v - hi);
    }
  }

  // forward mapping: one column, 8 chains; backward: one chain, D_pad/8 rows
  const int fn = tid % kTileN;
  const int fc0 = (tid / kTileN) * kChainsPerThread;
  const int bc = tid >> 3;
  const int bd0 = tid & 7;
  const int nj = d_pad >> 3;

  float pe_acc[kChainsPerThread];
  float g_acc[MAXJ];
#pragma unroll
  for (int j = 0; j < kChainsPerThread; ++j) pe_acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) g_acc[j] = 0.f;

  for (int s = 0; s < kChunkN; s += kTileN) {
    const size_t n0 = static_cast<size_t>(chunk) * kChunkN + s;
    __syncthreads();  // the previous sub-tile's contraction is done with xs/rs
    for (int i = tid; i < d_pad * kTileN; i += kThreads) {
      const int k = i / kTileN, n = i % kTileN;
      xs[k * kStride + n] = load_x(x, static_cast<size_t>(k) * n_pad + n0 + n);
    }
    if (tid < kTileN) ys[tid] = y[n0 + tid];
    __syncthreads();

    float acc[kChainsPerThread];
#pragma unroll
    for (int j = 0; j < kChainsPerThread; ++j) acc[j] = 0.f;
    for (int k = 0; k < d_pad; k += 4) {
      const float x0 = xs[(k + 0) * kStride + fn];
      const float x1 = xs[(k + 1) * kStride + fn];
      const float x2 = xs[(k + 2) * kStride + fn];
      const float x3 = xs[(k + 3) * kStride + fn];
#pragma unroll
      for (int j = 0; j < kChainsPerThread; ++j) {
        const float4 wh = *reinterpret_cast<const float4*>(ws_hi + (fc0 + j) * d_pad + k);
        acc[j] = fmaf(wh.x, x0, acc[j]);
        acc[j] = fmaf(wh.y, x1, acc[j]);
        acc[j] = fmaf(wh.z, x2, acc[j]);
        acc[j] = fmaf(wh.w, x3, acc[j]);
        if (MODE == kSplit) {
          const float4 wl = *reinterpret_cast<const float4*>(ws_lo + (fc0 + j) * d_pad + k);
          acc[j] = fmaf(wl.x, x0, acc[j]);
          acc[j] = fmaf(wl.y, x1, acc[j]);
          acc[j] = fmaf(wl.z, x2, acc[j]);
          acc[j] = fmaf(wl.w, x3, acc[j]);
        }
      }
    }

    const float yv = ys[fn];
#pragma unroll
    for (int j = 0; j < kChainsPerThread; ++j) {
      const float l = acc[j];
      const float e = expf(-fabsf(l));
      pe_acc[j] += fmaxf(l, 0.f) + log1pf(e) - yv * l;
      const float r = (l >= 0.f ? 1.f : e) / (1.f + e) - yv;
      const int at = (fc0 + j) * kStride + fn;
      if (MODE == kF32) {
        rs_hi[at] = r;
      } else {
        const float hi = bf16_rne(r);
        rs_hi[at] = hi;
        if (MODE == kSplit) rs_lo[at] = bf16_rne(r - hi);
      }
    }
    __syncthreads();

    for (int n = 0; n < kTileN; n += 4) {
      const float4 rh = *reinterpret_cast<const float4*>(rs_hi + bc * kStride + n);
      float4 rl = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MODE == kSplit) rl = *reinterpret_cast<const float4*>(rs_lo + bc * kStride + n);
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nj) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + (bd0 + 8 * j) * kStride + n);
          g_acc[j] = fmaf(rh.x, xv.x, g_acc[j]);
          g_acc[j] = fmaf(rh.y, xv.y, g_acc[j]);
          g_acc[j] = fmaf(rh.z, xv.z, g_acc[j]);
          g_acc[j] = fmaf(rh.w, xv.w, g_acc[j]);
          if (MODE == kSplit) {
            g_acc[j] = fmaf(rl.x, xv.x, g_acc[j]);
            g_acc[j] = fmaf(rl.y, xv.y, g_acc[j]);
            g_acc[j] = fmaf(rl.z, xv.z, g_acc[j]);
            g_acc[j] = fmaf(rl.w, xv.w, g_acc[j]);
          }
        }
      }
    }
  }

  // potential partials: reduce the 64 columns of each chain group in a fixed
  // order (butterfly within a warp, then the group's two warps)
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < kChainsPerThread; ++j) {
    float v = pe_acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * kChainsPerThread + j] = v;
  }
  __syncthreads();
  if (tid < kTileC && c0 + tid < b) {
    const int grp = tid / kChainsPerThread, j = tid % kChainsPerThread;
    const int w0 = grp * (kTileN / 32);
    pe_part[static_cast<size_t>(chunk) * b + c0 + tid] =
        red[w0 * kChainsPerThread + j] + red[(w0 + 1) * kChainsPerThread + j];
  }
  if (c0 + bc < b) {
    float* out = g_part + (static_cast<size_t>(chunk) * b + c0 + bc) * d_pad;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) out[bd0 + 8 * j] = g_acc[j];
  }
}

// Second pass: one block per chain adds the chunk partials in f64, in chunk
// order, removes the padded columns' log 2 and flips the signs.
__global__ void glm_reduce_kernel(const float* __restrict__ pe_part,
                                  const float* __restrict__ g_part, int n_chunks,
                                  int b, int d, int d_pad, double pad_nll,
                                  float* __restrict__ ll, float* __restrict__ grad) {
  const int c = blockIdx.x;
  for (int k = threadIdx.x; k <= d; k += blockDim.x) {
    double s = 0.0;
    if (k < d) {
      for (int ch = 0; ch < n_chunks; ++ch)
        s += g_part[(static_cast<size_t>(ch) * b + c) * d_pad + k];
      grad[static_cast<size_t>(c) * d + k] = static_cast<float>(-s);
    } else {
      for (int ch = 0; ch < n_chunks; ++ch) s += pe_part[static_cast<size_t>(ch) * b + c];
      ll[c] = static_cast<float>(pad_nll - s);
    }
  }
}

template <typename XT, int MODE, int MAXJ>
cudaError_t launch_partials(dim3 grid, size_t smem, cudaStream_t stream, const float* w,
                            int b, int d, int d_pad, const XT* x, const float* y,
                            int n_pad, float* pe_part, float* g_part) {
  auto kernel = glm_partials_kernel<XT, MODE, MAXJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(w, b, d, d_pad, x, y, n_pad, pe_part, g_part);
  return cudaGetLastError();
}

template <typename XT, int MODE>
int launch(const float* w, int b, int d, int d_pad, const XT* x, const float* y, int n_pad,
           int n, float* pe_part, float* g_part, float* ll, float* grad, void* stream_ptr) {
  if (b <= 0 || d <= 0 || d > d_pad || d_pad % 8 != 0 || d_pad > kMaxDPad ||
      n_pad <= 0 || n_pad % kChunkN != 0 || n > n_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_chunks = n_pad / kChunkN;
  const dim3 grid(n_chunks, (b + kTileC - 1) / kTileC);
  const size_t smem = smem_floats(d_pad) * sizeof(float);
  cudaError_t err = d_pad <= 64
      ? launch_partials<XT, MODE, 8>(grid, smem, stream, w, b, d, d_pad, x, y, n_pad, pe_part, g_part)
      : launch_partials<XT, MODE, kMaxDPad / 8>(grid, smem, stream, w, b, d, d_pad, x, y, n_pad, pe_part, g_part);
  if (err != cudaSuccess) return static_cast<int>(err);
  const double pad_nll = static_cast<double>(n_pad - n) * 0.69314718055994530942;
  glm_reduce_kernel<<<b, 64, 0, stream>>>(pe_part, g_part, n_chunks, b, d, d_pad, pad_nll, ll, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch: pe_part (n_pad/4096, b) f32, g_part (n_pad/4096, b, d_pad) f32.
// Outputs: ll (b,) f32, grad (b, d) f32.  Returns a cudaError_t.
int glm_split_launch(const float* w, int b, int d, int d_pad, const uint16_t* x_bf16,
                     const float* y, int n_pad, int n, float* pe_part, float* g_part,
                     float* ll, float* grad, void* stream) {
  return launch<uint16_t, kSplit>(w, b, d, d_pad, x_bf16, y, n_pad, n, pe_part, g_part, ll,
                                  grad, stream);
}

int glm_fused_launch(const float* w, int b, int d, int d_pad, const void* x, int x_is_bf16,
                     const float* y, int n_pad, int n, float* pe_part, float* g_part,
                     float* ll, float* grad, void* stream) {
  if (x_is_bf16)
    return launch<uint16_t, kBF16>(w, b, d, d_pad, static_cast<const uint16_t*>(x), y, n_pad,
                                   n, pe_part, g_part, ll, grad, stream);
  return launch<float, kF32>(w, b, d, d_pad, static_cast<const float*>(x), y, n_pad, n,
                             pe_part, g_part, ll, grad, stream);
}

int glm_chunk_columns() { return kChunkN; }

}  // extern "C"
