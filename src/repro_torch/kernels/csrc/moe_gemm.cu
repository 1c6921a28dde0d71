// Token-sorted grouped expert GEMM (the grouped MoE path) for Hopper
// (sm_90a): forward, input gradient and weight gradient.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/moe_gemm.py:
//   * moe_gemm        <- _moe_gemm_kernel (:23, pallas_call :75); with the
//                        weight read transposed (trans_w = 1) it is also
//                        the input gradient dx = dy @ w[e]^T
//   * moe_gemm_wgrad  <- the weight gradient dw[e] = x[rows of e]^T @
//                        dy[rows of e], which the JAX package takes from
//                        autodiff of its reference and the port's autograd
//                        needs as a kernel of its own
//
// What it computes.  x [N,Kin] is sorted by expert; the int32 offsets
// [E+1] (offsets[0] = 0, offsets[e+1] = offsets[e] + group_sizes[e]) give
// expert e the rows [offsets[e], offsets[e+1]).  moe_gemm writes
//   out[i, :] = x[i, :] @ W_e     (W_e = w[e] [K,M], or w[e]^T)
// summed in f32 and rounded to the inputs' dtype; rows that no expert
// covers (i >= offsets[E]) are written as 0, as the TPU kernel leaves
// them.  moe_gemm_wgrad writes dw [E,K,M], zeros for an expert with no
// rows.  The block reads the offsets from device memory itself: the
// counterpart of the TPU kernel's scalar prefetch (moe_gemm.py:60-66).
//
// Layout.  x [N,Kin], out [N,Mout], dy [N,M], w and dw [E,K,M]; all
// contiguous, f32 or bf16 (one dtype for all of a call).  The dgrad reads
// w[e] transposed through its strides: no transposed copy is made.
//
// Bound.  One call does 2 * N * K * M flops and moves x, w and out once.
// At the training shape (N = 24576 token-expert pairs, K = 2048,
// M = 1408, E = 64) that is 141.7 GFLOP against ~1.1 GB in f32: the
// operations bound it (2.1 ms at the 67 TFLOP/s FP32 peak); in bf16 the
// bytes do (0.16 ms at 3.35 TB/s against 0.14 ms at the bf16 tensor-core
// peak).
// Design.  Simple and right first: CUDA cores, f32 everywhere, no TF32
// (the f32 tolerance against the plain version is 1e-4).  A block of
// 256 threads owns one 128 x 128 output tile and stages 8-deep slices of
// both operands in shared memory as f32 (bf16 is widened on the way in);
// each thread keeps an 8 x 8 f32 accumulator in registers, split in two
// 4-wide halves 64 apart so that a warp's float4 reads of a staged slice
// hit distinct banks.  moe_gemm: one block per (row tile, column tile);
// the block finds by binary search the first expert whose rows reach its
// tile and walks only the experts that overlap it, loading rows outside
// the current expert's range as 0 (about (row tiles + E) x column tiles
// tile products, as on the TPU, but without the TPU grid's sequential
// expert axis).  moe_gemm_wgrad: one block per (expert, K tile, M tile),
// looping over its expert's rows 8 at a time.  Tensor cores (mma.sync /
// wgmma for bf16), cp.async or TMA staging, and a persistent tile
// scheduler are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmoe_gemm.so moe_gemm.cu
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kTile = 128;             // output tile edge
constexpr int kDepth = 8;              // reduction depth staged per step
constexpr int kLd = kTile + 4;         // staged row length (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tile-local index of a thread's i-th row (or column), i in [0, 8): two
// 4-wide halves, 64 apart.
__device__ __forceinline__ int micro(int t, int i) {
  return (i < 4 ? 0 : 60) + t * 4 + i;
}

// acc[i][j] += sum_p a[p][micro(ty, i)] * b[p][micro(tx, j)]
__device__ __forceinline__ void multiply(const float (*a)[kLd],
                                         const float (*b)[kLd],
                                         float (&acc)[8][8], int ty,
                                         int tx) {
#pragma unroll
  for (int p = 0; p < kDepth; ++p) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[p][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[p][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[p][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[p][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Smallest e in [0, E] with offsets[e + 1] > row (E when none).
__device__ __forceinline__ int first_expert(const int* offsets, int experts,
                                            int row) {
  int lo = 0, hi = experts;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid + 1] > row)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// out [N,Mout] = x [N,Kin] @ W_e per expert segment.  W_e(p, q) is
// w[e][p][q] (w [E,Kin,Mout]) or, with kTransW, w[e][q][p] (w [E,Mout,Kin]);
// either way w[e] holds Kin * Mout elements.
template <typename T, bool kTransW>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ offsets, T* __restrict__ out,
                int rows, int k_in, int m_out, int experts) {
  // as[p][r] = x[r0 + r][k0 + p], bs[p][c] = W_e(k0 + p, c0 + c)
  __shared__ __align__(16) float as[kDepth][kLd];
  __shared__ __align__(16) float bs[kDepth][kLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const long long w_expert = (long long)k_in * m_out;
  for (int e = first_expert(offsets, experts, r0); e < experts; ++e) {
    const int start = offsets[e], end = offsets[e + 1];
    if (start >= r0 + kTile) break;                 // offsets ascend
    const int lo = max(start, r0), hi = min(min(end, r0 + kTile), rows);
    if (lo >= hi) continue;                         // no rows of e here
    const T* we = w + (long long)e * w_expert;
    for (int k0 = 0; k0 < k_in; k0 += kDepth) {
      __syncthreads();                              // last slice consumed
#pragma unroll
      for (int s = 0; s < kDepth * kTile / kThreads; ++s) {
        const int idx = tid + s * kThreads;
        {   // x: 8 consecutive columns of one row per 8 threads
          const int p = idx % kDepth, r = idx / kDepth;
          const int row = r0 + r, k = k0 + p;
          as[p][r] = (row >= lo && row < hi && k < k_in)
                         ? to_f32(x[(long long)row * k_in + k])
                         : 0.f;
        }
        if (kTransW) {   // W_e(p, q) = we[q * Kin + p]: walk p fastest
          const int p = idx % kDepth, c = idx / kDepth;
          const int k = k0 + p, col = c0 + c;
          bs[p][c] = (k < k_in && col < m_out)
                         ? to_f32(we[(long long)col * k_in + k])
                         : 0.f;
        } else {         // W_e(p, q) = we[p * Mout + q]: walk q fastest
          const int c = idx % kTile, p = idx / kTile;
          const int k = k0 + p, col = c0 + c;
          bs[p][c] = (k < k_in && col < m_out)
                         ? to_f32(we[(long long)k * m_out + col])
                         : 0.f;
        }
      }
      __syncthreads();
      multiply(as, bs, acc, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + micro(ty, i);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + micro(tx, j);
      if (col < m_out)
        out[(long long)row * m_out + col] = from_f32<T>(acc[i][j]);
    }
  }
}

// dw [E,K,M]: dw[e] = x[rows of e]^T @ dy[rows of e]; x [N,K], dy [N,M].
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_gemm_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const int* __restrict__ offsets, T* __restrict__ dw,
                      int rows, int k_dim, int m_dim) {
  // as[p][r] = x[i0 + p][k0 + r], bs[p][c] = dy[i0 + p][m0 + c]
  __shared__ __align__(16) float as[kDepth][kLd];
  __shared__ __align__(16) float bs[kDepth][kLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int e = blockIdx.z;
  const int start = max(offsets[e], 0), end = min(offsets[e + 1], rows);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int i0 = start; i0 < end; i0 += kDepth) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kDepth * kTile / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int c = idx % kTile, p = idx / kTile;
      const int row = i0 + p;
      const bool live = row < end;
      as[p][c] = (live && k0 + c < k_dim)
                     ? to_f32(x[(long long)row * k_dim + k0 + c])
                     : 0.f;
      bs[p][c] = (live && m0 + c < m_dim)
                     ? to_f32(dy[(long long)row * m_dim + m0 + c])
                     : 0.f;
    }
    __syncthreads();
    multiply(as, bs, acc, ty, tx);
  }

  T* dwe = dw + (long long)e * k_dim * m_dim;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + micro(ty, i);
    if (k >= k_dim) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + micro(tx, j);
      if (m < m_dim)
        dwe[(long long)k * m_dim + m] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_gemm(const void* x, const void* w, const int* offsets, void* out,
                int rows, int k_in, int m_out, int experts, int trans_w,
                cudaStream_t stream) {
  const dim3 grid((rows + kTile - 1) / kTile, (m_out + kTile - 1) / kTile);
  if (trans_w)
    moe_gemm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), offsets,
        static_cast<T*>(out), rows, k_in, m_out, experts);
  else
    moe_gemm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), offsets,
        static_cast<T*>(out), rows, k_in, m_out, experts);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, const int* offsets, void* dw,
                 int rows, int k_dim, int m_dim, int experts,
                 cudaStream_t stream) {
  const dim3 grid((m_dim + kTile - 1) / kTile, (k_dim + kTile - 1) / kTile,
                  experts);
  moe_gemm_wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), offsets,
      static_cast<T*>(dw), rows, k_dim, m_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// out [rows, m_out] = x [rows, k_in] @ W_e per expert segment; w is
// [E, k_in, m_out] (trans_w = 0) or [E, m_out, k_in] read transposed
// (trans_w = 1, the input gradient).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int moe_gemm(const void* x, const void* w, const void* offsets,
                        void* out, int rows, int k_in, int m_out,
                        int experts, int trans_w, int dtype, void* stream) {
  if (rows < 0 || k_in <= 0 || m_out <= 0 || experts <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gemm<float>(x, w, off, out, rows, k_in, m_out, experts,
                              trans_w, s);
  if (dtype == 1)
    return launch_gemm<__nv_bfloat16>(x, w, off, out, rows, k_in, m_out,
                                      experts, trans_w, s);
  return (int)cudaErrorInvalidValue;
}

// dw [E, k, m] = per expert x[rows of e]^T @ dy[rows of e]; x [rows, k],
// dy [rows, m].  dtype: 0 = float32, 1 = bfloat16.
extern "C" int moe_gemm_wgrad(const void* x, const void* dy,
                              const void* offsets, void* dw, int rows,
                              int k, int m, int experts, int dtype,
                              void* stream) {
  if (rows < 0 || k <= 0 || m <= 0 || experts <= 0)
    return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_wgrad<float>(x, dy, off, dw, rows, k, m, experts, s);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, dy, off, dw, rows, k, m, experts,
                                       s);
  return (int)cudaErrorInvalidValue;
}
