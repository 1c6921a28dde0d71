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
// rows.  Blocks read the offsets from device memory themselves (the
// counterpart of the TPU kernel's scalar prefetch, moe_gemm.py:60-66):
// the host never reads them.
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
//
// What the first design lost (f32 6.37 ms, bf16 7.27 ms at that shape,
// NVIDIA H100 80GB HBM3, 700 W): CUDA cores in both types (bf16 widened to
// f32 on its way into shared memory), synchronous scalar staging with two
// barriers per 8-deep slice and no copy in flight during the math, and
// 128-row tiles that straddled experts ran the K loop once per
// overlapping expert (~1.3x the products at the path's load).
//
// Design of moe_gemm (forward and input gradient, one entry point):
//   * expert-aligned tiles built on the device: expert e's rows are cut
//     into ceil(n_e / 128) row tiles, experts in order, then the rows past
//     offsets[E] (written as 0 without a K loop).  The grid is (column
//     tile, ceil(N / 128) + E row tiles), an upper bound from the shapes
//     alone; each block's first warp finds its tile by a warp scan of the
//     per-expert tile counts, and blocks past the list's end exit.  No
//     tile straddles two experts;
//   * bf16: 128 x 128 block tiles, 8 warps of 64 x 32 on
//     mma.sync.m16n8k16 (f32 accumulation), a 3-stage ring of 64-deep x
//     and w tiles (96 KB, two blocks per SM) filled by 16-byte cp.async
//     into XOR-swizzled shared memory, one barrier per slice.  x is read by ldmatrix; the
//     forward's w[e] [K,M] (k-major) by ldmatrix.trans, the dgrad's
//     w[e]^T, whose rows are already along the reduction, by ldmatrix;
//   * f32 (the training path's type; no TF32, its tolerance is 1e-4):
//     CUDA cores, 8 x 8 outputs per thread, a 3-stage ring of 16-deep
//     slices filled by 16-byte cp.async, one barrier per slice.  x rows
//     are staged as they lie (rows along k) and read four k at a time;
//     the forward's w slice k-major, read along the columns; the dgrad's
//     w[e]^T as rows along k (the transposed layout of the forward's),
//     each thread owning columns 16 apart so that a quarter-warp's float4
//     reads hit distinct banks.  Every global read is a coalesced 16-byte
//     copy;
//   * a row whose byte length is not a multiple of 16 (or a pointer off a
//     16-byte boundary) takes the guarded element loader instead of
//     cp.async, chosen per call (kVec); empty experts get no tile; tiles
//     and slices past N, K or M read zeros and write nothing.
// Design of moe_gemm_wgrad (dw[e] = x[rows of e]^T @ dy[rows of e]):
//   * grid (M tile, K tile, expert) of 128 x 128 dw tiles, from shapes
//     alone; each block reads its expert's offsets and reduces over the
//     expert's rows, so no tile straddles experts.  An expert with no rows
//     writes its zero tile with no reduction loop;
//   * bf16: 8 warps of 64 x 32 on mma.sync.m16n8k16 (f32 accumulation)
//     over 64-row slices through a 3-stage ring (96 KB, two blocks per SM)
//     filled by 16-byte cp.async into XOR-swizzled shared memory, one
//     barrier per slice.  Both operands lie with the reduction along rows
//     (an x slice [64 rows x 128 k], a dy slice [64 rows x 128 m]), so both
//     are read by ldmatrix.trans: A = x^T, B = dy as the forward reads
//     w[e] [K,M].  The dw tile is rounded to bf16 through shared memory
//     (the drained ring) and stored in coalesced 16-byte rows: at the
//     training shape the write of dw (64 x 2048 x 1408 bf16, 369 MB of the
//     539 MB a call moves) is the bound.  No fold: the skewed check (one
//     expert 90% of 24576 rows) holds 2e-2 with one f32 sum per output;
//   * short reductions: at phase 7's load an expert averages 384 rows, 6
//     slices, so the ring's prologue and the 32 KB epilogue weigh as much
//     as the loop; two blocks per SM let one's epilogue overlap the
//     other's loop.  Measured (chip_smoke.py phase 8, NVIDIA H100 80GB
//     HBM3, 700 W): 0.4892 ms at layer 0's load against 0.6337 ms at the
//     skewed load, where one expert's 176 tiles (each 346 slices) carry
//     90% of the products on 132 SMs and the other tiles finish early;
//   * f32 (phase 7's type) keeps the first design: one block per tile on
//     CUDA cores, 8-deep synchronous slices, its row sum folded every 128
//     rows into a per-thread column of shared memory (one running f32 sum
//     over an expert holding 90% of 24576 rows missed the 1e-4 check);
//   * rows that are not 16-byte multiples (bf16 rows of 72 or 260 bytes)
//     take the guarded element loader and element stores, chosen per
//     call as the forward does (kVec).
//
// Times (chip_smoke.py phase 8, NVIDIA H100 80GB HBM3 at 700 W, median of
// 20, L2 flushed): at the training shape and the router's load, f32
// 4.12 ms forward and 4.02 ms dgrad (the first design: 6.31 / 5.77;
// torch._grouped_mm 4.12 / 4.41), bf16 0.51 / 0.52 ms (7.28 / 6.06;
// torch._grouped_mm 0.31 / 0.30).  The weight gradient: f32 4.04 ms
// (torch._grouped_mm 4.18), bf16 0.49 ms (the first design: 4.43;
// torch._grouped_mm 0.34).
//
// ptxas (-Xptxas -v, sm_90a): moe_gemm_bf16_kernel 128 registers (bounded
// for two blocks per SM), 96 KB of dynamic shared memory, no spills but 8
// bytes in the forward's guarded-loader instance; moe_gemm_f32_kernel 167
// registers (forward) and 244 / 252 (dgrad, guarded / cp.async), 60 KB of
// dynamic shared memory, no spills; moe_gemm_wgrad_kernel (f32) 127
// registers, 8.4 KB static and 64 KB dynamic shared memory, no spills;
// moe_gemm_wgrad_bf16_kernel 128 registers, 96 KB of dynamic shared
// memory, no spills (32 bytes in the guarded-loader instance).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmoe_gemm.so moe_gemm.cu
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using tiles::bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// the expert-aligned tile schedule
// ---------------------------------------------------------------------------

constexpr int kBM = 128;               // rows per tile (both routes)

struct Tile {
  int row0, rows, expert;              // expert == experts: rows past the
};                                     // groups; -1: past the list's end

// Start of group g's rows: groups 0..E-1 are the experts, group E the
// rows past offsets[E]; offsets are clamped into [0, rows].
__device__ __forceinline__ int group_start(const int* __restrict__ offsets,
                                           int experts, int rows, int g) {
  if (g <= 0) return 0;
  if (g > experts) return rows;
  return min(max(__ldg(offsets + g), 0), rows);
}

// Row tile `tile` of the schedule, found by the block's first warp (each
// lane sums the tile counts of a run of groups, a warp scan places the
// runs) and broadcast through shared memory.
__device__ Tile find_tile(const int* __restrict__ offsets, int experts,
                          int rows, int tile) {
  __shared__ int found[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int groups = experts + 1;
    const int seg = (groups + 31) / 32;
    const int lo = min(lane * seg, groups), hi = min(lo + seg, groups);
    int count = 0;
    for (int g = lo; g < hi; ++g) {
      const int n = max(group_start(offsets, experts, rows, g + 1) -
                            group_start(offsets, experts, rows, g),
                        0);
      count += (n + kBM - 1) / kBM;
    }
    int incl = count;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = incl - count;
    if (tile >= base && tile < incl) {
      for (int g = lo; g < hi; ++g) {
        const int start = group_start(offsets, experts, rows, g);
        const int n =
            max(group_start(offsets, experts, rows, g + 1) - start, 0);
        const int cnt = (n + kBM - 1) / kBM;
        if (tile < base + cnt) {
          const int r0 = start + (tile - base) * kBM;
          found[0] = r0;
          found[1] = min(kBM, start + n - r0);
          found[2] = g;
          break;
        }
        base += cnt;
      }
    }
    if (lane == 0 && tile >= total) found[2] = -1;
  }
  __syncthreads();
  return Tile{found[0], found[1], found[2]};
}

// Copy one 16-byte chunk (4 floats or 8 bf16) global -> shared: one
// cp.async (kVec; a chunk past the row is zero-filled and reads nothing,
// from `base`), else element by element with a guard per element.
template <bool kVec, typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, const T* base,
                                       bool row_ok, int col, int limit) {
  if (kVec) {
    const bool ok = row_ok && col < limit;
    tiles::cp_async_16(dst, ok ? src : base, ok);
  } else {
#pragma unroll
    for (int k = 0; k < 16 / (int)sizeof(T); ++k)
      dst[k] = (row_ok && col + k < limit) ? src[k] : from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

namespace f32r {

constexpr int kThreads = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int kBN = 128;
constexpr int kBK = 16;                // reduction depth per slice
constexpr int kStages = 3;
constexpr int kLdA = kBK + 4;          // rows along k: [row][k]
constexpr int kLdB = kBN + 4;          // k-major: [k][col]
constexpr int kATile = kBM * kLdA;
constexpr int kBTile = kBN * kLdA;     // >= kBK * kLdB
constexpr int kStage = kATile + kBTile;
constexpr int kSmemBytes = kStages * kStage * (int)sizeof(float);

// Tile-local index of a thread's i-th row (or forward column), i in
// [0, 8): two 4-wide halves, 64 apart.
__device__ __forceinline__ int micro(int t, int i) {
  return (i < 4 ? 0 : 60) + t * 4 + i;
}

template <bool kTransW, bool kVec>
__device__ __forceinline__ void load_slice(
    float* as, float* bs, const float* __restrict__ x,
    const float* __restrict__ we, const Tile& t, int c0, int k0, int k_in,
    int m_out) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = tid + s * kThreads;  // 512 chunks of 4 floats per operand
    {  // x rows [row0, row0 + rows): 128 rows x 4 chunks
      const int r = i >> 2, kc = (i & 3) * 4;
      const bool ok = r < t.rows;
      copy16<kVec>(as + r * kLdA + kc,
                  x + (long long)(t.row0 + (ok ? r : 0)) * k_in + k0 + kc,
                  x, ok, k0 + kc, k_in);
    }
    if (kTransW) {  // w[e] [Mout][Kin] rows c0..: 128 rows x 4 chunks
      const int r = i >> 2, kc = (i & 3) * 4;
      const bool ok = c0 + r < m_out;
      copy16<kVec>(bs + r * kLdA + kc,
                  we + (long long)(ok ? c0 + r : 0) * k_in + k0 + kc, we,
                  ok, k0 + kc, k_in);
    } else {        // w[e] [Kin][Mout] rows k0..: 16 rows x 32 chunks
      const int p = i >> 5, cc = (i & 31) * 4;
      const bool ok = k0 + p < k_in;
      copy16<kVec>(bs + p * kLdB + cc,
                  we + (long long)(ok ? k0 + p : 0) * m_out + c0 + cc, we,
                  ok, c0 + cc, m_out);
    }
  }
}

template <bool kTransW>
__device__ __forceinline__ void multiply(const float* as, const float* bs,
                                         float (&acc)[8][8], int ty, int tx) {
#pragma unroll
  for (int p4 = 0; p4 < kBK; p4 += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(as + micro(ty, i) * kLdA + p4);
      a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
    }
    if (kTransW) {
      float b[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kLdA + p4);
        b[j][0] = v.x, b[j][1] = v.y, b[j][2] = v.z, b[j][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* br = bs + (p4 + q) * kLdB;
        const float4 b0 = *reinterpret_cast<const float4*>(br + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(br + 64 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][q], bv[j], acc[i][j]);
      }
    }
  }
}

// Grid (column tile, row tile of the schedule).  W_e(p, q) is w[e][p][q]
// (w [E,Kin,Mout]) or, with kTransW, w[e][q][p] (w [E,Mout,Kin]).
template <bool kTransW, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int rows, int k_in, int m_out, int experts) {
  extern __shared__ __align__(16) float smem[];
  const Tile t = find_tile(offsets, experts, rows, blockIdx.y);
  if (t.expert < 0) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * kBN;
  const float* we =
      w + (long long)min(t.expert, experts - 1) * k_in * m_out;
  const int n_k = t.expert == experts ? 0 : (k_in + kBK - 1) / kBK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k)
      load_slice<kTransW, kVec>(smem + st * kStage,
                                smem + st * kStage + kATile, x, we, t, c0,
                                st * kBK, k_in, m_out);
    tiles::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    tiles::cp_async_wait<kStages - 2>();   // slice kt arrived
    __syncthreads();                       // ... for all; kt - 1 consumed
    const int nk = kt + kStages - 1;       // refill slice kt - 1's stage
    if (nk < n_k) {
      float* st = smem + (nk % kStages) * kStage;
      load_slice<kTransW, kVec>(st, st + kATile, x, we, t, c0, nk * kBK,
                                k_in, m_out);
    }
    tiles::cp_async_commit();
    const float* st = smem + (kt % kStages) * kStage;
    multiply<kTransW>(st, st + kATile, acc, ty, tx);
  }
  tiles::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = micro(ty, i);
    if (r >= t.rows) continue;
    float* orow = out + (long long)(t.row0 + r) * m_out + c0;
    if (kTransW) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + tx + 16 * j < m_out) orow[tx + 16 * j] = acc[i][j];
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 64 + tx * 4;
        if (kVec && c0 + col + 3 < m_out) {
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + col + j < m_out) orow[col + j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

}  // namespace f32r

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tcr {

constexpr int kThreads = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBN = 128;
constexpr int kBK = 64;                // reduction depth per slice
constexpr int kStages = 3;
constexpr int kCpr = kBK / 8;          // 16-byte chunks per row along k
constexpr int kTileElems = kBM * kBK;  // = kBK * kBN
constexpr int kStage = 2 * kTileElems;
constexpr int kSmemBytes = kStages * kStage * (int)sizeof(bf16);
using SwK = tiles::Swizzle<kBK>;       // rows along k ([row][k])
using SwN = tiles::Swizzle<kBN>;       // k-major ([k][col])

template <bool kTransW, bool kVec>
__device__ __forceinline__ void load_slice(
    bf16* as, bf16* bs, const bf16* __restrict__ x,
    const bf16* __restrict__ we, const Tile& t, int c0, int k0, int k_in,
    int m_out) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kTileElems / 8 / kThreads; ++s) {
    const int i = tid + s * kThreads;  // chunks of 8 per operand
    {  // x rows: 128 rows x kCpr chunks
      const int r = i / kCpr, kc = i % kCpr;
      const bool ok = r < t.rows;
      copy16<kVec>(as + SwK::at(r, kc),
                  x + (long long)(t.row0 + (ok ? r : 0)) * k_in + k0 + kc * 8,
                  x, ok, k0 + kc * 8, k_in);
    }
    if (kTransW) {  // w[e] [Mout][Kin] rows c0..: 128 rows x kCpr chunks
      const int r = i / kCpr, kc = i % kCpr;
      const bool ok = c0 + r < m_out;
      copy16<kVec>(bs + SwK::at(r, kc),
                  we + (long long)(ok ? c0 + r : 0) * k_in + k0 + kc * 8, we,
                  ok, k0 + kc * 8, k_in);
    } else {        // w[e] [Kin][Mout] rows k0..: kBK rows x 16 chunks
      const int p = i >> 4, cc = i & 15;
      const bool ok = k0 + p < k_in;
      copy16<kVec>(bs + SwN::at(p, cc),
                  we + (long long)(ok ? k0 + p : 0) * m_out + c0 + cc * 8, we,
                  ok, c0 + cc * 8, m_out);
    }
  }
}

template <bool kTransW, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
moe_gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const int* __restrict__ offsets, bf16* __restrict__ out,
                     int rows, int k_in, int m_out, int experts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const Tile t = find_tile(offsets, experts, rows, blockIdx.y);
  if (t.expert < 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.x * kBN;
  const bf16* we = w + (long long)min(t.expert, experts - 1) * k_in * m_out;
  const int n_k = t.expert == experts ? 0 : (k_in + kBK - 1) / kBK;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
      acc[mi][nb][0] = acc[mi][nb][1] = acc[mi][nb][2] = acc[mi][nb][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k)
      load_slice<kTransW, kVec>(smem + st * kStage,
                                smem + st * kStage + kTileElems, x, we, t, c0,
                                st * kBK, k_in, m_out);
    tiles::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    tiles::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < n_k) {
      bf16* st = smem + (nk % kStages) * kStage;
      load_slice<kTransW, kVec>(st, st + kTileElems, x, we, t, c0, nk * kBK,
                                k_in, m_out);
    }
    tiles::cp_async_commit();
    const bf16* as = smem + (kt % kStages) * kStage;
    const bf16* bs = as + kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        tiles::ldmatrix_x4(
            af[mi], as + SwK::at(wm + mi * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8,
                                 kk * 2 + (lane >> 4)));
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t bfr[4];
        if (kTransW)   // [col][k]: the columns' rows are along k
          tiles::ldmatrix_x4(
              bfr, bs + SwK::at(wn + n2 * 16 + (lane & 7) + (lane >> 4) * 8,
                                kk * 2 + ((lane >> 3) & 1)));
        else           // [k][col]: transposed on the way to registers
          tiles::ldmatrix_x4_trans(
              bfr, bs + SwN::at(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                (wn + n2 * 16) / 8 + (lane >> 4)));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          tiles::mma_bf16(acc[mi][2 * n2], af[mi], bfr[0], bfr[1]);
          tiles::mma_bf16(acc[mi][2 * n2 + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  tiles::cp_async_wait<0>();

  const bool pairs = (m_out & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + mi * 16 + gq + h * 8;
      if (r >= t.rows) continue;
      bf16* orow = out + (long long)(t.row0 + r) * m_out;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = c0 + wn + nb * 8 + 2 * tq;
        const float v0 = acc[mi][nb][2 * h], v1 = acc[mi][nb][2 * h + 1];
        if (pairs && col + 1 < m_out) {
          *reinterpret_cast<uint32_t*>(orow + col) = tiles::pack_bf16(v0, v1);
        } else {
          if (col < m_out) orow[col] = __float2bfloat16(v0);
          if (col + 1 < m_out) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace tcr

// ---------------------------------------------------------------------------
// weight gradient, f32: the first design
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kTile = 128;             // output tile edge
constexpr int kDepth = 8;              // reduction depth staged per step
constexpr int kLd = kTile + 4;         // staged row length (floats)
constexpr int kFold = 128;             // rows summed before each fold

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
  // sums of 128 rows at a time in acc, folded into this thread's column
  // of `total` (shared memory, so the registers stay as they were): one
  // f32 sum over an expert of ~20k rows lost ~2e-4 against the plain
  // version
  extern __shared__ float total[];     // [64][kThreads]
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      total[(i * 8 + j) * kThreads + tid] = 0.f;
    }

  for (int i0 = start; i0 < end; i0 += kDepth) {
    if (i0 > start && ((i0 - start) & (kFold - 1)) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          total[(i * 8 + j) * kThreads + tid] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
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
        dwe[(long long)k * m_dim + m] =
            from_f32<T>(total[(i * 8 + j) * kThreads + tid] + acc[i][j]);
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// weight gradient, bf16: tensor cores over an expert's rows
// ---------------------------------------------------------------------------

namespace wgt {

constexpr int kThreads = 256;          // 8 warps: 2 (dw rows) x 4 (columns)
constexpr int kTile = 128;             // dw tile edge (k and m)
constexpr int kBR = 64;                // rows of the reduction per slice
constexpr int kStages = 3;
constexpr int kSlice = kBR * kTile;    // elements of one operand's slice
constexpr int kStage = 2 * kSlice;
constexpr int kSmemBytes = kStages * kStage * (int)sizeof(bf16);
using Sw = tiles::Swizzle<kTile>;      // [row][128] slices, the dw tile

// x rows [i0, i0 + 64) x columns [k0, k0 + 128) and the same dy rows x
// columns [m0, m0 + 128); rows at or past `end` and columns past the
// matrix read zeros.
template <bool kVec>
__device__ __forceinline__ void load_slice(
    bf16* xs, bf16* ys, const bf16* __restrict__ x,
    const bf16* __restrict__ dy, int i0, int end, int k0, int m0, int k_dim,
    int m_dim) {
#pragma unroll
  for (int s = 0; s < kSlice / 8 / kThreads; ++s) {
    const int i = threadIdx.x + s * kThreads;   // 64 rows x 16 chunks
    const int r = i >> 4, c = i & 15;
    const bool ok = i0 + r < end;
    const long long row = ok ? i0 + r : 0;
    copy16<kVec>(xs + Sw::at(r, c), x + row * k_dim + k0 + c * 8, x, ok,
                 k0 + c * 8, k_dim);
    copy16<kVec>(ys + Sw::at(r, c), dy + row * m_dim + m0 + c * 8, dy, ok,
                 m0 + c * 8, m_dim);
  }
}

// Grid (m tile, k tile, expert).  dw[e][k0.., m0..] = sum over the
// expert's rows i of x[i][k] dy[i][m]: A = x^T and B = dy, both staged as
// they lie (rows along the reduction) and read by ldmatrix.trans.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
moe_gemm_wgrad_bf16_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ dy,
                           const int* __restrict__ offsets,
                           bf16* __restrict__ dw, int rows, int k_dim,
                           int m_dim) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int e = blockIdx.z;
  const int start = min(max(__ldg(offsets + e), 0), rows);
  const int end = min(max(__ldg(offsets + e + 1), start), rows);
  const int n_s = (end - start + kBR - 1) / kBR;   // 0: a zero tile

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
      acc[mi][nb][0] = acc[mi][nb][1] = acc[mi][nb][2] = acc[mi][nb][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_s)
      load_slice<kVec>(smem + st * kStage, smem + st * kStage + kSlice, x, dy,
                       start + st * kBR, end, k0, m0, k_dim, m_dim);
    tiles::cp_async_commit();
  }
  for (int s = 0; s < n_s; ++s) {
    tiles::cp_async_wait<kStages - 2>();   // slice s arrived
    __syncthreads();                       // ... for all; s - 1 consumed
    const int ns = s + kStages - 1;
    if (ns < n_s) {
      bf16* st = smem + (ns % kStages) * kStage;
      load_slice<kVec>(st, st + kSlice, x, dy, start + ns * kBR, end, k0, m0,
                       k_dim, m_dim);
    }
    tiles::cp_async_commit();
    const bf16* xs = smem + (s % kStages) * kStage;
    const bf16* ys = xs + kSlice;
#pragma unroll
    for (int kk = 0; kk < kBR / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)   // [row][k]: transposed to dw's rows
        tiles::ldmatrix_x4_trans(
            af[mi], xs + Sw::at(kk * 16 + (lane & 7) + (lane >> 4) * 8,
                                (wk + mi * 16) / 8 + ((lane >> 3) & 1)));
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t bfr[4];               // [row][m]: as the forward reads w
        tiles::ldmatrix_x4_trans(
            bfr, ys + Sw::at(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             (wn + n2 * 16) / 8 + (lane >> 4)));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          tiles::mma_bf16(acc[mi][2 * n2], af[mi], bfr[0], bfr[1]);
          tiles::mma_bf16(acc[mi][2 * n2 + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  tiles::cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the dw tile

  // the tile rounded to bf16 through shared memory, then stored in
  // coalesced 16-byte rows
  bf16* ot = smem;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int r = wk + mi * 16 + gq + h * 8, c = wn + nb * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(ot + Sw::at(r, c / 8) + c % 8) =
            tiles::pack_bf16(acc[mi][nb][2 * h], acc[mi][nb][2 * h + 1]);
      }
  __syncthreads();
  bf16* dwe = dw + (long long)e * k_dim * m_dim;
#pragma unroll
  for (int s = 0; s < kTile * kTile / 8 / kThreads; ++s) {
    const int i = threadIdx.x + s * kThreads;   // 128 rows x 16 chunks
    const int r = i >> 4, c = i & 15;
    const int k = k0 + r, m = m0 + c * 8;
    if (k >= k_dim || m >= m_dim) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(ot + Sw::at(r, c));
    bf16* dst = dwe + (long long)k * m_dim + m;
    if (kVec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (m + j < m_dim) dst[j] = h[j];
    }
  }
}

}  // namespace wgt

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
using GemmKernel = void (*)(const T*, const T*, const int*, T*, int, int, int,
                            int);

template <typename T>
int run(GemmKernel<T> fn, int smem, int threads, const void* x,
        const void* w, const int* offsets, void* out, int rows, int k_in,
        int m_out, int experts, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m_out + 127) / 128, (rows + kBM - 1) / kBM + experts);
  fn<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), offsets,
      static_cast<T*>(out), rows, k_in, m_out, experts);
  return (int)cudaGetLastError();
}

template <typename T, bool kTransW, bool kVec>
int launch_one(const void* x, const void* w, const int* offsets, void* out,
               int rows, int k_in, int m_out, int experts,
               cudaStream_t stream) {
  if constexpr (sizeof(T) == 4)
    return run<T>(f32r::moe_gemm_f32_kernel<kTransW, kVec>, f32r::kSmemBytes,
                  f32r::kThreads, x, w, offsets, out, rows, k_in, m_out,
                  experts, stream);
  else
    return run<T>(tcr::moe_gemm_bf16_kernel<kTransW, kVec>, tcr::kSmemBytes,
                  tcr::kThreads, x, w, offsets, out, rows, k_in, m_out,
                  experts, stream);
}

template <typename T>
int launch_gemm(const void* x, const void* w, const int* offsets, void* out,
                int rows, int k_in, int m_out, int experts, int trans_w,
                cudaStream_t stream) {
  constexpr int E = 16 / (int)sizeof(T);
  const bool vec = aligned16(x) && aligned16(w) && aligned16(out) &&
                   k_in % E == 0 && (trans_w || m_out % E == 0);
  auto* fn = trans_w ? (vec ? launch_one<T, true, true>
                            : launch_one<T, true, false>)
                     : (vec ? launch_one<T, false, true>
                            : launch_one<T, false, false>);
  return fn(x, w, offsets, out, rows, k_in, m_out, experts, stream);
}

template <typename T>
using WgradKernel = void (*)(const T*, const T*, const int*, T*, int, int,
                             int);

template <typename T>
int launch_wgrad(const void* x, const void* dy, const int* offsets, void* dw,
                 int rows, int k_dim, int m_dim, int experts,
                 cudaStream_t stream) {
  static_assert(wg::kTile == wgt::kTile, "one grid for both routes");
  const dim3 grid((m_dim + wg::kTile - 1) / wg::kTile,
                  (k_dim + wg::kTile - 1) / wg::kTile, experts);
  WgradKernel<T> fn;
  int smem, threads;
  if constexpr (sizeof(T) == 4) {
    fn = wg::moe_gemm_wgrad_kernel<T>;
    smem = 64 * wg::kThreads * (int)sizeof(float);
    threads = wg::kThreads;
  } else {
    const bool vec = aligned16(x) && aligned16(dy) && aligned16(dw) &&
                     k_dim % 8 == 0 && m_dim % 8 == 0;
    fn = vec ? wgt::moe_gemm_wgrad_bf16_kernel<true>
             : wgt::moe_gemm_wgrad_bf16_kernel<false>;
    smem = wgt::kSmemBytes;
    threads = wgt::kThreads;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, threads, smem, stream>>>(
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
    return launch_gemm<bf16>(x, w, off, out, rows, k_in, m_out, experts,
                             trans_w, s);
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
    return launch_wgrad<bf16>(x, dy, off, dw, rows, k, m, experts, s);
  return (int)cudaErrorInvalidValue;
}
