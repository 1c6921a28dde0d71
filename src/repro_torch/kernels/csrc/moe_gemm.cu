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
// peak).  In practice the bf16 bodies are bound by what L2 feeds the SMs:
// a 128 x 256 tile reads 48 KB of operands a 64-deep step (85 flop a
// byte), 2.4 GB for the forward at that shape, and the loads alone take
// 0.228 ms (~10 TB/s; kernel_ab.py --ablate).
//
// What the first design lost (f32 6.37 ms, bf16 7.27 ms at that shape,
// NVIDIA H100 80GB HBM3, 700 W): CUDA cores in both types (bf16 widened to
// f32 on its way into shared memory), synchronous scalar staging with two
// barriers per 8-deep slice and no copy in flight during the math, and
// 128-row tiles that straddled experts ran the K loop once per
// overlapping expert (~1.3x the products at the path's load).  The
// second bf16 design (mma.sync from a cp.async ring, one block a 128 x
// 128 tile) ran 0.51 ms forward, 0.52 dgrad and 0.48 / 0.63 wgrad
// (router / skewed load; the parent's times below): 128 x 128 tiles read
// 64 flop a byte from L2, and each tile paid its ring's prologue and
// epilogue alone.
//
// float32 (the training path's type; no TF32, its tolerance is 1e-4):
//   * moe_gemm: expert-aligned tiles built on the device: expert e's rows
//     are cut into ceil(n_e / 128) row tiles, experts in order, then the
//     rows past offsets[E] (written as 0 without a K loop).  The grid is
//     (column tile, ceil(N / 128) + E row tiles), an upper bound from the
//     shapes alone; each block's first warp finds its tile by a warp scan
//     of the per-expert tile counts, and blocks past the list's end exit.
//     CUDA cores, 8 x 8 outputs per thread, a 3-stage ring of 16-deep
//     slices filled by 16-byte cp.async, one barrier per slice.  x rows
//     are staged as they lie (rows along k) and read four k at a time;
//     the forward's w slice k-major, read along the columns; the dgrad's
//     w[e]^T as rows along k, each thread owning columns 16 apart so that
//     a quarter-warp's float4 reads hit distinct banks;
//   * moe_gemm_wgrad: the unit of work is (dw tile, expert, row chunk).
//     Each expert's rows are cut into max(1, ceil(n_e / 1024)) chunks, a
//     work list the blocks build on the card as the forward's tiles; the
//     grid is (dw tiles, ceil(N / 1024) + E chunk slots), and blocks past
//     the list's end exit.  A block reduces its chunk on CUDA cores (8 x 8
//     outputs a thread) through a 2-stage ring of 16-row slices filled by
//     16-byte cp.async, its sum folded every 128 rows into a per-thread
//     column of shared memory (a running f32 sum over a whole 1024-row
//     chunk of unit-scale rows missed the 1e-4 check), 97 KB a block, two
//     blocks an SM.  The chunks of a tile then add into dw in chunk order:
//     chunk 0 stores, chunk j waits for an int32 flag (zeroed by the
//     wrapper) to read j, adds its sum to the stored tile (read from L2)
//     and sets j + 1.  A chunk waits only on a lower slot, whose block
//     started earlier, so the wait ends; no floating-point atomics, and
//     two calls give the same bits;
//   * a row whose byte length is not a multiple of 16 (or a pointer off a
//     16-byte boundary) takes the guarded element loader instead of
//     cp.async, chosen per call (kVec).
//
// bf16: one persistent body for all three (tc::grouped_gemm_bf16_kernel):
//   * one block an SM (the grid is the SM count) walks a work list of
//     output tiles that it builds from the offsets in shared memory.
//     Forward and dgrad: each group's rows (the experts in order, then the
//     rows past offsets[E], written as 0 with no reduction) cut into
//     128-row tiles, x the column tiles, one column's row tiles
//     consecutive so that w[e]'s columns are read from L2 by neighbouring
//     blocks; block b takes items b, b + grid, ...  Weight gradient: the
//     experts ordered by rows, heaviest first (a rank count in shared
//     memory), each with all its dw tiles (an empty expert's are written
//     as zeros); a block takes its own index first, then the next item of
//     an int32 counter the wrapper zeroes, so the hot expert's tiles start
//     first and blocks that finish early take the light tiles left.  No
//     tile straddles two experts, and each dw tile is one f32 sum in one
//     block: two calls give the same bits;
//   * two consumer warpgroups of wgmma.m64nNk16 (f32 accumulators, at most
//     128 a thread): 128 x 256 output tiles for the forward and dgrad
//     wherever the output is wider than 128 (M = 1408 pads to six tiles of
//     256, the last half empty: that still beat eleven of 128, since a
//     wider tile reads fewer bytes from L2 a product), 256 x 128 dw
//     tiles for the weight gradient at K = 2048, M = 1408 (each
//     warpgroup two m64 products on one B), 128 x 256 at K = 1408, M =
//     2048.  Operands: x (or dy) K-major; the forward's w[e]
//     [K,M] MN-major (wgmma's transposed-B flag); the dgrad's w[e]^T,
//     whose rows already lie along the reduction, K-major, read through
//     w's strides; the weight gradient's A = x_e^T and B = dy_e both
//     MN-major (both transpose flags);
//   * TMA: 3-d tensor maps (x / dy [1, N, cols], w [E, rows, cols], out /
//     dw) built on the host at each call and passed as __grid_constant__;
//     boxes of 64 columns (128 bytes) in the 128-byte swizzle, so every
//     operand is a stack of [rows][128 B] blocks; what lies past a tensor
//     is the TMA's zero fill;
//   * a ring of 64-deep stages (3 of 48 KB at 128 x 256 / 256 x 128, 5 of
//     32 KB at 128 x 128) with full mbarriers (the TMA's bytes) and empty
//     ones (one arrival a warp).  Thread 0 keeps the ring full across
//     tiles and writes each stage's item into a slot beside it (a tile of
//     zeros takes one stage with no bytes, the list's end one holding -1),
//     so the next tile's loads are in flight during a tile's epilogue.  No
//     producer warpgroup and no setmaxnreg (flash_attention.cu's note:
//     ptxas capped the consumers at the launch bound's 168 registers and
//     serialised the wgmma); every mbarrier wait comes before a batch's
//     wgmma.fence, and no branch touches the accumulators (a zero tile is
//     stored as zeros, not cleared; a warpgroup with no rows of its group
//     runs its products and stores nothing): either made ptxas serialise
//     every wgmma (C7520);
//   * expert edges.  The forward's last tile of an expert holds the next
//     expert's rows: its products run on them and the epilogue writes
//     none of them.  The weight gradient's last slice of an expert holds
//     the next expert's rows (the TMA zero-fills only past the tensor):
//     every thread zeroes those rows of both operands in shared memory
//     with generic stores, fence.proxy.async, then a barrier of both
//     warpgroups before their products;
//   * epilogue: each warpgroup rounds its tile to bf16 into its own
//     staging blocks (the swizzle spreads a quad's rows over the banks),
//     then thread 0 of the warpgroup TMA-stores a full tile (the TMA clips
//     rows >= N and columns >= M); a forward tile that ends inside its
//     group's rows is stored in coalesced 16-byte rows masked by row (a
//     TMA store would write the next expert's rows, a race).  The store
//     overlaps the next tile; the staging is written again only after the
//     store has read it (cp.async.bulk.wait_group.read);
//   * the guarded route (a row whose byte length is not a multiple of 16,
//     bf16 K = 36 or M = 130, or a base off a 16-byte boundary; chosen per
//     call, tma_route): every thread fills the same swizzled blocks with
//     the guarded element loader (rows past the expert read as 0), two
//     stages (one filled while the other's products run), the same
//     products, and element stores; a route of the kernel, not a fallback.
//
// Times (kernel_ab.py, parent / this design in one call, the training
// run's router load; NVIDIA H100 80GB HBM3, 700 W; median of 20, L2
// flushed) at the training shape: bf16 forward 0.5063 -> 0.3056 ms
// (torch._grouped_mm 0.3054), dgrad 0.5165 -> 0.3009 (0.3007), wgrad
// 0.4817 -> 0.3730 (0.3433) and 0.6253 -> 0.3641 at the skewed load
// (0.3914); f32 (untouched) forward 4.0866, dgrad 3.9863, wgrad 3.2672 /
// 3.3712 (torch._grouped_mm 4.2977 / 4.5510 / 4.0764 / 3.6199).  Where
// the bf16 time goes (kernel_ab.py --ablate; PERF.md §6): the products
// hide behind the loads, the epilogue does not (the ring is full while a
// tile is staged, and the loads stall).  Tried on throwaway variants of
// this file and dropped, each slower or no faster at the training shape:
// 128 x 128 forward tiles, generic 16-byte stores in place of the TMA
// store, a fourth 48 KB stage bought by staging half a tile at a time
// (the second half waited for the first half's store to read shared
// memory), skipping an idle warpgroup's products.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9), tc::grouped_gemm_bf16_kernel
// <op, BM, BN, route>: 188 registers at 128 x 256 (forward, dgrad) and 197
// (wgrad 128 x 256, 256 x 128), 117-123 at 128 x 128 (TMA) and 121-123
// on the guarded route (16 bytes of stack: the element loader's chunk);
// no spills, no serialised wgmma; dynamic shared memory (Plan::smem, E =
// 64) 214,604 bytes at 128 x 256 / 256 x 128, 198,260 at 128 x 128,
// 99,896 guarded.  moe_gemm_f32_kernel 167 registers (forward) and 244 /
// 252 (dgrad, guarded / cp.async), 60 KB of dynamic shared memory;
// wg::moe_gemm_wgrad_kernel (f32) 127 / 121 registers, 97 KB; no spills.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libmoe_gemm.so moe_gemm.cu
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

using tiles::bf16;

// ---------------------------------------------------------------------------
// the expert-aligned work lists, built on the card from the offsets
// ---------------------------------------------------------------------------

constexpr int kBM = 128;               // rows per tile (both routes)

// One unit of a work list: rows [row0, row0 + rows) of group `expert`
// (expert == experts: the rows past the groups; -1: past the list's end),
// the `index`-th unit of its group.
struct Unit {
  int row0, rows, expert, index;
};
using Tile = Unit;

// Start of group g's rows: groups 0..E-1 are the experts, group E the
// rows past offsets[E]; offsets are clamped into [0, rows].
__device__ __forceinline__ int group_start(const int* __restrict__ offsets,
                                           int experts, int rows, int g) {
  if (g <= 0) return 0;
  if (g > experts) return rows;
  return min(max(__ldg(offsets + g), 0), rows);
}

// Unit `unit` of the list that cuts each of the first `groups` groups, in
// order, into runs of at most kRows rows: ceil(n / kRows) units a group,
// at least one with kKeepEmpty (an empty group's unit has no rows).
// Found by the block's first warp (each lane sums the unit counts of a
// run of groups, a warp scan places the runs) and broadcast through
// shared memory.
template <int kRows, bool kKeepEmpty>
__device__ Unit find_unit(const int* __restrict__ offsets, int experts,
                          int rows, int groups, int unit) {
  __shared__ int found[4];
  auto units = [](int n) {
    const int c = (n + kRows - 1) / kRows;
    return kKeepEmpty ? max(1, c) : c;
  };
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int seg = (groups + 31) / 32;
    const int lo = min(lane * seg, groups), hi = min(lo + seg, groups);
    int count = 0;
    for (int g = lo; g < hi; ++g)
      count += units(max(group_start(offsets, experts, rows, g + 1) -
                             group_start(offsets, experts, rows, g),
                         0));
    int incl = count;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = incl - count;
    if (unit >= base && unit < incl) {
      for (int g = lo; g < hi; ++g) {
        const int start = group_start(offsets, experts, rows, g);
        const int n =
            max(group_start(offsets, experts, rows, g + 1) - start, 0);
        if (unit < base + units(n)) {
          const int j = unit - base;
          found[0] = start + j * kRows;
          found[1] = min(kRows, n - j * kRows);
          found[2] = g;
          found[3] = j;
          break;
        }
        base += units(n);
      }
    }
    if (lane == 0 && unit >= total) found[2] = -1;
  }
  __syncthreads();
  return Unit{found[0], found[1], found[2], found[3]};
}

// Row tile `tile` of the forward's schedule: each expert's rows cut into
// 128-row tiles, experts in order, then the rows past offsets[E] (no tile
// for an empty group).
__device__ __forceinline__ Tile find_tile(const int* __restrict__ offsets,
                                          int experts, int rows, int tile) {
  return find_unit<kBM, false>(offsets, experts, rows, experts + 1, tile);
}

// Copy one 16-byte chunk (4 floats) global -> shared: one cp.async
// (kVec; a chunk past the row is zero-filled and reads nothing, from
// `base`), else element by element with a guard per element.
template <bool kVec>
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       const float* base, bool row_ok,
                                       int col, int limit) {
  if (kVec) {
    const bool ok = row_ok && col < limit;
    tiles::cp_async_16(dst, ok ? src : base, ok);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k] = (row_ok && col + k < limit) ? src[k] : 0.f;
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
// weight gradient, f32: each expert's rows cut into chunks, one block per
// (dw tile, chunk), the chunks added in order
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kThreads = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int kTile = 128;             // dw tile edge (k and m)
constexpr int kBR = 16;                // rows of the reduction per slice
constexpr int kStages = 2;
constexpr int kLd = kTile + 4;         // a staged row: [row][k or m]
constexpr int kSlice = kBR * kLd;      // floats of one operand's slice
constexpr int kStage = 2 * kSlice;
constexpr int kRing = kStages * kStage;
constexpr int kFold = 128;             // rows summed before each fold
// the ring, then each thread's column of 64 folded sums: 97 KB, two
// blocks an SM
constexpr int kSmemBytes = (kRing + 64 * kThreads) * (int)sizeof(float);
constexpr int kChunk = 1024;           // rows one block reduces, at most

// Chunk `slot` of the work list: each expert's rows cut into max(1,
// ceil(n_e / kChunk)) chunks, experts in order (an empty expert keeps one
// chunk of no rows, which writes its zero tile); the rows past offsets[E]
// are no expert's and get none.
__device__ __forceinline__ Unit find_chunk(const int* __restrict__ offsets,
                                           int experts, int rows, int slot) {
  return find_unit<kChunk, true>(offsets, experts, rows, experts, slot);
}

// x rows [i0, i0 + 16) x columns [k0, k0 + 128) and the same dy rows x
// columns [m0, m0 + 128), both as they lie (rows along the reduction);
// rows at or past `end` and columns past the matrix read zeros.
template <bool kVec>
__device__ __forceinline__ void load_slice(
    float* xs, float* ys, const float* __restrict__ x,
    const float* __restrict__ dy, int i0, int end, int k0, int m0,
    int k_dim, int m_dim) {
#pragma unroll
  for (int s = 0; s < kBR * kTile / 4 / kThreads; ++s) {
    const int i = threadIdx.x + s * kThreads;   // 16 rows x 32 chunks
    const int r = i >> 5, cc = (i & 31) * 4;
    const bool ok = i0 + r < end;
    const long long row = ok ? i0 + r : 0;
    copy16<kVec>(xs + r * kLd + cc, x + row * k_dim + k0 + cc, x, ok,
                 k0 + cc, k_dim);
    copy16<kVec>(ys + r * kLd + cc, dy + row * m_dim + m0 + cc, dy, ok,
                 m0 + cc, m_dim);
  }
}

__device__ __forceinline__ int micro(int t, int i) {
  return (i < 4 ? 0 : 60) + t * 4 + i;
}

// acc[i][j] += sum_p a[p][micro(ty, i)] * b[p][micro(tx, j)]
__device__ __forceinline__ void multiply(const float* a, const float* b,
                                         float (&acc)[8][8], int ty,
                                         int tx) {
#pragma unroll
  for (int p = 0; p < kBR; ++p) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + p * kLd + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + p * kLd + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + p * kLd + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b + p * kLd + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Grid (dw tile, chunk slot): ceil(N / kChunk) + E slots, an upper bound
// from the shapes alone; blocks past the list's end exit.  A block reduces
// its chunk's rows through a 2-stage ring of 16-row slices (16-byte
// cp.async, one barrier a slice; two blocks an SM overlap each other's
// copies), folding every 128 rows, then adds its sum into the dw tile in
// chunk order: chunk 0 stores it, chunk j waits until flags[e][tile] = j
// (chunk j - 1 has stored), adds its sum to the stored tile (read from
// L2) and sets the flag to j + 1.  A chunk waits only on one of a lower
// slot, whose block started earlier, so the wait always ends; the sum is
// ((c0 + c1) + c2) + ... in every call, with no floating-point atomics.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_gemm_wgrad_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy,
                      const int* __restrict__ offsets, float* __restrict__ dw,
                      int* __restrict__ flags, int rows, int k_dim,
                      int m_dim, int experts) {
  extern __shared__ __align__(16) float smem[];
  const Unit c = find_chunk(offsets, experts, rows, blockIdx.y);
  if (c.expert < 0) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_m = (m_dim + kTile - 1) / kTile;
  const int m0 = (blockIdx.x % tiles_m) * kTile;
  const int k0 = (blockIdx.x / tiles_m) * kTile;
  const int end = c.row0 + c.rows;
  const int n_s = (c.rows + kBR - 1) / kBR;    // 0: a zero tile
  // sums of 128 rows at a time in acc, folded into this thread's column
  // of `total` (shared memory, so that two blocks still share an SM): a
  // running f32 sum over a whole chunk of unit-scale rows missed the
  // 1e-4 check
  float* total = smem + kRing;         // [64][kThreads]

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      total[(i * 8 + j) * kThreads + tid] = 0.f;
    }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_s)
      load_slice<kVec>(smem + st * kStage, smem + st * kStage + kSlice, x,
                       dy, c.row0 + st * kBR, end, k0, m0, k_dim, m_dim);
    tiles::cp_async_commit();
  }
  for (int s = 0; s < n_s; ++s) {
    if (s > 0 && s % (kFold / kBR) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          total[(i * 8 + j) * kThreads + tid] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    tiles::cp_async_wait<kStages - 2>();   // slice s arrived
    __syncthreads();                       // ... for all; s - 1 consumed
    const int ns = s + kStages - 1;
    if (ns < n_s) {
      float* st = smem + (ns % kStages) * kStage;
      load_slice<kVec>(st, st + kSlice, x, dy, c.row0 + ns * kBR, end, k0,
                       m0, k_dim, m_dim);
    }
    tiles::cp_async_commit();
    const float* xs = smem + (s % kStages) * kStage;
    multiply(xs, xs + kSlice, acc, ty, tx);
  }
  tiles::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] += total[(i * 8 + j) * kThreads + tid];

  float* dwe = dw + (long long)c.expert * k_dim * m_dim;
  int* flag = flags + (long long)c.expert * gridDim.x + blockIdx.x;
  if (c.index > 0) {                   // chunk index - 1 has stored
    if (tid == 0)
      while (load_acquire(flag) != c.index) {
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + micro(ty, i);
    if (k >= k_dim) continue;
    float* row = dwe + (long long)k * m_dim + m0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 64 + tx * 4;
      float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                    acc[i][4 * h + 3]};
      if (kVec && m0 + col + 3 < m_dim) {
        if (c.index > 0) {
          const float4 p = __ldcg(reinterpret_cast<const float4*>(row + col));
          v[0] = p.x + v[0], v[1] = p.y + v[1], v[2] = p.z + v[2],
          v[3] = p.w + v[3];
        }
        *reinterpret_cast<float4*>(row + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (m0 + col + e < m_dim)
            row[col + e] = c.index > 0 ? __ldcg(row + col + e) + v[e] : v[e];
      }
    }
  }
  __threadfence();
  __syncthreads();                     // the whole tile is stored
  if (tid == 0) store_release(flag, c.index + 1);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, one persistent block an SM
// ---------------------------------------------------------------------------

namespace tc {

// What a launch computes.  kFwd: out = x @ w[e] (B = w[e] [K,M], MN-major);
// kDgrad: out = dy @ w[e]^T (B = w[e]^T, whose rows lie along the
// reduction: K-major); kWgrad: dw[e] = x_e^T dy_e (A = x_e^T and B = dy_e,
// both MN-major).
enum Op { kFwd = 0, kDgrad = 1, kWgrad = 2 };

// Two consumer warpgroups of BM / 2 output rows each; thread 0 also issues
// the TMA.  Eight warps may hold 255 registers a thread.
constexpr int kThreads = 256;
constexpr int kBK = 64;                // reduction depth of a stage
constexpr int kBlk = 64 * 128;         // a [64 rows][64 bf16] block: 8 KB
constexpr int kSmemLimit = 232448;     // dynamic shared memory of a block

// The launch plan of a body: BM x BN output tiles (BM 128, or 256 for the
// weight gradient's dw rows; BN 128 or 256), NS ring stages (the guarded
// route: two, one filled while the other's products run).  A stage holds
// A (BM x 64; the wgrad's 64 x BM) and B (64 x BN) as blocks of 128-byte
// rows in the 128-byte swizzle; each warpgroup stages its BM / 2 x BN
// output the same way for its TMA store.  The groups' table (4 (2 E + 4)
// bytes) follows the fixed part.  (Halving the staging for a fourth 48 KB
// stage lost: the second half's staging waited for the first half's TMA
// store to read shared memory, queued behind the ring's loads.)
template <int BM, int BN, bool kTma>
struct Plan {
  static constexpr int A_BYTES = BM * kBK * 2;
  static constexpr int B_BYTES = BN * kBK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NS = !kTma ? 2 : STAGE <= 32768 ? 5 : 3;
  static constexpr int OUT_BYTES = BM * BN * 2;
  static constexpr int SMEM = 1024 + NS * STAGE + OUT_BYTES + 20 * NS;
  static_assert(SMEM + 4 * 4 <= kSmemLimit, "bf16 GEMM plan exceeds smem");
  static_assert(BN % 64 == 0 && BN <= 256 && (BM == 128 || BM == 256),
                "wgmma: 64-row warpgroup tiles, N in 64-column blocks");
  static_assert(BM * BN <= 128 * 256, "accumulators: 128 f32 a thread");
  static int smem(int experts) { return SMEM + 4 * (2 * experts + 4); }
};

// A tile's width along `n`: 256 where that pads n no more than 128 does,
// else 128 (M = 1408: 11 tiles of 128, not 6 of 256).
inline int tile_edge(int n) {
  const int r128 = (n + 127) / 128 * 128, r256 = (n + 255) / 256 * 256;
  return r256 == r128 ? 256 : 128;
}

struct Args {
  const int* offsets;
  int* counter;  // wgrad, TMA route: the work list's next slot, 0 on entry
  const bf16* a;  // x (dy for the dgrad) [rows, kred]; wgrad: x [rows, kdim]
  const bf16* b;  // w; wgrad: dy [rows, cols]
  bf16* c;        // out [rows, cols]; wgrad: dw [E, kdim, cols]
  int rows, kred, cols, kdim, experts;
};

// One unit of work: the output tile at (row0 or k0, c0) of group g.  For
// kFwd / kDgrad row0 is the tile's first row and end its group's end (the
// rows past offsets[E] are group E); for kWgrad [row0, end) are expert
// g's rows and k0 the dw tile's first row.  `steps` slices of the
// reduction (0: a tile of zeros).
struct Work {
  int g, row0, end, k0, c0, steps;
};

template <int kOp, int BM, int BN>
__device__ __forceinline__ Work decode(const Args& p, const int* table,
                                       int item) {
  Work w;
  const int E = p.experts, ct = (p.cols + BN - 1) / BN;
  if constexpr (kOp == kWgrad) {
    const int kt = (p.kdim + BM - 1) / BM, per = kt * ct;
    const int slot = item / per, t = item - slot * per;
    w.g = table[E + slot];             // heaviest first
    w.row0 = group_start(p.offsets, E, p.rows, w.g);
    w.end = max(group_start(p.offsets, E, p.rows, w.g + 1), w.row0);
    w.k0 = (t / ct) * BM;
    w.c0 = (t % ct) * BN;
    w.steps = (w.end - w.row0 + kBK - 1) / kBK;
  } else {
    int lo = 0, hi = E + 1;            // the group whose items hold `item`
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (table[mid] <= item) lo = mid; else hi = mid;
    }
    const int start = group_start(p.offsets, E, p.rows, lo);
    w.g = lo;
    w.end = max(group_start(p.offsets, E, p.rows, lo + 1), start);
    const int rt = (w.end - start + BM - 1) / BM, local = item - table[lo];
    // one column's row tiles run together: w[e]'s columns stay in L2
    w.row0 = start + (local % rt) * BM;
    w.c0 = (local / rt) * BN;
    w.k0 = 0;
    w.steps = lo < E ? (p.kred + kBK - 1) / kBK : 0;
  }
  return w;
}

// Rows [r0, r0 + R) x columns [c0, c0 + 64) of a row-major matrix (row
// stride ld) into a [R][128 B] block in the 128-byte swizzle, element by
// element: rows at or past row_lim and columns past col_lim read 0.
__device__ __forceinline__ void fill_block(unsigned char* dst,
                                           const bf16* __restrict__ src,
                                           long long ld, int r0, int row_lim,
                                           int c0, int col_lim, int R) {
  for (int i = threadIdx.x; i < R * 8; i += kThreads) {
    const int r = i >> 3, ch = i & 7, row = r0 + r, col = c0 + ch * 8;
    alignas(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = row < row_lim && col + e < col_lim ? src[row * ld + col + e]
                                                : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst + hopper::swizzle<128>(r * 128 + ch * 16)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// Persistent: gridDim.x blocks (one an SM) walk the work list.  TMA route:
// thread 0 keeps an NS-stage ring full (full mbarriers carry the TMA's
// bytes, empty ones one arrival a warp) and writes each stage's item into
// a slot beside it; a tile of zeros takes one stage with no bytes, the
// list's end one holding -1.  The consumers read the item from the slot,
// run wgmma over each stage and release it once its products have
// landed; the next tile's loads are in flight during an epilogue.
// Guarded route: every thread stages a slice element by element into the
// same layout (two stages: a slice is filled while the last one's products
// run), then the same products.  No branch touches the accumulators
// (ptxas would serialise every wgmma, C7520): a warpgroup whose rows hold
// no work runs its products on what it was given and stores nothing, and
// a tile of zeros is stored as zeros, not cleared.
template <int kOp, int BM, int BN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb,
                         const __grid_constant__ CUtensorMap tout,
                         const Args p) {
  using P = Plan<BM, BN, kTma>;
  constexpr int NS = P::NS, NB = BN / 64, WM = BM / 2, MS = WM / 64;
  constexpr int TA = kOp == kWgrad, TB = kOp != kDgrad;   // MN-major flags
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  auto sm = [&](uint32_t addr) { return gbase + (addr - base); };
  const uint32_t ring = base;                          // + st * STAGE
  const uint32_t outs = ring + NS * P::STAGE;          // + wg * OUT / 2
  const uint32_t bars = outs + P::OUT_BYTES;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (NS + st); };
  int* const slot = reinterpret_cast<int*>(sm(bars + 16u * NS));
  int* const table = slot + NS;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int E = p.experts, ct = (p.cols + BN - 1) / BN;

  // The work list.  kWgrad: the experts by size, heaviest first (order in
  // table[E..2E), ties by index), then each expert's dw tiles; kFwd /
  // kDgrad: table[g] = the first item of group g (groups E + 1: the
  // experts, then the rows past offsets[E]), each group's row tiles x
  // column tiles, one column's row tiles together.
  int total;
  if constexpr (kOp == kWgrad) {
    for (int e = tid; e < E; e += kThreads)
      table[e] = max(group_start(p.offsets, E, p.rows, e + 1) -
                         group_start(p.offsets, E, p.rows, e),
                     0);
    __syncthreads();
    for (int e = tid; e < E; e += kThreads) {
      const int n = table[e];
      int rank = 0;
      for (int f = 0; f < E; ++f)
        rank += table[f] > n || (table[f] == n && f < e);
      table[E + rank] = e;
    }
    total = E * ((p.kdim + BM - 1) / BM) * ct;
  } else {
    if (tid < 32) {
      const int groups = E + 1, seg = (groups + 31) / 32;
      const int lo = min(lane * seg, groups), hi = min(lo + seg, groups);
      auto items = [&](int g) {
        const int n = max(group_start(p.offsets, E, p.rows, g + 1) -
                              group_start(p.offsets, E, p.rows, g),
                          0);
        return (n + BM - 1) / BM * ct;
      };
      int count = 0;
      for (int g = lo; g < hi; ++g) count += items(g);
      int incl = count;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      int run = incl - count;
      for (int g = lo; g < hi; ++g) {
        table[g] = run;
        run += items(g);
      }
      if (lane == 31) table[groups] = incl;
    }
  }
  if (kTma && tid == 0) {
    for (int st = 0; st < NS; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), 8);       // the block's 8 warps
    }
    hopper::mbar_fence_init();
    hopper::prefetch_map(&ta);
    hopper::prefetch_map(&tb);
    hopper::prefetch_map(&tout);
  }
  __syncthreads();
  if constexpr (kOp != kWgrad) total = table[E + 1];

  // ---- the producer: thread 0's cursor over the steps of its items ----
  // The first item is the block's index, the next ones by a stride of the
  // grid, or (wgrad) from the shared counter: blocks that finish early
  // take the lighter tiles that remain.
  auto next_item = [&](int item) {
    int nx;
    if constexpr (kOp == kWgrad && kTma)
      nx = gridDim.x + atomicAdd(p.counter, 1);
    else
      nx = item + gridDim.x;
    return nx < total ? nx : -1;
  };
  int p_item = blockIdx.x < total ? (int)blockIdx.x : -1, p_sub = 0, ps = 0;
  Work pw{};
  if (kTma && tid == 0 && p_item >= 0)
    pw = decode<kOp, BM, BN>(p, table, p_item);
  auto produce = [&]() {                      // thread 0: the next step
    if (p_item == -2) return;                 // the list's end was sent
    const int st = ps % NS;
    if (ps >= NS) hopper::mbar_wait(empty(st), ((ps / NS) - 1) & 1);
    slot[st] = p_item;
    ++ps;
    if (p_item < 0) {                         // the list's end
      hopper::mbar_arrive(full(st));
      p_item = -2;
      return;
    }
    if (pw.steps == 0) {                      // a tile of zeros
      hopper::mbar_arrive(full(st));
    } else {
      const uint32_t a_s = ring + st * P::STAGE, b_s = a_s + P::A_BYTES;
      hopper::mbar_expect_tx(full(st), P::STAGE);
      const int k = p_sub * kBK;
      if constexpr (kOp == kWgrad) {
        const int r = pw.row0 + k;
#pragma unroll
        for (int b = 0; b < BM / 64; ++b)
          hopper::tma_load_3d(a_s + b * kBlk, &ta, full(st), pw.k0 + 64 * b,
                              r, 0);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          hopper::tma_load_3d(b_s + b * kBlk, &tb, full(st), pw.c0 + 64 * b,
                              r, 0);
      } else {
        hopper::tma_load_3d(a_s, &ta, full(st), k, pw.row0, 0);
        if constexpr (kOp == kFwd) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            hopper::tma_load_3d(b_s + b * kBlk, &tb, full(st),
                                pw.c0 + 64 * b, k, pw.g);
        } else {
          hopper::tma_load_3d(b_s, &tb, full(st), k, pw.c0, pw.g);
        }
      }
      if (++p_sub < pw.steps) return;
    }
    p_sub = 0;
    p_item = next_item(p_item);
    if (p_item >= 0) pw = decode<kOp, BM, BN>(p, table, p_item);
  };
  if (kTma && tid == 0)
    for (int i = 0; i < NS; ++i) produce();
  __syncwarp();

  // ---- the consumers ----
  // Shared-memory descriptors (128-byte swizzle): K-major A rows of 128 B
  // (8-row groups 1024 B apart, k steps 32 B along the row); MN-major
  // operands as 64-column blocks kBlk apart, k steps 16 rows (2 KB) down.
  // Warpgroup wg's 64-row part ms of A: rows (or the wgrad's dw rows)
  // wg * WM + ms * 64.
  auto desc_a = [&](int st, int kk, int ms) {
    const uint32_t a_s = ring + st * P::STAGE;
    return TA ? hopper::make_desc(a_s + (wg * MS + ms) * kBlk + kk * 2048,
                                  kBlk, 1024, 1)
              : hopper::make_desc(a_s + (wg * WM + ms * 64) * 128 + kk * 32,
                                  16, 1024, 1);
  };
  auto desc_b = [&](int st, int kk) {
    const uint32_t b_s = ring + st * P::STAGE + P::A_BYTES;
    return TB ? hopper::make_desc(b_s + kk * 2048, kBlk, 1024, 1)
              : hopper::make_desc(b_s + kk * 32, 16, 1024, 1);
  };
  auto wait_full = [&](int step) {
    hopper::mbar_wait(full(step % NS), (step / NS) & 1);
  };
  auto release = [&](int step) {              // and refill from thread 0
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(step % NS));
    if (tid == 0) produce();
    __syncwarp();
  };

  float acc[MS][BN / 2];
  const int tw = tid % 128;
  // this warpgroup's staging: NB blocks of [WM rows][128 B]
  const uint32_t stage_out = outs + wg * (P::OUT_BYTES / 2);
  int cs = 0;                                 // the consumers' step
  int c_item = blockIdx.x;                    // guarded route: static walk
  for (;;) {
    Work w;
    if constexpr (kTma) {
      wait_full(cs);
      const int item = slot[cs % NS];
      if (item < 0) break;
      w = decode<kOp, BM, BN>(p, table, item);
      if (w.steps == 0) release(cs++);
    } else {
      if (c_item >= total) break;
      w = decode<kOp, BM, BN>(p, table, c_item);
      c_item += gridDim.x;
    }
    for (int s = 0; s < w.steps; ++s) {
      const int st = kTma ? cs % NS : s % NS;
      const uint32_t a_s = ring + st * P::STAGE;
      if constexpr (kTma) {
        if (s > 0) wait_full(cs);
        if constexpr (kOp == kWgrad) {
          // rows of the next expert in this slice: zeroed in both operands
          // (TMA fills zeros only past the tensor), made visible to the
          // async proxy before any warpgroup's products read them
          const int valid = w.end - (w.row0 + s * kBK);
          if (valid < kBK) {
            const int per = (kBK - valid) * 8;
            for (int i = tid; i < per * (BM / 64 + NB); i += kThreads) {
              const int blk = i / per, j = i - blk * per;
              *reinterpret_cast<uint4*>(sm(a_s) + blk * kBlk +
                                        (valid + (j >> 3)) * 128 +
                                        (j & 7) * 16) = make_uint4(0, 0, 0, 0);
            }
            hopper::fence_proxy_async();
            hopper::bar_sync(1, kThreads);
          }
        }
      } else {
        __syncthreads();             // the products of step s - 2 landed
        unsigned char* a_g = sm(a_s);
        unsigned char* b_g = a_g + P::A_BYTES;
        const int k = s * kBK;
        if constexpr (kOp == kWgrad) {
          const int r = w.row0 + k;
          for (int b = 0; b < BM / 64; ++b)
            fill_block(a_g + b * kBlk, p.a, p.kdim, r, w.end, w.k0 + 64 * b,
                       p.kdim, kBK);
          for (int b = 0; b < NB; ++b)
            fill_block(b_g + b * kBlk, p.b, p.cols, r, w.end, w.c0 + 64 * b,
                       p.cols, kBK);
        } else {
          fill_block(a_g, p.a, p.kred, w.row0, p.rows, k, p.kred, BM);
          const bf16* we = p.b + (long long)w.g * p.kred * p.cols;
          if constexpr (kOp == kFwd) {
            for (int b = 0; b < NB; ++b)
              fill_block(b_g + b * kBlk, we, p.cols, k, p.kred,
                         w.c0 + 64 * b, p.cols, kBK);
          } else {
            fill_block(b_g, we, p.kred, w.c0, p.cols, k, p.kred, BN);
          }
        }
        hopper::fence_proxy_async();
        __syncthreads();
      }
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) hopper::fence_regs(acc[ms]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int ms = 0; ms < MS; ++ms)
          hopper::wgmma_ss<BN, TA, TB>(acc[ms], desc_a(st, kk, ms),
                                       desc_b(st, kk), s > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();                // the last step's products
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) hopper::fence_regs(acc[ms]);
      if constexpr (kTma) {
        if (s > 0) release(cs - 1);
        ++cs;
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) hopper::fence_regs(acc[ms]);
    if (kTma && w.steps > 0) release(cs - 1);

    // ---- epilogue: the warpgroup's WM x BN tile rounded to bf16 into its
    // staging blocks by stmatrix (the swizzle spreads a matrix's rows over
    // the banks), then one TMA store a block, or (a tile that ends inside
    // its group's rows, or the guarded route) coalesced 16-byte stores
    // masked by row.  The store overlaps the next tile; the staging is
    // written again once the store has read it.
    const int row_base = (kOp == kWgrad ? w.k0 : w.row0) + WM * wg;
    const int row_lim = kOp == kWgrad ? p.kdim : w.end;
    if (row_base >= row_lim) continue;        // no row of this warpgroup
    if (tw == 0) hopper::bulk_wait_read();    // the last store read it
    hopper::bar_sync(2 + wg, 128);
    const bool zero = w.steps == 0;
    // lane l addresses row l % 8 of matrix l / 8, the matrices being
    // (rows 0-7, 8-15) x (columns 8 j, 8 j + 8) of a 16-column pair
    const int m_r = (lane >> 3) & 1, m_j = lane >> 4;
    auto pk = [&](int ms, int i) {
      return zero ? 0u : tiles::pack_bf16(acc[ms][i], acc[ms][i + 1]);
    };
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        const int col = 16 * jp + 8 * m_j;
        const uint32_t off =
            (col / 64) * (WM * 128) +
            (ms * 64 + 16 * warp + (lane & 7) + 8 * m_r) * 128 +
            (col % 64) * 2;
        hopper::stmatrix_x4(stage_out + hopper::swizzle<128>(off),
                            pk(ms, 8 * jp), pk(ms, 8 * jp + 2),
                            pk(ms, 8 * jp + 4), pk(ms, 8 * jp + 6));
      }
    hopper::fence_proxy_async();
    hopper::bar_sync(2 + wg, 128);
    const int batch = kOp == kWgrad ? w.g : 0;
    if (kTma && (kOp == kWgrad || row_base + WM <= w.end ||
                 w.end >= p.rows)) {
      if (tw == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          hopper::tma_store_3d(&tout, stage_out + b * (WM * 128),
                               w.c0 + 64 * b, row_base, batch);
        hopper::bulk_commit();
      }
      continue;
    }
    bf16* const c = p.c + (long long)batch * p.kdim * p.cols;
    for (int i = tw; i < WM * BN / 8; i += 128) {
      const int r = i / (BN / 8), ch = i % (BN / 8);
      const int row = row_base + r, col = w.c0 + ch * 8;
      if (row >= row_lim || col >= p.cols) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          sm(stage_out) + (ch / 8) * (WM * 128) +
          hopper::swizzle<128>(r * 128 + (ch % 8) * 16));
      bf16* dst = c + (long long)row * p.cols + col;
      if (kTma) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const bf16* h = reinterpret_cast<const bf16*>(&v);
        for (int e = 0; e < 8 && col + e < p.cols; ++e) dst[e] = h[e];
      }
    }
  }
  if (tw == 0) hopper::bulk_wait_all();
}

// Launch one body: the maps of its operands (TMA route), one block an SM.
template <int kOp, int BM, int BN, bool kTma>
int launch(const Args& p, cudaStream_t stream) {
  using P = Plan<BM, BN, kTma>;
  auto* fn = grouped_gemm_bf16_kernel<kOp, BM, BN, kTma>;
  const int smem = P::smem(p.experts);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;  // E too large
  static bool configured = false;            // once, before any capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap ta{}, tb{}, tout{};
  if (kTma) {
    const int E = p.experts;
    bool ok;
    if (kOp == kWgrad)
      ok = hopper::bf16_matrix_map(&ta, p.a, 1, p.rows, p.kdim, kBK) &&
           hopper::bf16_matrix_map(&tb, p.b, 1, p.rows, p.cols, kBK) &&
           hopper::bf16_matrix_map(&tout, p.c, E, p.kdim, p.cols, BM / 2);
    else
      ok = hopper::bf16_matrix_map(&ta, p.a, 1, p.rows, p.kred, BM) &&
           (kOp == kFwd
                ? hopper::bf16_matrix_map(&tb, p.b, E, p.kred, p.cols, kBK)
                : hopper::bf16_matrix_map(&tb, p.b, E, p.cols, p.kred, BN)) &&
           hopper::bf16_matrix_map(&tout, p.c, 1, p.rows, p.cols, BM / 2);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  fn<<<sms, kThreads, smem, stream>>>(ta, tb, tout, p);
  return (int)cudaGetLastError();
}

// The tile of a launch.  Forward and dgrad: 128 rows (their rows are
// ragged), 256 columns wherever the output is wider than 128 (at M =
// 1408, six tiles of 256 beat eleven of 128 though the last is half
// empty: a wider tile reads fewer bytes from L2 a product).  Weight
// gradient: tile_edge of dw's columns, and where that is 128, tile_edge
// of its rows (K = 2048, M = 1408: 256 x 128).  At most 128 x 256 (128 f32
// accumulators a thread).  The guarded route: 128 x 128.
inline void tile_of(int op, int route, int kdim, int cols, int* bm,
                    int* bn) {
  *bm = 128;
  *bn = 128;
  if (!route) return;
  if (op != kWgrad) {
    *bn = cols > 128 ? 256 : 128;
    return;
  }
  *bn = tile_edge(cols);
  if (*bn == 128) *bm = tile_edge(kdim);
}

// TMA route: every row a multiple of 16 bytes and every base on a 16-byte
// boundary; else the guarded element loader.
template <int kOp>
int run(const Args& p, bool tma, cudaStream_t stream) {
  int bm, bn;
  tile_of(kOp, tma, p.kdim, p.cols, &bm, &bn);
  if (!tma) return launch<kOp, 128, 128, false>(p, stream);
  if (bn == 256) return launch<kOp, 128, 256, true>(p, stream);
  if constexpr (kOp == kWgrad)
    if (bm == 256) return launch<kOp, 256, 128, true>(p, stream);
  return launch<kOp, 128, 128, true>(p, stream);
}

}  // namespace tc

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The float32 forward / input gradient: grid (column tile, ceil(rows /
// 128) + E row tiles of the schedule), blocks past the list's end exit.
template <bool kTransW, bool kVec>
int launch_f32(const void* x, const void* w, const int* offsets, void* out,
               int rows, int k_in, int m_out, int experts,
               cudaStream_t stream) {
  auto* fn = f32r::moe_gemm_f32_kernel<kTransW, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, f32r::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m_out + 127) / 128, (rows + kBM - 1) / kBM + experts);
  fn<<<grid, f32r::kThreads, f32r::kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), offsets,
      static_cast<float*>(out), rows, k_in, m_out, experts);
  return (int)cudaGetLastError();
}

// The bf16 bodies' route: TMA where every row is a multiple of 16 bytes
// and every base on a 16-byte boundary (and there are rows to map), else
// the guarded element loader.
bool tma_route(const void* a, const void* b, const void* c, int rows, int k,
               int m) {
  return rows > 0 && aligned16(a) && aligned16(b) && aligned16(c) &&
         k % 8 == 0 && m % 8 == 0;
}

int launch_gemm_f32(const void* x, const void* w, const int* offsets,
                    void* out, int rows, int k_in, int m_out, int experts,
                    int trans_w, cudaStream_t stream) {
  const bool vec = aligned16(x) && aligned16(w) && aligned16(out) &&
                   k_in % 4 == 0 && (trans_w || m_out % 4 == 0);
  auto* fn = trans_w ? (vec ? launch_f32<true, true> : launch_f32<true, false>)
                     : (vec ? launch_f32<false, true>
                            : launch_f32<false, false>);
  return fn(x, w, offsets, out, rows, k_in, m_out, experts, stream);
}

// The f32 weight gradient's grid: (dw tiles, ceil(rows / kChunk) + E
// chunk slots); flags [E, dw tiles] int32, zero on entry.
int launch_wgrad_f32(const void* x, const void* dy, const int* offsets,
                     void* dw, int* flags, int rows, int k_dim, int m_dim,
                     int experts, cudaStream_t stream) {
  const bool vec = aligned16(x) && aligned16(dy) && aligned16(dw) &&
                   k_dim % 4 == 0 && m_dim % 4 == 0;
  auto* fn = vec ? wg::moe_gemm_wgrad_kernel<true>
                 : wg::moe_gemm_wgrad_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((m_dim + wg::kTile - 1) / wg::kTile) *
                      ((k_dim + wg::kTile - 1) / wg::kTile),
                  (rows + wg::kChunk - 1) / wg::kChunk + experts);
  fn<<<grid, wg::kThreads, wg::kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), offsets,
      static_cast<float*>(dw), flags, rows, k_dim, m_dim, experts);
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
    return launch_gemm_f32(x, w, off, out, rows, k_in, m_out, experts,
                           trans_w, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const tc::Args p{off, nullptr, static_cast<const bf16*>(x),
                   static_cast<const bf16*>(w), static_cast<bf16*>(out),
                   rows, k_in, m_out, 0, experts};
  const bool tma = tma_route(x, w, out, rows, k_in, m_out);
  return trans_w ? tc::run<tc::kDgrad>(p, tma, s)
                 : tc::run<tc::kFwd>(p, tma, s);
}

// dw [E, k, m] = per expert x[rows of e]^T @ dy[rows of e]; x [rows, k],
// dy [rows, m].  dtype: 0 = float32, 1 = bfloat16.  flags: float32 only,
// [E, ceil(k / 128) * ceil(m / 128)] int32, all 0 on entry (the chunks'
// order of addition; left at each tile's chunk count).
extern "C" int moe_gemm_wgrad(const void* x, const void* dy,
                              const void* offsets, void* dw, void* flags,
                              int rows, int k, int m, int experts, int dtype,
                              void* stream) {
  if (rows < 0 || k <= 0 || m <= 0 || experts <= 0)
    return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && flags != nullptr)
    return launch_wgrad_f32(x, dy, off, dw, static_cast<int*>(flags), rows,
                            k, m, experts, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bool tma = tma_route(x, dy, dw, rows, k, m);
  if (tma && flags == nullptr) return (int)cudaErrorInvalidValue;
  const tc::Args p{off, static_cast<int*>(flags), static_cast<const bf16*>(x),
                   static_cast<const bf16*>(dy), static_cast<bf16*>(dw), rows,
                   0, m, k, experts};
  return tc::run<tc::kWgrad>(p, tma, s);
}

// 1 if the bf16 bodies take the TMA route for these operands (a [rows, k],
// and the others' rows of k or m elements), 0 for the guarded loader.
extern "C" int moe_gemm_route(const void* a, const void* b, const void* c,
                              int rows, int k, int m) {
  return tma_route(a, b, c, rows, k, m) ? 1 : 0;
}

// The launch plan of the bf16 body for `op` (0 forward, 1 input gradient,
// 2 weight gradient) on `route` (1 TMA, 0 guarded) with dw rows `kdim`
// (the weight gradient's K; any other op ignores it), output columns
// `cols` and `experts` into out[6]: rows and columns of a tile, reduction
// depth of a stage, stages, warps, dynamic shared bytes (the groups'
// table included).  kernels/moe_gemm.py gemm_plan mirrors it.
extern "C" int moe_gemm_plan(int op, int route, int kdim, int cols,
                             int experts, int* out) {
  if (op < 0 || op > 2 || kdim <= 0 || cols <= 0 || experts <= 0) return -1;
  int bm, bn;
  tc::tile_of(op, route, kdim, cols, &bm, &bn);
  int stages, smem;
  if (!route) {
    stages = tc::Plan<128, 128, false>::NS;
    smem = tc::Plan<128, 128, false>::smem(experts);
  } else if (bn == 256) {
    stages = tc::Plan<128, 256, true>::NS;
    smem = tc::Plan<128, 256, true>::smem(experts);
  } else if (bm == 256) {
    stages = tc::Plan<256, 128, true>::NS;
    smem = tc::Plan<256, 128, true>::smem(experts);
  } else {
    stages = tc::Plan<128, 128, true>::NS;
    smem = tc::Plan<128, 128, true>::smem(experts);
  }
  if (smem > tc::kSmemLimit) return -1;
  const int p[6] = {bm, bn, tc::kBK, stages, tc::kThreads / 32, smem};
  for (int i = 0; i < 6; ++i) out[i] = p[i];
  return 0;
}
