// Mamba2 SSD chunked scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   * ssd_chunked_scan  <- _ssd_kernel  (:27, pallas_call :94)
//
// What it computes (arXiv:2405.21060 §6), per batch row b and head h, over
// chunks of L positions, with a_t = dt_t * A[h] and La its inclusive
// cumsum within the chunk:
//   intra:  y[t] += sum_{s<=t} (C_t . B_s) exp(La_t - La_s) dt_s x_s
//   inter:  y[t] += exp(La_t) C_t . h             (h: state at chunk start)
//   state:  h <- exp(La_L) h + sum_s exp(La_L - La_s) dt_s (x_s ⊗ B_s)
// returning y [B,S,H,P] (x's dtype) and the final state h [B,H,P,N] f32;
// the scan starts from h0 (or 0).  B/C carry G groups, broadcast onto the
// heads (head h reads group h / (H / G)).
//
// Layout.  x [B,S,H,P] and y as x; dt [B,S,H] f32; A [H] f32; Bm, Cm
// [B,S,G,N] (x's dtype); h0, h_out [B,H,P,N] f32; all contiguous.  A
// workspace of ssd_scan_workspace() floats holds La [B,H,S], the chunks'
// total decays [B,H,nc] and the chunk states [B,H,nc,P,N].
//
// Bound.  Each input is read once and each output written once:
//   (B*S*H*(2P + 1) + 2*B*S*G*N) * itemsize + 8*B*H*P*N bytes (zamba2,
//   S = 1024, bf16: 18.4 MB, 5.5 us at 3.35 TB/s); the work, about
//   B*H*(S*L*(N + P) + 4*S*P*N) flops, is below the bf16 peak's share of
//   those bytes: bytes bound the kernel on this card.
//
// What the first design lost (5.27 ms at zamba2 S = 1024, chunk 256,
// NVIDIA H100 80GB HBM3, 700 W): one block per (head, batch row) walked
// the chunks in order (64 blocks on 132 SMs), every product was a scalar
// f32 FMA out of shared memory, and the state update read each chunk's B
// and x a second time.
//
// Design: the SSD decomposition with the chunk axis parallel.
//   1. ssd_chunk_state_kernel, grid (chunk x P slice, head, batch row),
//      256 threads, the P slices chosen so that some two blocks per SM
//      run: La by a block scan of dt * A, written out with exp(La_L); the
//      chunk state S_c = sum_s exp(La_L - La_s) dt_s x_s ⊗ B_s [P,N] over
//      64-row tiles in a 2-stage cp.async ring.  The state check is 1e-3
//      in both types and bf16 weights alone would miss it, so bf16 splits
//      the f32 weighted x into hi + lo bf16 tiles and runs S^T = (w x)^T B
//      on mma.sync (both operands by ldmatrix.trans); f32 runs it on CUDA
//      cores, each thread a column n and P*N/256 consecutive rows p.
//   2. ssd_state_pass_kernel, grid (P*N slices, head x batch row): the
//      short recurrence h <- exp(La_L) h + S_c over the chunks, writing the
//      state at each chunk's start (bf16: as hi and lo planes, ready for
//      the tensor cores) and h_final.
//   3. ssd_chunk_output_kernel, grid (64-row target tile, chunk, head x
//      batch row), 4 warps of 16 target rows each: the inter term C . h^T,
//      then for each 64-row source tile on or below the diagonal the
//      scores C . B^T, weighted by exp(La_t - La_s) dt_s where s <= t (exp
//      is never taken above the diagonal; La in log2 units, ex2.approx)
//      and multiplied into x.  bf16:
//      every product on mma.sync.m16n8k16 tensor cores with f32
//      accumulation, tiles staged by 16-byte cp.async into XOR-swizzled
//      shared memory and read by ldmatrix (x through ldmatrix.trans);
//      the f32 state and the f32 weighted scores enter their products as
//      hi + lo pairs of bf16 (~2^-16 relative; rounding the scores to
//      bf16 alone, as flash attention rounds P, missed y's 2e-2 by 5x
//      where slow decays sum hundreds of sources).  f32: the
//      same kernel, tiles and fragment layout, with the products as f32
//      FMAs on CUDA cores (the scores pass through a per-warp tile).
//      Each warp's 16 rows of y go out through shared memory as 16-byte
//      stores.
//   P and N below 16 are zero-padded to one mma tile.
//
// Times (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700 W, median of
// 20, L2 flushed, bf16, chunk 256): zamba2 (H = 64, P = N = 64) 0.08 ms
// at S = 1024 and 0.06 ms at S = 512; mamba2 (H = 24, P = 64, N = 128)
// 0.07 / 0.06 ms; the plain chunked version 0.4-1.2 ms.
//
// ptxas (-Xptxas -v, sm_90a; no stack, no spills): ssd_chunk_state_kernel
// 101 registers (bf16) / 76 (f32); ssd_state_pass_kernel 32;
// ssd_chunk_output_kernel for P padded to 16 / 32 / 64 / 128: bf16 87 /
// 128 / 135 / 178, f32 96 / 96 / 128 / 161.  Dynamic shared memory at
// zamba2's shape: 58 KB (chunk states, two P slices) and 42 KB (outputs).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
// The entry point returns cudaGetLastError() after its launches (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using tiles::bf16;

constexpr int kThreads = 256;          // chunk-state and state-pass blocks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 32;            // state outputs per thread
constexpr int kStateRows = 64;         // source rows staged per step (1.)
constexpr int kOutWarps = 4;
constexpr int kOutThreads = 32 * kOutWarps;
constexpr int kBT = 16 * kOutWarps;    // target rows per output block
constexpr int kBS = 64;                // source rows per step (3.)
constexpr int kSmemLimit = 220 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<bf16> {
  static constexpr bool value = true;
};

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

struct Dims {
  int seq, heads, head_dim, groups, state, chunk;
};

// P and N padded to whole mma tiles (both are powers of two).
__host__ __device__ inline int pad16(int v) { return v < 16 ? 16 : v; }
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__host__ inline long long round4_ll(long long v) { return (v + 3) & ~3LL; }

// Stages of the chunk-state kernel's ring: all of a 256-row chunk's tiles
// in flight for bf16, two for f32 (whose tiles are twice the bytes).
__host__ __device__ constexpr int ring_stages(size_t elem) {
  return elem == 2 ? 4 : 2;
}

// Shared memory of the chunk-state kernel (bytes): La and the weights,
// then the ring of x [64][P / psplit] and B [64][N] tiles (padded to 16
// columns; f32 rows by 4 more), and for bf16 the weighted x's hi and lo.
__host__ inline size_t state_smem_bytes(int P, int N, int L, int psplit,
                                        size_t elem) {
  const size_t PSP = pad16(P / psplit), NP = pad16(N);
  const size_t pad = elem == 2 ? 0 : 4;
  const size_t tiles = ring_stages(elem) * kStateRows * (PSP + NP + 2 * pad) +
                       (elem == 2 ? 2 * kStateRows * PSP : 0);
  return sizeof(float) * 2 * (size_t)round4(L) + elem * tiles;
}

// Shared memory of the output kernel (bytes) for an element of `elem`
// bytes: La and dt, the C tile, source stage 0 (B and x tiles), then the
// state (bf16: hi and lo, in a region that source stage 1 reuses), and for
// f32 the per-warp score tiles.
__host__ __device__ inline size_t out_smem_bytes(int P, int N, int L,
                                                 int elem) {
  const size_t PP = pad16(P), NP = pad16(N);
  const size_t ldn = elem == 2 ? NP : NP + 4, ldp = elem == 2 ? PP : PP + 4;
  const size_t src = kBS * (ldn + ldp);
  const size_t h = elem == 2 ? 2 * PP * NP : PP * ldn;
  const size_t scores = elem == 2 ? 0 : 4 * kBT * (kBS + 4);
  return 2 * sizeof(float) * (size_t)round4(L) +
         elem * (kBT * ldn + src + (elem == 2 && src > h ? src : h)) + scores;
}

// In-place inclusive prefix sum of v[0..n) by the whole block.
__device__ void block_inclusive_scan(float* v, int n, float* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * seg, n), hi = min(lo + seg, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += v[i];
    v[i] = run;
  }
  float inc = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_sums[lane] : 0.f;
    for (int o = 1; o < kWarps; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += up;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const float offset = inc - run + (warp > 0 ? warp_sums[warp - 1] : 0.f);
  for (int i = lo; i < hi; ++i) v[i] += offset;
  __syncthreads();
}

// Element offset of 8-element chunk c of row r in a swizzled bf16 tile of
// `width` elements per row (a power of two, at least 16): tiles::Swizzle
// with the width known only at run time, by shifts.
__device__ __forceinline__ int swz(int r, int c, int width) {
  const int lw = __ffs(width) - 1;
  const int lc = lw - 3;                   // log2 of the chunks per row
  const int lp = lc >= 3 ? 0 : 3 - lc;     // log2 of the rows per line
  const int mask = (lc >= 3 ? 8 : 1 << lc) - 1;
  return (r << lw) + ((c ^ ((r >> lp) & mask)) << 3);
}

// Offset of the 16-byte chunk c of row r in a tile of `wp` padded columns:
// swizzled bf16, or f32 rows of wp + 4.
template <typename T>
__device__ __forceinline__ int chunk_at(int r, int c, int wp) {
  if constexpr (IsBf16<T>::value)
    return swz(r, c, wp);
  else
    return r * (wp + 4) + c * 4;
}

// Stage rows [0, rows) of a global matrix (rows `step` elements apart,
// `width` valid columns) into a tile of `tile_rows` x `wp`; other rows
// and columns are 0.  vec: whole 16-byte chunks by cp.async (the caller
// commits and waits), else element by element.
template <typename T, int kNT>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      long long step, int rows, int tile_rows,
                                      int width, int wp, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = wp / E;
  for (int i = threadIdx.x; i < tile_rows * chunks; i += kNT) {
    const int r = i / chunks, c = i - r * chunks, col = c * E;
    T* to = dst + chunk_at<T>(r, c, wp);
    if (vec) {
      const bool ok = r < rows && col < width;
      tiles::cp_async_16(to, ok ? src + r * step + col : src, ok);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k)
        to[k] = (r < rows && col + k < width) ? src[r * step + col + k]
                                              : from_f32<T>(0.f);
    }
  }
}

// Two floats as packed bf16 pairs hi and lo with hi + lo = (a, b) to
// ~2^-16 relative: f32 operands on bf16 tensor cores.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = tiles::pack_bf16(a - __low2float(h), b - __high2float(h));
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------

// Grid (chunk x P slice, head, batch row).  Each block takes P / psplit
// rows of the chunk's state; the first slice also writes La and exp(La_L).
// bf16: S^T = (w x)^T B on tensor cores, the f32 weighted x as hi + lo
// bf16 tiles; f32: CUDA cores, the weight riding on B.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       float* __restrict__ la_out,
                       float* __restrict__ decay_out,
                       float* __restrict__ states, const Dims d, int psplit,
                       int vec) {
  constexpr bool kTC = IsBf16<T>::value;
  constexpr int kRing = ring_stages(sizeof(T));
  extern __shared__ __align__(128) float smem[];
  __shared__ float warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int c = blockIdx.x / psplit, pq = blockIdx.x % psplit;
  const int head = blockIdx.y, b = blockIdx.z;
  const int S = d.seq, H = d.heads, P = d.head_dim, N = d.state;
  const int L = d.chunk, G = d.groups, nc = S / L;
  const int PS = P / psplit, pbase = pq * PS;
  const int PSP = pad16(PS), NP = pad16(N);
  // x [64][PSP] and B [64][NP] tiles: swizzled bf16, or f32 rows padded by 4
  const int ldx = kTC ? PSP : PSP + 4, ldb = kTC ? NP : NP + 4;
  const int g = head / (H / G);
  float* la = smem;                              // [L]
  float* w = la + round4(L);                     // [L]: dt, then weights
  T* tiles0 = reinterpret_cast<T*>(w + round4(L));
  const int stage_elems = kStateRows * (ldx + ldb);
  T* xhi = tiles0 + kRing * stage_elems;         // bf16: [64][PSP] each
  T* xlo = xhi + kStateRows * PSP;

  const long long pos0 = (long long)b * S + (long long)c * L;
  const long long bh = (long long)b * H + head;
  const long long x_row = (long long)H * P, bc_row = (long long)G * N;
  const T* xb = x + pos0 * x_row + (long long)head * P + pbase;
  const T* bb = Bm + pos0 * bc_row + (long long)g * N;
  const int n_tiles = (L + kStateRows - 1) / kStateRows;
  auto load_tile = [&](int it) {
    const int s1 = it * kStateRows, rows1 = min(kStateRows, L - s1);
    T* t1 = tiles0 + (it % kRing) * stage_elems;
    stage<T, kThreads>(t1, xb + s1 * x_row, x_row, rows1, kStateRows, PS, PSP,
                       vec);
    stage<T, kThreads>(t1 + kStateRows * ldx, bb + s1 * bc_row, bc_row, rows1,
                       kStateRows, N, NP, vec);
  };
  // the first tiles' copies fly while La is scanned
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    tiles::cp_async_commit();
  }

  const float a_h = A[head];
  for (int i = tid; i < L; i += kThreads) {
    const float dv = dt[(pos0 + i) * H + head];
    w[i] = dv;
    la[i] = dv * a_h;
  }
  __syncthreads();
  block_inclusive_scan(la, L, warp_sums);
  const float last = la[L - 1];
  for (int i = tid; i < L; i += kThreads) {
    if (pq == 0) la_out[bh * S + (long long)c * L + i] = la[i];
    w[i] = expf(last - la[i]) * w[i];
  }
  if (tid == 0 && pq == 0) decay_out[bh * nc + c] = expf(last);
  float* st = states + (bh * nc + c) * P * N + (long long)pbase * N;

  if constexpr (kTC) {
    // 16 x 16 output items (m16 rows p, two n8 column blocks), up to four
    // per warp (P * N <= 8192)
    const int lane = tid & 31, warp = tid >> 5;
    const int mt = PSP / 16, items = mt * (NP / 16);
    float acc[4][2][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        acc[k][nb][0] = acc[k][nb][1] = acc[k][nb][2] = acc[k][nb][3] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      tiles::cp_async_wait<kRing - 2>();
      __syncthreads();               // tile it landed; tile it - 1 used
      if (it + kRing - 1 < n_tiles) load_tile(it + kRing - 1);
      tiles::cp_async_commit();
      const int s0 = it * kStateRows, rows = min(kStateRows, L - s0);
      const T* xs = tiles0 + (it % kRing) * stage_elems;
      const T* bs = xs + kStateRows * ldx;
      // the weighted x as hi + lo tiles, 8 elements (16 bytes) a step; the
      // staged tile is 0 past the chunk's rows and past PS
      const int cpr = PSP >> 3;
      for (int i = tid; i < kStateRows * cpr; i += kThreads) {
        const int r = i / cpr, c = i - r * cpr;
        const float wr = w[s0 + min(r, rows - 1)];
        const uint4 u = *reinterpret_cast<const uint4*>(xs + swz(r, c, PSP));
        const uint32_t words[4] = {u.x, u.y, u.z, u.w};
        float v[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 h2 =
              *reinterpret_cast<const __nv_bfloat162*>(&words[q]);
          v[2 * q] = wr * __low2float(h2);
          v[2 * q + 1] = wr * __high2float(h2);
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_bf16(v[2 * q], v[2 * q + 1], hi[q], lo[q]);
        const int at = swz(r, c, PSP);
        *reinterpret_cast<uint4*>(xhi + at) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(xlo + at) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kStateRows / 16; ++kk) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = warp + kWarps * k;
          if (q >= items) continue;
          const int m0 = (q % mt) * 16, n0 = (q / mt) * 16;
          uint32_t ah[4], al[4], bf[4];
          const int ar = kk * 16 + (lane >> 4) * 8 + (lane & 7);
          const int ac = (m0 >> 3) + ((lane >> 3) & 1);
          tiles::ldmatrix_x4_trans(ah, xhi + swz(ar, ac, PSP));
          tiles::ldmatrix_x4_trans(al, xlo + swz(ar, ac, PSP));
          tiles::ldmatrix_x4_trans(
              bf, bs + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                           (n0 >> 3) + (lane >> 4), NP));
          tiles::mma_bf16(acc[k][0], ah, bf[0], bf[1]);
          tiles::mma_bf16(acc[k][1], ah, bf[2], bf[3]);
          tiles::mma_bf16(acc[k][0], al, bf[0], bf[1]);
          tiles::mma_bf16(acc[k][1], al, bf[2], bf[3]);
        }
      }
    }
    tiles::cp_async_wait<0>();
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = warp + kWarps * k;
      if (q >= items) continue;
      const int m0 = (q % mt) * 16, n0 = (q / mt) * 16;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = m0 + gq + (e >> 1) * 8;
          const int n = n0 + nb * 8 + 2 * tq + (e & 1);
          if (p < PS && n < N) st[(long long)p * N + n] = acc[k][nb][e];
        }
    }
  } else {
    // thread: column n, rows p0 .. p0 + J - 1 of the slice
    const int J = max(1, PS * N / kThreads);
    const int n = tid % N, p0 = (tid / N) * J;
    const bool active = p0 < PS;
    float acc[kMaxAcc];
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      tiles::cp_async_wait<kRing - 2>();
      __syncthreads();               // tile it (and the weights) for all
      if (it + kRing - 1 < n_tiles)  // ... and tile it - 1 consumed
        load_tile(it + kRing - 1);
      tiles::cp_async_commit();
      if (!active) continue;
      const int s0 = it * kStateRows, rows = min(kStateRows, L - s0);
      const T* xs = tiles0 + (it % kRing) * stage_elems;
      const T* bs = xs + kStateRows * ldx;
      // S[p][n] += sum_s x_s[p] (w_s B_s[n]): the f32 weight rides on B
      for (int r = 0; r < rows; ++r) {
        const float bv = w[s0 + r] * to_f32(bs[r * ldb + n]);
        const T* xr = xs + r * ldx + p0;
        if (J >= 4) {
#pragma unroll
          for (int j = 0; j < kMaxAcc; j += 4) {
            if (j < J) {
              const float4 v = *reinterpret_cast<const float4*>(xr + j);
              acc[j] = fmaf(v.x, bv, acc[j]);
              acc[j + 1] = fmaf(v.y, bv, acc[j + 1]);
              acc[j + 2] = fmaf(v.z, bv, acc[j + 2]);
              acc[j + 3] = fmaf(v.w, bv, acc[j + 3]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < J) acc[j] = fmaf(to_f32(xr[j]), bv, acc[j]);
        }
      }
    }
    tiles::cp_async_wait<0>();
    if (!active) return;
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j)
      if (j < J) st[(long long)(p0 + j) * N + n] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------

// h_start[c] for every chunk (f32, or with kSplit a hi plane and a lo
// plane of bf16 per chunk, the tensor-core route's operands) and h_final.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const float* __restrict__ decay,
                      const float* __restrict__ states,
                      float* __restrict__ hstart,
                      const float* __restrict__ h0, float* __restrict__ h_out,
                      int nc, int pn) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const long long bh = blockIdx.y;
  if (e >= pn) return;
  float h = h0 ? h0[bh * pn + e] : 0.f;
  const float* dec = decay + bh * nc;
  for (int c = 0; c < nc; ++c) {
    const long long slot = (bh * nc + c) * pn;
    const float s = states[slot + e];
    if (kSplit) {
      bf16* plane = reinterpret_cast<bf16*>(hstart + slot);
      const bf16 hi = __float2bfloat16(h);
      plane[e] = hi;
      plane[pn + e] = __float2bfloat16(h - __bfloat162float(hi));
    } else {
      hstart[slot + e] = h;
    }
    h = fmaf(dec[c], h, s);
  }
  h_out[bh * pn + e] = h;
}

// ---------------------------------------------------------------------------
// 3. outputs
// ---------------------------------------------------------------------------

// acc[nb] (16 rows from a_row0 of tile a  x  8 columns nb*8.. of the
// output) += a . b^T over the kdim (padded, a multiple of 16) columns of
// both tiles; b holds one row per output column.  The mma.sync fragment
// layout in both types.
template <typename T, int NBLK>
__device__ __forceinline__ void product_nt(float (&acc)[NBLK][4], const T* a,
                                           int a_row0, const T* b, int kdim) {
  const int lane = threadIdx.x & 31;
  if constexpr (IsBf16<T>::value) {
    for (int kk = 0; kk < kdim / 16; ++kk) {
      uint32_t af[4];
      tiles::ldmatrix_x4(af, a + swz(a_row0 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     kk * 2 + (lane >> 4), kdim));
#pragma unroll
      for (int n2 = 0; n2 < NBLK / 2; ++n2) {
        uint32_t bf[4];
        tiles::ldmatrix_x4(bf, b + swz(n2 * 16 + (lane & 7) + (lane >> 4) * 8,
                                       kk * 2 + ((lane >> 3) & 1), kdim));
        tiles::mma_bf16(acc[2 * n2], af, bf[0], bf[1]);
        tiles::mma_bf16(acc[2 * n2 + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    const int gq = lane >> 2, tq = lane & 3, ld = kdim + 4;
    const float* a0 = a + (a_row0 + gq) * ld;
    const float* a1 = a0 + 8 * ld;
    for (int k = 0; k < kdim; k += 4) {
      const float4 u0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 u1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
      for (int nb = 0; nb < NBLK; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              b + (nb * 8 + 2 * tq + j) * ld + k);
          acc[nb][j] += u0.x * v.x + u0.y * v.y + u0.z * v.z + u0.w * v.w;
          acc[nb][2 + j] +=
              u1.x * v.x + u1.y * v.y + u1.z * v.z + u1.w * v.w;
        }
      }
    }
  }
}

// Grid (target tile, chunk, head x batch row).  PP: P padded to 16.
template <typename T, int PP>
__global__ void __launch_bounds__(kOutThreads)
ssd_chunk_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const float* __restrict__ la_g,
                        const float* __restrict__ hstart, T* __restrict__ y,
                        const Dims d, int vec, int vec_h) {
  constexpr bool kTC = IsBf16<T>::value;
  constexpr int NB = PP / 8;               // 8-column blocks of y
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int H = d.heads, P = d.head_dim, N = d.state, G = d.groups;
  const int L = d.chunk, S = d.seq, nc = S / L;
  const int NP = pad16(N);
  const int t0 = blockIdx.x * kBT, c = blockIdx.y;
  const long long bh = blockIdx.z;
  const int b = (int)(bh / H), head = (int)(bh % H);
  const int g = head / (H / G);
  const int src_end = min(L, t0 + kBT);    // sources any target row sees

  const long long pos0 = (long long)b * S + (long long)c * L;
  const long long x_row = (long long)H * P, bc_row = (long long)G * N;
  const T* xb = x + pos0 * x_row + (long long)head * P;
  const T* bb = Bm + pos0 * bc_row + (long long)g * N;
  const T* cb = Cm + pos0 * bc_row + (long long)g * N;
  float* la = reinterpret_cast<float*>(smem_raw);   // [L], log2 units
  float* dts = la + round4(L);                      // [L]
  // the C tile, source stage 0, then the state; bf16 reuses the state's
  // region (grown to a stage if smaller) as source stage 1 once the inter
  // term is done (out_smem_bytes); f32, whose tiles are twice the bytes,
  // keeps one stage
  const int ldn = kTC ? NP : NP + 4, ldp = kTC ? PP : PP + 4;
  const int src_elems = kBS * (ldn + ldp);                 // B, then x
  T* cs = reinterpret_cast<T*>(dts + round4(L));           // [kBT][ldn]
  T* src0 = cs + kBT * ldn;
  T* hh = src0 + src_elems;                                // [PP][ldn]
  T* hl = hh + PP * NP;                                    // bf16: lo
  const int h_elems = kTC ? 2 * PP * NP : PP * ldn;
  float* scs = reinterpret_cast<float*>(                   // f32: scores
      hh + (kTC && src_elems > h_elems ? src_elems : h_elems));
  auto bsrc = [&](int st) { return st ? hh : src0; };
  auto xsrc = [&](int st) { return (st ? hh : src0) + kBS * ldn; };
  auto load_src = [&](int s0, int st) {
    stage<T, kOutThreads>(bsrc(st), bb + s0 * bc_row, bc_row,
                          min(kBS, L - s0), kBS, N, NP, vec);
    stage<T, kOutThreads>(xsrc(st), xb + s0 * x_row, x_row, min(kBS, L - s0),
                          kBS, P, PP, vec);
  };

  stage<T, kOutThreads>(cs, cb + t0 * bc_row, bc_row, min(kBT, L - t0), kBT,
                        N, NP, vec);
  load_src(0, 0);
  tiles::cp_async_commit();
  // the state at the chunk's start: hi and lo bf16 planes, or f32
  const float* hslot = hstart + (bh * nc + c) * P * N;
  if constexpr (kTC) {
    const bf16* planes = reinterpret_cast<const bf16*>(hslot);
    stage<T, kOutThreads>(hh, planes, N, P, PP, N, NP, vec_h);
    stage<T, kOutThreads>(hl, planes + P * N, N, P, PP, N, NP, vec_h);
  } else {
    stage<T, kOutThreads>(hh, hslot, N, P, PP, N, NP, vec_h);
  }
  tiles::cp_async_commit();
  // La and dt of the sources, four loads in flight per thread
  const float* lab = la_g + bh * S + (long long)c * L;
  for (int i0 = 0; i0 < src_end; i0 += 4 * kOutThreads) {
    float lv[4], dv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kOutThreads + threadIdx.x;
      lv[q] = i < src_end ? lab[i] : 0.f;
      dv[q] = i < src_end ? dt[(pos0 + i) * H + head] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kOutThreads + threadIdx.x;
      if (i < src_end) la[i] = lv[q] * kLog2e, dts[i] = dv[q];
    }
  }
  tiles::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;                // the warp's rows in the tile
  const int row0 = t0 + wr + gq;           // rows row0 and row0 + 8

  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  // La of this thread's two target rows
  const float lt[2] = {row0 < L ? la[row0] : 0.f,
                       row0 + 8 < L ? la[row0 + 8] : 0.f};
  // inter term: exp(La_t) C_t . h
  product_nt<T, NB>(acc, cs, wr, hh, NP);
  if constexpr (kTC) product_nt<T, NB>(acc, cs, wr, hl, NP);
  {
    const float e0 = row0 < L ? tiles::exp2_approx(la[row0]) : 0.f;
    const float e1 = row0 + 8 < L ? tiles::exp2_approx(la[row0 + 8]) : 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      acc[nb][0] *= e0;
      acc[nb][1] *= e0;
      acc[nb][2] *= e1;
      acc[nb][3] *= e1;
    }
  }

  // intra term: source tiles on and below the diagonal, the next one's
  // copies in flight while this one is multiplied
  for (int it = 0, s0 = 0; s0 < src_end; ++it, s0 += kBS) {
    if constexpr (kTC) {
      if (it > 0) tiles::cp_async_wait<0>();   // tile it arrived
      __syncthreads();    // ... for all; the other stage (h for it = 0) free
      if (s0 + kBS < src_end) load_src(s0 + kBS, (it + 1) & 1);
      tiles::cp_async_commit();
    } else if (it > 0) {
      __syncthreads();                         // every warp done with it - 1
      load_src(s0, 0);
      tiles::cp_async_commit();
      tiles::cp_async_wait<0>();
      __syncthreads();
    }
    const T* bs = bsrc(kTC ? it & 1 : 0);
    const T* xs = xsrc(kTC ? it & 1 : 0);
    if (s0 > t0 + wr + 15) continue;       // the warp's rows precede s0
    float sc[kBS / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBS / 8; ++nb)
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    product_nt<T, kBS / 8>(sc, cs, wr, bs, NP);
#pragma unroll
    for (int nb = 0; nb < kBS / 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + nb * 8 + 2 * tq + j;
        const float ls = s < src_end ? la[s] : 0.f;
        const float ds = s < src_end ? dts[s] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = row0 + r * 8;
          float& v = sc[nb][2 * r + j];
          v = (s <= t && t < L) ? v * tiles::exp2_approx(lt[r] - ls) * ds
                                : 0.f;
        }
      }
    }
    if constexpr (kTC) {
      // the weighted scores' C fragments are the A fragments of 16-source
      // slices, as a hi + lo pair of bf16; x read through ldmatrix.trans
#pragma unroll
      for (int k2 = 0; k2 < kBS / 16; ++k2) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* f = &sc[2 * k2 + (q >> 1)][(q & 1) * 2];
          split_bf16(f[0], f[1], hi[q], lo[q]);
        }
#pragma unroll
        for (int dd = 0; dd < PP / 16; ++dd) {
          uint32_t vf[4];
          tiles::ldmatrix_x4_trans(
              vf, xs + swz(k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             dd * 2 + (lane >> 4), PP));
          tiles::mma_bf16(acc[2 * dd], hi, vf[0], vf[1]);
          tiles::mma_bf16(acc[2 * dd + 1], hi, vf[2], vf[3]);
          tiles::mma_bf16(acc[2 * dd], lo, vf[0], vf[1]);
          tiles::mma_bf16(acc[2 * dd + 1], lo, vf[2], vf[3]);
        }
      }
    } else {
      // through this warp's rows of the score tile
      constexpr int ld = kBS + 4;
#pragma unroll
      for (int nb = 0; nb < kBS / 8; ++nb) {
        float* r0 = scs + (wr + gq) * ld + nb * 8 + 2 * tq;
        r0[0] = sc[nb][0];
        r0[1] = sc[nb][1];
        r0[8 * ld] = sc[nb][2];
        r0[8 * ld + 1] = sc[nb][3];
      }
      __syncwarp();
      const float* p0 = scs + (wr + gq) * ld;
      const float* p1 = p0 + 8 * ld;
      for (int s = 0; s < kBS; ++s) {
        const float u0 = p0[s], u1 = p1[s];
        const float* xr = xs + s * (PP + 4) + 2 * tq;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const float2 v = *reinterpret_cast<const float2*>(xr + nb * 8);
          acc[nb][0] = fmaf(u0, v.x, acc[nb][0]);
          acc[nb][1] = fmaf(u0, v.y, acc[nb][1]);
          acc[nb][2] = fmaf(u1, v.x, acc[nb][2]);
          acc[nb][3] = fmaf(u1, v.y, acc[nb][3]);
        }
      }
      __syncwarp();
    }
  }

  // y rows of this tile, in x's dtype: each warp's 16 rows through shared
  // memory (source stage 0, free once every warp is done), then 16-byte
  // stores along the rows
  __syncthreads();
  T* ys = src0 + wr * ldp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* row = ys + (gq + r * 8) * ldp + 2 * tq;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      row[nb * 8] = from_f32<T>(acc[nb][2 * r]);
      row[nb * 8 + 1] = from_f32<T>(acc[nb][2 * r + 1]);
    }
  }
  __syncwarp();
  T* yb = y + (pos0 + t0 + wr) * x_row + (long long)head * P;
  const int rows_w = min(16, L - (t0 + wr));   // this warp's rows in L
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = P / E;
    for (int i = lane; i < rows_w * cpr; i += 32) {
      const int rr = i / cpr, cc = (i - rr * cpr) * E;
      *reinterpret_cast<uint4*>(yb + rr * x_row + cc) =
          *reinterpret_cast<const uint4*>(ys + rr * ldp + cc);
    }
  } else {
    for (int i = lane; i < rows_w * P; i += 32) {
      const int rr = i / P, cc = i - rr * P;
      yb[rr * x_row + cc] = ys[rr * ldp + cc];
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int PP>
int launch_output(const T* x, const float* dt, const T* Bm, const T* Cm,
                  const float* la, const float* hstart, T* y, int batch,
                  const Dims& d, int vec, int vec_h, cudaStream_t stream) {
  const size_t bytes =
      out_smem_bytes(d.head_dim, d.state, d.chunk, (int)sizeof(T));
  auto* fn = ssd_chunk_output_kernel<T, PP>;
  if (int err = set_smem((const void*)fn, bytes)) return err;
  const dim3 grid((d.chunk + kBT - 1) / kBT, d.seq / d.chunk,
                  batch * d.heads);
  fn<<<grid, kOutThreads, bytes, stream>>>(x, dt, Bm, Cm, la, hstart, y, d,
                                           vec, vec_h);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* xv, const float* dt, const float* A, const void* Bv,
           const void* Cv, const float* h0, void* yv, float* h_out,
           float* work, int batch, const Dims& d, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  T* y = static_cast<T*>(yv);
  const int S = d.seq, H = d.heads, P = d.head_dim, N = d.state;
  const int L = d.chunk, nc = S / L;
  const long long bhs = (long long)batch * H;
  float* la = work;                                   // [B,H,S]
  float* decay = la + round4_ll(bhs * S);             // [B,H,nc]
  float* states = decay + round4_ll(bhs * nc);        // [B,H,nc,P,N]
  float* hstart = states + round4_ll(bhs * nc * P * N);   // the same
  constexpr int E = 16 / (int)sizeof(T);
  const bool aligned =
      aligned16(x) && aligned16(Bm) && aligned16(Cm) && aligned16(y);
  const int vec = aligned && P % E == 0 && N % E == 0;
  const int vec_h = vec && (P * N) % 8 == 0;

  // P slices: enough blocks for two per SM where the state allows
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int psplit = 1;
  while (psplit < 8 && (long long)nc * bhs * psplit < 2LL * sms &&
         P % (2 * psplit) == 0 && (P / (2 * psplit)) * N >= kThreads)
    psplit *= 2;
  const int PS = P / psplit;
  const int vec_s = aligned && PS % E == 0 && N % E == 0;
  const size_t s_bytes = state_smem_bytes(P, N, L, psplit, sizeof(T));
  if (int err = set_smem((const void*)ssd_chunk_state_kernel<T>, s_bytes))
    return err;
  ssd_chunk_state_kernel<T><<<dim3(nc * psplit, H, batch), kThreads, s_bytes,
                              stream>>>(x, dt, A, Bm, la, decay, states, d,
                                        psplit, vec_s);
  if (int err = (int)cudaGetLastError()) return err;
  const dim3 pass_grid((P * N + kThreads - 1) / kThreads, (unsigned)bhs);
  ssd_state_pass_kernel<IsBf16<T>::value>
      <<<pass_grid, kThreads, 0, stream>>>(decay, states, hstart, h0, h_out,
                                           nc, P * N);
  if (int err = (int)cudaGetLastError()) return err;
  switch (pad16(P)) {
    case 16:
      return launch_output<T, 16>(x, dt, Bm, Cm, la, hstart, y, batch, d, vec,
                                  vec_h, stream);
    case 32:
      return launch_output<T, 32>(x, dt, Bm, Cm, la, hstart, y, batch, d, vec,
                                  vec_h, stream);
    case 64:
      return launch_output<T, 64>(x, dt, Bm, Cm, la, hstart, y, batch, d, vec,
                                  vec_h, stream);
    case 128:
      return launch_output<T, 128>(x, dt, Bm, Cm, la, hstart, y, batch, d,
                                   vec, vec_h, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shapes the kernels take: head_dim and state dividing 256, head_dim at
// most 128, head_dim * state at most 8192, and every kernel's shared
// memory within the block limit.
extern "C" int ssd_scan_supported(int head_dim, int state, int chunk) {
  if (head_dim <= 0 || state <= 0 || chunk <= 0) return 0;
  if (kThreads % head_dim || kThreads % state || head_dim > 128 ||
      head_dim * state > kThreads * kMaxAcc)
    return 0;
  const size_t limit = kSmemLimit;
  return state_smem_bytes(head_dim, state, chunk, 1, 4) <= limit &&
         state_smem_bytes(head_dim, state, chunk, 1, 2) <= limit &&
         out_smem_bytes(head_dim, state, chunk, 4) <= limit &&
         out_smem_bytes(head_dim, state, chunk, 2) <= limit;
}

// Floats of workspace one call needs: La, the chunks' decays, their
// states and the states at their starts, each region 16-byte aligned.
extern "C" long long ssd_scan_workspace(int batch, int seq, int heads,
                                        int head_dim, int state, int chunk) {
  const long long bhs = (long long)batch * heads, nc = seq / chunk;
  return round4_ll(bhs * seq) + round4_ll(bhs * nc) +
         2 * round4_ll(bhs * nc * head_dim * state);
}

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it).  h0 may be
// null (the scan starts from 0).  work: ssd_scan_workspace() floats.
extern "C" int ssd_chunked_scan(const void* x, const float* dt,
                                const float* A, const void* Bm,
                                const void* Cm, const float* h0, void* y,
                                float* h_out, float* work, int batch, int seq,
                                int heads, int head_dim, int groups,
                                int state, int chunk, int dtype,
                                void* stream) {
  if (!ssd_scan_supported(head_dim, state, chunk) || seq % chunk ||
      groups <= 0 || heads % groups || batch <= 0)
    return (int)cudaErrorInvalidValue;
  Dims d{seq, heads, head_dim, groups, state, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, h_out, work, batch, d, s);
  if (dtype == 1)
    return launch<bf16>(x, dt, A, Bm, Cm, h0, y, h_out, work, batch, d, s);
  return (int)cudaErrorInvalidValue;
}
