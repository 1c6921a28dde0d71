// Mamba2 SSD chunked scan for Hopper (sm_90a), chunk-parallel, and its
// backward.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   * ssd_chunked_scan  <- _ssd_kernel  (:27, pallas_call :94)
//   * ssd_chunked_scan_bwd: see "The backward" below
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
//      run: La by a left-to-right sum of dt * A (the plain version's
//      order), written out with exp(La_L); the
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
//      is never taken above the diagonal; ex2.approx of the difference
//      scaled to log2 units: La reaches the thousands a chunk, where
//      an ulp of each scaled La is ~5e-4)
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
// 101 registers (bf16) / 78 (f32); ssd_state_pass_kernel 32;
// ssd_chunk_output_kernel for P padded to 16 / 32 / 64 / 128: bf16 85 /
// 128 / 132 / 177, f32 96 / 96 / 128 / 162.  Dynamic shared memory at
// zamba2's shape: 58 KB (chunk states, two P slices) and 42 KB (outputs).
//
// The backward (ssd_chunked_scan_bwd).  It replaces no Pallas kernel: the
// TPU kernel has no VJP, and the JAX package trains through jax.vjp of
// the chunked form (src/repro/kernels/ssd_chunked.py:41-84, the XLA
// route).  Its gradients, derived from that form's einsums and chunk
// recurrence (g_c: the gradient of the state at chunk c's start, dS_c =
// g_{c+1}, M1[s,t] = (C_t . B_s) exp(La_t - La_s) dt_s, M2[s,t] =
// exp(La_t - La_s) dt_s (dy_t . x_s), w_s = exp(La_L - La_s), s <= t):
//   g_nc = dh, g_c = exp(La_L) g_{c+1} + sum_t exp(La_t) dy_t ⊗ C_t, dh0 = g_0
//   dx_s = sum_t M1[s,t] dy_t + w_s dt_s dS B_s
//   dB_s = sum_t M2[s,t] C_t + w_s dt_s x_s dS     (summed over a group)
//   dC_t = sum_s M2[s,t] B_s + exp(La_t) dy_t h_c  (summed over a group)
//   ddt_s = sum_t (C_t . B_s) exp(La_t - La_s) (dy_t . x_s) + w_s x_s dS B_s
//           + A rc_s,  dA = sum dt_s rc_s,  rc: the reverse cumsum of dLa
//   dLa_t = sum_s (C_t . B_s) M2[s,t] + exp(La_t) C_t h_c dy_t - dt_t ddt_t
//           (+ sum_s dt_s w_s x_s dS B_s + exp(La_L) <g_{c+1}, h_c> at L-1)
// Nothing of the forward is kept: the backward recomputes La, the decays
// and the states at the chunks' starts, so a layer holds no bytes for it
// beyond its inputs.  Four launches:
//   A. per (chunk, head x batch row), twice: La (kernel 1's left-to-right
//      sum), then S_c (as kernel 1) or E_c = sum_t exp(La_t) dy_t ⊗ C_t,
//      the reverse pass's products, in parallel over the chunks;
//   B. per P x N slice: the states at the chunks' starts (kernel 2's
//      recurrence), then the short reverse recurrence g_c = exp(La_L) g +
//      E_c: dS, dh0 and <dS, h_c> by slice;
//   C. per 64-row source tile, the tiles with the most target tiles
//      first: the state terms, then each target tile from the diagonal on
//      with C.B and dy.x computed once for the pair, giving the source
//      side (dx, dB by head, the direct ddt, held in registers over the
//      walk) and the target side (the pair's partials of dC and of La's
//      gradient, to workspace);
//   D. the ordered sums: per head, La's gradient (the targets' partials in
//      source order), its reverse cumsum by warp scans, ddt and dA; dB and
//      dC over a group's heads (dC's partials over source tiles first).
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.  Why a block per source tile, with the target side as partials:
// it gives 4x the blocks of a per-chunk design at chunk 256 (4096 at
// zamba2's train shape, 1024 at S = 1024, B = 1), and the partials (one
// [64][N] slab a tile pair, 2.5x the [B,S,H,N] slab at chunk 256) cost
// ~0.1 ms where a cluster of a chunk's source tiles, summing them
// through distributed shared memory, would hold its blocks in step
// although they carry 4, 3, 2 and 1 target tiles.
// Products (A and C): mma.sync.m16n8k8 in TF32 on tensor cores at f32
// accuracy.  An f32 operand enters as big + small (big rounded to TF32 by
// its bits, small = a - big, whose bits past TF32's the tensor cores
// drop) and a product is small.big + big.small + big.big in f32 (3xTF32,
// ~2^-21 relative): one rounded TF32 or bf16 pass misses 1e-5 of scale
// where this holds it (tests/test_torch_ssd_backward.py), and 7c's
// gradient gate is 1e-3.  bf16 inputs are exact in TF32, so their small
// parts are 0: C.B and dy.x of bf16 take one pass, the f32 weighted scores
// and states times a bf16 tile two (not bf16 m16n8k16: the weighted
// scores would still need a hi + lo pair, and one body serves both
// types).  Splitting by cvt.rna.tf32 instead of rounding by the bits
// takes zamba2's call from 1.30 to 1.57 ms (kernel_ab.py --ablate-ssd,
// NVIDIA H100 80GB HBM3 at 700 W).  Tiles are f32 in shared memory,
// [rows][W] with W = max(32, width) and each row's 4-word groups XORed by
// the row (fzx): ldmatrix along rows and scalar loads down columns both
// fall on 32 banks.  The decays stay f32, exp of La_t - La_s, taken only
// where s <= t.
// Bound: x, dy, dx, B, C, dB, dC, dt, ddt moved once; the products ~L^2
// (3N + 2P) + 10 L P N flops a chunk, for f32 at the lesser of the f32
// peak (67 TF/s) and three TF32 passes (3 x flops / 495 TF/s): operations
// bound it, 0.195 ms at zamba2's train shape.  Times (NVIDIA H100 80GB
// HBM3 at 700 W, median of 20, L2 flushed; chip_smoke.py phase 3,
// kernel_ab.py for the parent): the train shape (B = 8, S = 512, chunk
// 256, f32) zamba2 1.30 ms, mamba2 0.78 (the first design 5.19 / 2.82);
// S = 1024 bf16 0.37 / 0.21 (1.92 / 1.15).  One call by launch (zamba2,
// f32): A 0.16 ms, B 0.03, C 0.99, D 0.12.  C without its products (an
// ablation) still takes 0.39 ms: staging, partial stores and each
// block's first loads, one block an SM.
// ptxas (-Xptxas -v, sm_90a), registers for (W_P, W_N) = (32, 32) (32,
// 64) (32, 128) (32, 256) (64, 32) (64, 64) (64, 128) (128, 32) (128, 64):
// kernel C f32 182 200 231 255 190 226 251 213 231, bf16 128 204 238 255
// 192 226 246 213 236; kernel A f32 64 75 128 202 48 74 118 71 117, bf16
// 56 79 124 204 64 64 118 64 119; no spills but C at (32, 256) (f32 4
// bytes, bf16 92; no config has N = 256); B 26, D 78.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC --split-compile=0 -o libssd_scan.so
//        ssd_scan.cu  (the backward's template instances compile on every
//        core: 37 s for all five sources against 79 s without)
// Each entry point returns cudaGetLastError() after its launches (0 = ok).

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
  // La summed left to right in f32, as the plain version's cumsum sums it:
  // a chunk's La reaches the thousands (an ulp there is ~2e-4), where a
  // tree's other rounding moves exp(La_t - La_s), and through zamba2's 32
  // SSD layers that put its float32 gradients 6.5e-3 of scale from the
  // plain route's (chip_smoke.py phase 7c; 3.7e-4 summed this way)
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run += la[i];
      la[i] = run;
    }
  }
  __syncthreads();
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
  float* la = reinterpret_cast<float*>(smem_raw);   // [L]
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
      if (i < src_end) la[i] = lv[q], dts[i] = dv[q];
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
    const float e0 =
        row0 < L ? tiles::exp2_approx(la[row0] * kLog2e) : 0.f;
    const float e1 =
        row0 + 8 < L ? tiles::exp2_approx(la[row0 + 8] * kLog2e) : 0.f;
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
          v = (s <= t && t < L)
                  ? v * tiles::exp2_approx((lt[r] - ls) * kLog2e) * ds
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

// The card's SM count (132 on an H100 SXM when the query fails).
int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Kernels 1-2: La, the chunks' decays and states, then the states at the
// chunks' starts (kSplit: bf16 hi + lo planes) and the final state.
template <typename T, bool kSplit>
int launch_states(const T* x, const float* dt, const float* A, const T* Bm,
                  const float* h0, float* la, float* decay, float* states,
                  float* hstart, float* h_out, int batch, const Dims& d,
                  bool aligned, cudaStream_t stream) {
  const int S = d.seq, H = d.heads, P = d.head_dim, N = d.state;
  const int nc = S / d.chunk;
  const long long bhs = (long long)batch * H;
  constexpr int E = 16 / (int)sizeof(T);
  // P slices: enough blocks for two per SM where the state allows
  const int sms = sm_count();
  int psplit = 1;
  while (psplit < 8 && (long long)nc * bhs * psplit < 2LL * sms &&
         P % (2 * psplit) == 0 && (P / (2 * psplit)) * N >= kThreads)
    psplit *= 2;
  const int PS = P / psplit;
  const int vec_s = aligned && PS % E == 0 && N % E == 0;
  const size_t s_bytes = state_smem_bytes(P, N, d.chunk, psplit, sizeof(T));
  if (int err = set_smem((const void*)ssd_chunk_state_kernel<T>, s_bytes))
    return err;
  ssd_chunk_state_kernel<T><<<dim3(nc * psplit, H, batch), kThreads, s_bytes,
                              stream>>>(x, dt, A, Bm, la, decay, states, d,
                                        psplit, vec_s);
  if (int err = (int)cudaGetLastError()) return err;
  const dim3 pass_grid((P * N + kThreads - 1) / kThreads, (unsigned)bhs);
  ssd_state_pass_kernel<kSplit><<<pass_grid, kThreads, 0, stream>>>(
      decay, states, hstart, h0, h_out, nc, P * N);
  return (int)cudaGetLastError();
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
  if (int err = launch_states<T, IsBf16<T>::value>(
          x, dt, A, Bm, h0, la, decay, states, hstart, h_out, batch, d,
          aligned, stream))
    return err;
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

// ---------------------------------------------------------------------------
// The backward: A. the chunk states and E; B. both state passes; C. the
// tile pairs; D. the ordered sums
// ---------------------------------------------------------------------------
//
// Every product of kernels A and C runs on tensor cores as
// mma.sync.m16n8k8 in TF32, at f32 accuracy: an f32 operand enters as big
// + small halves (to_tf32), and a product is small.big + big.small +
// big.big, accumulated in f32 (3xTF32, ~2^-21 relative); a bf16 operand
// is exact in TF32, so its small part is 0 and its products are dropped
// (C.B and dy.x of bf16 inputs take one pass, the f32 weighted scores
// times a bf16 tile two).  Tiles are f32 in shared memory, [rows][W] with W = max(32, width)
// and the columns of a row XOR-swizzled by the row (fz): the fragment
// loads along a row (ldmatrix) and down a column (scalar) both fall on 32
// distinct banks.

constexpr int kBwRows = 64;                 // positions per backward tile
constexpr int kHdotParts = 32;              // <dS, h> partials a chunk
constexpr int kUFloats = 8192;              // dS, h or M1 | M2 (kernel C)
constexpr int kRedFloats = 11 * kBwRows;    // kernel C's row / column sums

// A backward tile's width for `w` columns (w a power of two).
__host__ __device__ inline int bw_width(int w) { return w < 32 ? 32 : w; }

// Kernel C's dynamic shared memory (floats) with `stages` target buffers.
__host__ inline size_t pair_floats(int P, int N, int L, int stages) {
  return (size_t)kBwRows * (bw_width(P) + bw_width(N)) * (1 + stages) +
         kUFloats + round4(L) + kRedFloats;
}

// Target buffers of kernel C: two (the next pair's tiles copied while this
// one is multiplied) for f32 where they fit, else one; bf16 is widened as
// it is staged, so it copies nothing ahead and keeps one.
__host__ inline int pair_stages(int P, int N, int L, size_t elem) {
  return elem == 4 && sizeof(float) * pair_floats(P, N, L, 2) <=
                          (size_t)kSmemLimit
             ? 2
             : 1;
}

// The XOR of row r's columns in a backward tile: 4-word groups moved by
// the row mod 8, so 8 rows x 4 words (a fragment's row-wise loads, one
// ldmatrix) and 4 rows x 8 words (its column-wise loads, rows k and k + 4
// alike) each fall on 32 distinct banks.
__device__ __forceinline__ int fzx(int r) { return ((r & 3) << 3) | (r & 4); }

// Word offset of column c of row r in an f32 tile W words wide (a power
// of two, at least 32, so the XOR stays within the row).
__device__ __forceinline__ int fz(int r, int c, int W) {
  return r * W + (c ^ fzx(r));
}

// An operand as TF32 big + small, for f32 accuracy from three products
// (3xTF32): big = a rounded to TF32 (to nearest, by its bits), small = a -
// big (exact), whose bits past TF32's the tensor cores drop: ~2^-21 of a.
// kSplit false: a value exact in TF32 (a bf16 input), taken as it is.
template <bool kSplit>
__device__ __forceinline__ void to_tf32(float a, uint32_t& big,
                                        uint32_t& small) {
  if constexpr (kSplit) {
    big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(a - __uint_as_float(big));
  } else {
    big = __float_as_uint(a);
    small = 0u;
  }
}

// d += a * b: TF32 inputs, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nb] (16 output rows, 8 columns each) += A . B over k in [k0, k1)
// (multiples of 8), in the fragment layout of mma.m16n8k8:
//   A: kAR, a tile [m][k] (rows a_r0.., by ldmatrix); else a tile [k][m]
//      (A = its transpose, columns a_r0..);
//   B: kBR, a tile [n][k] (rows b_c0 + 16 n2.., ldmatrix, two 8-column
//      blocks at a time); else a tile [k][n] (columns b_c0 + 8 nb..);
// kSA / kSB: the operand is f32 (split, three products: small.big +
// big.small + big.big, the small ones first) or exact in TF32.  Each
// lane's offsets are fixed outside the k loop: k, a multiple of 8, moves
// a row-wise load by an XOR of its column and a column-wise one by k rows.
template <int NB, bool kAR, bool kBR, bool kSA, bool kSB>
__device__ __forceinline__ void tile_mma(float (&acc)[NB][4], const float* a,
                                         int wa, int a_r0, const float* b,
                                         int wb, int b_c0, int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const float* ap;
  int ao[4];
  if constexpr (kAR) {
    const int r = a_r0 + mrow + ((mat & 1) << 3);
    ap = a + r * wa;
    ao[0] = ((mat >> 1) << 2) ^ fzx(r);
  } else {
    ap = a + q * wa;
    ao[0] = (a_r0 + g) ^ fzx(q);
    ao[1] = (a_r0 + g + 8) ^ fzx(q);
    ao[2] = 4 * wa + ((a_r0 + g) ^ (fzx(q) | 4));
    ao[3] = 4 * wa + ((a_r0 + g + 8) ^ (fzx(q) | 4));
  }
  const float* bp;
  int bo;
  if constexpr (kBR) {
    const int r = b_c0 + mrow + ((mat >> 1) << 3);
    bp = b + r * wb;
    bo = ((mat & 1) << 2) ^ fzx(r);
  } else {
    bp = b + q * wb;
    bo = fzx(q);
  }
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ar[4];
    if constexpr (kAR) {
      tiles::ldmatrix_x4(ar, ap + (k ^ ao[0]));
    } else {
      const float* row = ap + k * wa;
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = __float_as_uint(row[ao[i]]);
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      to_tf32<kSA>(__uint_as_float(ar[i]), ab[i], as[i]);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t br[4];       // b0, b1 of block 2 n2, then of block 2 n2 + 1
      if constexpr (kBR) {
        tiles::ldmatrix_x4(br, bp + n2 * 16 * wb + (k ^ bo));
      } else {
        const float* row = bp + k * wb;
        const int n = b_c0 + n2 * 16 + g;
        br[0] = __float_as_uint(row[n ^ bo]);
        br[1] = __float_as_uint(row[4 * wb + (n ^ (bo | 4))]);
        br[2] = __float_as_uint(row[(n + 8) ^ bo]);
        br[3] = __float_as_uint(row[4 * wb + ((n + 8) ^ (bo | 4))]);
      }
      uint32_t bb[4], bs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        to_tf32<kSB>(__uint_as_float(br[i]), bb[i], bs[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float(&d)[4] = acc[2 * n2 + h];
        if constexpr (kSA) mma_tf32(d, as, bb[2 * h], bb[2 * h + 1]);
        if constexpr (kSB) mma_tf32(d, ab, bs[2 * h], bs[2 * h + 1]);
        mma_tf32(d, ab, bb[2 * h], bb[2 * h + 1]);
      }
    }
  }
}

// Rows [0, rows) of a global matrix (rows `step` elements apart, `width`
// valid columns) into a swizzled f32 tile of tile_rows x W; other rows and
// columns 0.  vec: f32 by 16-byte cp.async (the caller commits and waits),
// bf16 by 8-byte loads widened; else element by element.
template <typename T>
__device__ __forceinline__ void stage_fz(float* dst, const T* __restrict__ src,
                                         long long step, int rows,
                                         int tile_rows, int width, int W,
                                         bool vec) {
  const int cpr = W >> 2;                  // 4-word groups a row
  for (int i = threadIdx.x; i < tile_rows * cpr; i += kThreads) {
    const int r = i / cpr, col = (i - r * cpr) << 2;
    float* to = dst + fz(r, col, W);
    const bool ok = r < rows && col < width;
    if (vec) {
      if constexpr (IsBf16<T>::value) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          const uint2 u = *reinterpret_cast<const uint2*>(src + r * step + col);
          const __nv_bfloat162 lo =
              *reinterpret_cast<const __nv_bfloat162*>(&u.x);
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&u.y);
          v = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                          __high2float(hi));
        }
        *reinterpret_cast<float4*>(to) = v;
      } else {
        tiles::cp_async_16(to, ok ? src + r * step + col : src, ok);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      to[k] = (r < rows && col + k < width) ? to_f32(src[r * step + col + k])
                                            : 0.f;
  }
}

// The block's sum of v, in a fixed order, returned to thread 0.
__device__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                   // warp_sums free from any earlier use
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;
}

// A. Grid (chunk x 2, head, batch row).  La by kernel 1's left-to-right
// sum of dt * A; then even blocks the chunk state S_c = sum_s exp(La_L -
// La_s) dt_s x_s ⊗ B_s (and La, exp(La_L) to la_out, decay_out), odd
// blocks E_c = sum_t exp(La_t) dy_t ⊗ C_t, [P][N] each, over 64-row tiles
// of x (dy) and B (C), B's rows weighted in place, on tensor cores as in
// kernel C: S^T's product x^T (w B) with both tiles read down their
// columns.  Warp w: rows 16 (w % 4) (+ 64) of P, the half w / 4 of N.
template <typename T, int WP, int WN>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ la_out, float* __restrict__ decay_out,
                     float* __restrict__ states, float* __restrict__ e_out,
                     const Dims d, int vec) {
  constexpr bool kS = !IsBf16<T>::value;
  constexpr int MT = WP >= 64 ? WP / 64 : 1, NB = WN / 16;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp & 3, wn = warp >> 2;
  const int H = d.heads, P = d.head_dim, N = d.state, G = d.groups;
  const int L = d.chunk, S = d.seq, nc = S / L;
  const int c = blockIdx.x >> 1, head = blockIdx.y, b = blockIdx.z;
  const bool emode = blockIdx.x & 1;
  const int grp = head / (H / G);
  float* xt = smem;                              // [64][WP]
  float* bt = xt + kBwRows * WP;                 // [64][WN]
  float* la = bt + kBwRows * WN;                 // [L]
  float* w = la + round4(L);                     // [L]: dt, then weights
  const long long pos0 = (long long)b * S + (long long)c * L;
  const long long bh = (long long)b * H + head;
  const long long x_row = (long long)H * P, bc_row = (long long)G * N;
  const T* xb = (emode ? dy : x) + pos0 * x_row + (long long)head * P;
  const T* bb = (emode ? Cm : Bm) + pos0 * bc_row + (long long)grp * N;
  const float a_h = A[head];
  for (int i = tid; i < L; i += kThreads) {
    const float dv = dt[(pos0 + i) * H + head];
    w[i] = dv;
    la[i] = dv * a_h;
  }
  __syncthreads();
  if (tid == 0) {                    // the plain cumsum's order (kernel 1)
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run += la[i];
      la[i] = run;
    }
  }
  __syncthreads();
  const float last = la[L - 1];
  for (int i = tid; i < L; i += kThreads) {
    if (!emode) la_out[bh * S + (long long)c * L + i] = la[i];
    w[i] = emode ? expf(la[i]) : expf(last - la[i]) * w[i];
  }
  if (tid == 0 && !emode) decay_out[bh * nc + c] = expf(last);

  float acc[MT][NB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      acc[mt][nb][0] = acc[mt][nb][1] = acc[mt][nb][2] = acc[mt][nb][3] = 0.f;
  for (int s0 = 0; s0 < L; s0 += kBwRows) {
    const int rows = min(kBwRows, L - s0);
    __syncthreads();                 // the previous tiles consumed
    stage_fz<T>(xt, xb + s0 * x_row, x_row, rows, kBwRows, P, WP, vec);
    stage_fz<T>(bt, bb + s0 * bc_row, bc_row, rows, kBwRows, N, WN, vec);
    tiles::cp_async_commit();
    tiles::cp_async_wait<0>();
    __syncthreads();
    // the swizzle keeps a row's words in the row: scale them in place
    for (int i = tid; i < rows * WN; i += kThreads) bt[i] *= w[s0 + i / WN];
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = (wm + 4 * mt) * 16;
      if (m0 < WP)
        tile_mma<NB, false, false, kS, true>(acc[mt], xt, WP, m0, bt, WN,
                                             wn * (WN / 2), 0,
                                             (rows + 7) & ~7);
    }
  }
  float* out = (emode ? e_out : states) + (bh * nc + c) * (long long)P * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pr = (wm + 4 * mt) * 16 + g + 8 * (e >> 1);
        const int n = wn * (WN / 2) + nb * 8 + 2 * q + (e & 1);
        if (pr < P && n < N) out[pr * N + n] = acc[mt][nb][e];
      }
}

// B. Grid (P * N / 256 slices, head x batch row).  The states at the
// chunks' starts in f32 (kernel 2's recurrence over kernel A's S_c), the
// then the reverse pass: g = dh (or 0); for c = nc - 1 .. 0: dS_c = g
// (over S_c, read by then), this slice's share of <dS_c, h_c>, g =
// exp(La_L,c) g + E_c; dh0 = g.  E_c came from kernel A, in parallel over
// the chunks.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(const float* __restrict__ decay, float* __restrict__ states,
                    const float* __restrict__ estates,
                    float* __restrict__ hstart, const float* __restrict__ h0,
                    const float* __restrict__ dh, float* __restrict__ dh0,
                    float* __restrict__ hdot, int nc, int pn) {
  __shared__ float warp_sums[kWarps];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const long long bh = blockIdx.y;
  const bool active = e < pn;
  const float* dec = decay + bh * nc;
  float h = active && h0 ? h0[bh * pn + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long at = (bh * nc + c) * pn + e;
    if (active) {
      hstart[at] = h;
      h = fmaf(dec[c], h, states[at]);
    }
  }
  float g = active && dh ? dh[bh * pn + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long at = (bh * nc + c) * pn + e;
    float part = 0.f;
    if (active) {
      states[at] = g;
      part = g * hstart[at];
    }
    part = block_sum(part, warp_sums);
    if (threadIdx.x == 0) hdot[(bh * nc + c) * kHdotParts + blockIdx.x] = part;
    if (active) g = fmaf(dec[c], g, estates[at]);
  }
  if (active) dh0[bh * pn + e] = g;
}

// Columns c and c + 1 (c even) of a row `width` wide: one 2-element store
// where both lie in it and the width is even, else what lies in it.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, int width, float a,
                                           float b) {
  if (c + 1 < width && width % 2 == 0) {
    if constexpr (IsBf16<T>::value)
      *reinterpret_cast<uint32_t*>(row + c) = tiles::pack_bf16(a, b);
    else
      *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
  } else if (c < width) {
    row[c] = from_f32<T>(a);
  }
}

// C. One block per (64-row source tile si, chunk, head x batch row), every
// source tile's blocks before the next's (si = blockIdx.x / (nc B H): the
// tiles with the most target tiles start first).  With M1[s,t] = (C_t .
// B_s) exp(La_t - La_s) dt_s and M2[s,t] = (dy_t . x_s) exp(La_t - La_s)
// dt_s (s <= t; exp is taken nowhere else), it walks the target tiles tj
// >= si and computes, each pair's C.B and dy.x once:
//   the source side, kept in registers over the walk: dx_s = sum_t M1 dy_t
//     + w_s dt_s dS B_s, dB_s = sum_t M2 C_t + w_s dt_s x_s dS (this
//     head's share), the direct ddt_s = sum_t (C.B)(dy.x) exp(..) + Q_s,
//     Q_s = w_s x_s . dS B_s;
//   the target side, one partial a pair (summed by D in source order):
//     dC_t = sum_s M2[s,t] B_s (+ exp(La_t) dy_t . h_c on the diagonal)
//     and La's gradient from the targets, sum_s (C.B) M2 (+ C_t . that
//     term).
// Warp w: rows 16 (w % 4).. of each 64-row output, the half w / 4 of its
// columns (scores: 32 targets; dx: P; dB, dC: N).
template <typename T, int WP, int WN>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pair_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const T* __restrict__ dy, const float* __restrict__ la_g,
                    const float* __restrict__ hstart,
                    const float* __restrict__ dstate, T* __restrict__ dx,
                    float* __restrict__ db_h, float* __restrict__ ddt_dir,
                    float* __restrict__ qsum, float* __restrict__ dla_part,
                    float* __restrict__ dc_part, const Dims d, int batch,
                    int stages, int vec, int vec_s) {
  constexpr bool kS = !IsBf16<T>::value;   // the inputs' tiles are split
  constexpr int NBP = WP / 16, NBN = WN / 16;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp & 3, wn = warp >> 2;
  const int H = d.heads, P = d.head_dim, N = d.state, G = d.groups;
  const int L = d.chunk, S = d.seq, nc = S / L;
  const int nt = (L + kBwRows - 1) / kBwRows, TR = min(L, kBwRows);
  const int npairs = nt * (nt + 1) / 2;
  const long long per = (long long)nc * batch * H;
  const int si = (int)(blockIdx.x / per);
  const long long rem = blockIdx.x - (long long)si * per;
  const long long bh = rem / nc;
  const int c = (int)(rem - bh * nc);
  const int b = (int)(bh / H), head = (int)(bh % H), grp = head / (H / G);
  const int s0 = si * kBwRows, rows_s = min(kBwRows, L - s0);
  const int kP = (P + 7) & ~7, kN = (N + 7) & ~7;
  const int r0 = wm * 16;                       // the warp's output rows

  float* xs = smem;                              // [64][WP]
  float* bs = xs + kBwRows * WP;                 // [64][WN]
  float* tgt = bs + kBwRows * WN;                // stages x (dy, C) tiles
  float* u = tgt + stages * kBwRows * (WP + WN); // dS, h, then M1 | M2
  float* m1 = u;                                 // [64][64]
  float* m2 = u + kBwRows * kBwRows;             // [64][64]
  float* la = u + kUFloats;                      // [L]
  float* red_col = la + round4(L);               // [4][64]
  float* red_row = red_col + 4 * kBwRows;        // [2][64]
  float* red_q = red_row + 2 * kBwRows;          // [2][64]
  float* red_int = red_q + 2 * kBwRows;          // [2][64]
  float* qdt = red_int + 2 * kBwRows;            // [64]

  const long long pos0 = (long long)b * S + (long long)c * L;
  const long long x_row = (long long)H * P, bc_row = (long long)G * N;
  const T* xb = x + pos0 * x_row + (long long)head * P;
  const T* dyb = dy + pos0 * x_row + (long long)head * P;
  const T* bb = Bm + pos0 * bc_row + (long long)grp * N;
  const T* cb = Cm + pos0 * bc_row + (long long)grp * N;
  const long long slab = (bh * nc + c) * (long long)P * N;   // dS_c, h_c
  auto dy_tile = [&](int st) { return tgt + st * kBwRows * (WP + WN); };
  auto c_tile = [&](int st) { return dy_tile(st) + kBwRows * WP; };
  auto stage_target = [&](int tj, int st) {
    const int t0 = tj * kBwRows, rows = min(kBwRows, L - t0);
    stage_fz<T>(dy_tile(st), dyb + t0 * x_row, x_row, rows, kBwRows, P, WP,
                vec);
    stage_fz<T>(c_tile(st), cb + t0 * bc_row, bc_row, rows, kBwRows, N, WN,
                vec);
  };
  stage_fz<T>(xs, xb + s0 * x_row, x_row, rows_s, kBwRows, P, WP, vec);
  stage_fz<T>(bs, bb + s0 * bc_row, bc_row, rows_s, kBwRows, N, WN, vec);
  stage_fz<float>(u, dstate + slab, N, P, WP, N, WN, vec_s);
  stage_target(si, 0);
  tiles::cp_async_commit();
  for (int i = tid; i < L; i += kThreads)
    la[i] = la_g[bh * S + (long long)c * L + i];
  tiles::cp_async_wait<0>();
  __syncthreads();

  // the thread's two source rows (of the tile), their La, dt and w
  const int sl[2] = {r0 + g, r0 + g + 8};
  const float la_last = la[L - 1];
  float ls[2], dsr[2], wd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = sl[r] < rows_s;
    ls[r] = ok ? la[s0 + sl[r]] : 0.f;
    dsr[r] = ok ? dt[(pos0 + s0 + sl[r]) * H + head] : 0.f;
    wd[r] = ok ? expf(la_last - ls[r]) : 0.f;
  }

  // the state terms: B_s . dS^T [s][p] and x_s . dS [s][n], then Q_s
  float dxa[NBP][4], dba[NBN][4];
#pragma unroll
  for (int nb = 0; nb < NBP; ++nb)
    dxa[nb][0] = dxa[nb][1] = dxa[nb][2] = dxa[nb][3] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NBN; ++nb)
    dba[nb][0] = dba[nb][1] = dba[nb][2] = dba[nb][3] = 0.f;
  tile_mma<NBP, true, true, kS, true>(dxa, bs, WN, r0, u, WN, wn * (WP / 2),
                                      0, kN);
  tile_mma<NBN, true, false, kS, true>(dba, xs, WP, r0, u, WN, wn * (WN / 2),
                                       0, kP);
  {
    float qr[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NBP; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = wn * (WP / 2) + nb * 8 + 2 * q + (e & 1);
        qr[e >> 1] = fmaf(xs[fz(sl[e >> 1], p, WP)], dxa[nb][e], qr[e >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = qr[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) red_q[wn * kBwRows + sl[r]] = v;
    }
#pragma unroll
    for (int nb = 0; nb < NBP; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[nb][e] *= wd[e >> 1] * dsr[e >> 1];
#pragma unroll
    for (int nb = 0; nb < NBN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) dba[nb][e] *= wd[e >> 1] * dsr[e >> 1];
  }
  __syncthreads();                   // dS consumed: U takes h_c
  stage_fz<float>(u, hstart + slab, N, P, WP, N, WN, vec_s);
  tiles::cp_async_commit();

  float ddt_r[2] = {0.f, 0.f};
  int st = 0;
  for (int tj = si; tj < nt; ++tj) {
    const bool diag = tj == si;
    const int t0 = tj * kBwRows, rows_t = min(kBwRows, L - t0);
    tiles::cp_async_wait<0>();
    __syncthreads();                 // tile tj (and h) landed; pair tj - 1 done
    if (stages == 2 && tj + 1 < nt) stage_target(tj + 1, st ^ 1);
    tiles::cp_async_commit();
    const float* dys = dy_tile(st);
    const float* cs = c_tile(st);
    float dca[NBN][4];
#pragma unroll
    for (int nb = 0; nb < NBN; ++nb)
      dca[nb][0] = dca[nb][1] = dca[nb][2] = dca[nb][3] = 0.f;
    if (diag) {
      // the inter term: dC_t = exp(La_t) dy_t . h_c, and C_t . it
      tile_mma<NBN, true, false, kS, true>(dca, dys, WP, r0, u, WN,
                                           wn * (WN / 2), 0, kP);
      float rv[2] = {0.f, 0.f}, et[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        et[r] = sl[r] < rows_t ? expf(la[t0 + sl[r]]) : 0.f;
#pragma unroll
      for (int nb = 0; nb < NBN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = wn * (WN / 2) + nb * 8 + 2 * q + (e & 1);
          dca[nb][e] *= et[e >> 1];
          rv[e >> 1] =
              fmaf(cs[fz(sl[e >> 1], n, WN)], dca[nb][e], rv[e >> 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = rv[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) red_int[wn * kBwRows + sl[r]] = v;
      }
      __syncthreads();               // h consumed: U takes M1 and M2
    }

    // the pair's scores, C.B and dy.x [s][t] (none above the diagonal)
    float sc1[4][4], sc2[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc1[nb][e] = sc2[nb][e] = 0.f;
    if (!(diag && r0 >= wn * 32 + 32)) {
      tile_mma<4, true, true, kS, kS>(sc1, bs, WN, r0, cs, WN, wn * 32, 0,
                                      kN);
      tile_mma<4, true, true, kS, kS>(sc2, xs, WP, r0, dys, WP, wn * 32, 0,
                                      kP);
    }
    float dla[4][2];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + wn * 32 + nb * 8 + 2 * q + j;
        const float lt = t < L ? la[t] : 0.f;
        float cm = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + j;
          const bool ok = s0 + sl[r] <= t && t < L;
          const float dec = ok ? expf(lt - ls[r]) : 0.f;
          const float cbv = sc1[nb][e], dyx = sc2[nb][e];
          const float cbd = cbv * dec;
          ddt_r[r] = fmaf(cbd, dyx, ddt_r[r]);
          const float mv2 = dyx * dec * dsr[r];
          cm = fmaf(cbv, mv2, cm);
          sc1[nb][e] = cbd * dsr[r];           // M1
          sc2[nb][e] = mv2;                    // M2
        }
        dla[nb][j] = cm;
      }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = fz(sl[r], wn * 32 + nb * 8 + 2 * q, kBwRows);
        *reinterpret_cast<float2*>(m1 + at) =
            make_float2(sc1[nb][2 * r], sc1[nb][2 * r + 1]);
        *reinterpret_cast<float2*>(m2 + at) =
            make_float2(sc2[nb][2 * r], sc2[nb][2 * r + 1]);
      }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = dla[nb][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red_col[wm * kBwRows + wn * 32 + nb * 8 + 2 * q + j] = v;
      }
    __syncthreads();                 // M1, M2 and the column sums written

    // the source side over this pair's targets (t >= s) ...
    const int kt = (rows_t + 7) & ~7;
    const int klo = diag ? r0 : 0;
    tile_mma<NBP, true, false, true, kS>(dxa, m1, kBwRows, r0, dys, WP,
                                         wn * (WP / 2), klo, kt);
    tile_mma<NBN, true, false, true, kS>(dba, m2, kBwRows, r0, cs, WN,
                                         wn * (WN / 2), klo, kt);
    // ... and the target side over its sources (s <= t)
    const int ks = min(diag ? r0 + 16 : kBwRows, (rows_s + 7) & ~7);
    tile_mma<NBN, false, false, true, kS>(dca, m2, kBwRows, r0, bs, WN,
                                          wn * (WN / 2), 0, ks);
    const long long slot =
        (bh * nc + c) * npairs + tj * (tj + 1) / 2 + si;
    float* dcp = dc_part + slot * TR * N;
#pragma unroll
    for (int nb = 0; nb < NBN; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (sl[r] < rows_t)
          store_pair(dcp + sl[r] * N, wn * (WN / 2) + nb * 8 + 2 * q, N,
                     dca[nb][2 * r], dca[nb][2 * r + 1]);
    if (tid < rows_t) {
      float v = red_col[tid] + red_col[kBwRows + tid] +
                red_col[2 * kBwRows + tid] + red_col[3 * kBwRows + tid];
      if (diag) v += red_int[tid] + red_int[kBwRows + tid];
      dla_part[slot * TR + tid] = v;
    }
    if (stages == 1) {
      if (tj + 1 < nt) {
        __syncthreads();             // every warp done with the tiles
        stage_target(tj + 1, 0);
        tiles::cp_async_commit();
      }
    } else {
      st ^= 1;
    }
  }

  // ddt's direct part, dt_s Q_s summed over the tile, dx and dB's share
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = ddt_r[r];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (q == 0) red_row[wn * kBwRows + sl[r]] = v;
  }
  __syncthreads();
  if (tid < kBwRows) {
    float qv = 0.f;
    if (tid < rows_s) {
      const int s = s0 + tid;
      const float qs =
          expf(la_last - la[s]) * (red_q[tid] + red_q[kBwRows + tid]);
      ddt_dir[bh * S + (long long)c * L + s] =
          (red_row[tid] + red_row[kBwRows + tid]) + qs;
      qv = dt[(pos0 + s) * H + head] * qs;
    }
    qdt[tid] = qv;
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < rows_s; ++i) sum += qdt[i];
    qsum[(bh * nc + c) * nt + si] = sum;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (sl[r] >= rows_s) continue;
    const long long pos = pos0 + s0 + sl[r];
#pragma unroll
    for (int nb = 0; nb < NBP; ++nb)
      store_pair(dx + pos * x_row + (long long)head * P,
                 wn * (WP / 2) + nb * 8 + 2 * q, P, dxa[nb][2 * r],
                 dxa[nb][2 * r + 1]);
#pragma unroll
    for (int nb = 0; nb < NBN; ++nb)
      store_pair(db_h + (pos * H + head) * (long long)N,
                 wn * (WN / 2) + nb * 8 + 2 * q, N, dba[nb][2 * r],
                 dba[nb][2 * r + 1]);
  }
}

// D. Blocks [0, H): head h's chunks, batch row by batch row, a warp each
// in turn: La's gradient dLa_t = (the targets' partials, in source order)
// - dt_t ddt_t (+ sum_s dt_s Q_s + exp(La_L) <dS, h_c> at L - 1), its
// reverse cumsum rc by warp scans, ddt = direct + A rc, and dA = sum dt rc
// over the head's chunks (each warp's in order, then the warps in order).
// Blocks from H on: dB and dC, a group's heads summed in order (dC's
// source-tile partials summed first, within each head), 4 elements a
// thread where N allows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ decay,
                      const float* __restrict__ hdot,
                      const float* __restrict__ ddt_dir,
                      const float* __restrict__ qsum,
                      const float* __restrict__ dla_part,
                      const float* __restrict__ db_h,
                      const float* __restrict__ dc_part, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ ddt,
                      float* __restrict__ dA, int batch, const Dims d,
                      int hparts, int vec) {
  __shared__ float warp_sums[kWarps];
  const int H = d.heads, N = d.state, G = d.groups, L = d.chunk, S = d.seq;
  const int nc = S / L, rep = H / G;
  const int nt = (L + kBwRows - 1) / kBwRows, TR = min(L, kBwRows);
  const int npairs = nt * (nt + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < H) {
    const int h = blockIdx.x;
    const float a_h = A[h];
    float da_w = 0.f;
    for (int k = warp; k < batch * nc; k += kWarps) {
      const int b = k / nc, c = k - b * nc;
      const long long bh = (long long)b * H + h, base = bh * nc + c;
      float last = 0.f;
      if (lane == 0) {
        float sq = 0.f, hd = 0.f;
        for (int i = 0; i < nt; ++i) sq += qsum[base * nt + i];
        for (int i = 0; i < hparts; ++i) hd += hdot[base * kHdotParts + i];
        last = sq + decay[base] * hd;
      }
      last = __shfl_sync(0xffffffffu, last, 0);
      const long long pos0 = (long long)b * S + (long long)c * L;
      float carry = 0.f, da = 0.f;
      for (int seg = (L - 1) >> 5; seg >= 0; --seg) {
        const int l = seg * 32 + lane;
        float v = 0.f, dtl = 0.f, dd = 0.f;
        if (l < L) {
          const int tj = l / kBwRows, r = l - tj * kBwRows;
          const float* part =
              dla_part + (base * npairs + tj * (tj + 1) / 2) * TR + r;
          for (int i = 0; i <= tj; ++i) v += part[i * TR];
          dtl = dt[(pos0 + l) * H + h];
          dd = ddt_dir[bh * S + (long long)c * L + l];
          v -= dtl * dd;
          if (l == L - 1) v += last;
        }
        // suffix sums within the segment, then the later segments' total
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float up = __shfl_down_sync(0xffffffffu, v, o);
          if (lane + o < 32) v += up;
        }
        const float rc = v + carry;
        carry += __shfl_sync(0xffffffffu, v, 0);
        if (l < L) {
          ddt[(pos0 + l) * H + h] = fmaf(a_h, rc, dd);
          da = fmaf(dtl, rc, da);
        }
      }
#pragma unroll
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, o);
      da_w += da;
    }
    if (lane == 0) warp_sums[warp] = da_w;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
      dA[h] = s;
    }
    return;
  }
  // vec: 4 consecutive n a thread (16-byte loads; N % 4 == 0), else 1
  const int per = vec ? 4 : 1;
  const long long e = ((long long)(blockIdx.x - H) * kThreads + threadIdx.x) *
                      per;
  if (e >= (long long)batch * S * G * N) return;
  const long long row = e / N;                 // (b * S + s) * G + g
  const int nn = (int)(e - row * N), g = (int)(row % G);
  const long long pos = row / G;               // b * S + s
  const int b = (int)(pos / S), s = (int)(pos - (long long)b * S);
  const int c = s / L, l = s - c * L, tj = l / kBwRows, r = l - tj * kBwRows;
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  auto load = [&](const float* at) {
    return vec ? *reinterpret_cast<const float4*>(at)
               : make_float4(at[0], 0.f, 0.f, 0.f);
  };
#pragma unroll 4
  for (int k = 0; k < rep; ++k) {
    const int h = g * rep + k;
    const long long bh = (long long)b * H + h;
    const float4 d = load(db_h + (pos * H + h) * N + nn);
    sb.x += d.x, sb.y += d.y, sb.z += d.z, sb.w += d.w;
    const float* part = dc_part +
        (((bh * nc + c) * npairs + tj * (tj + 1) / 2) * TR + r) * N + nn;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i <= tj; ++i) {
      const float4 u = load(part + (long long)i * TR * N);
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    }
    sc.x += v.x, sc.y += v.y, sc.z += v.z, sc.w += v.w;
  }
  const float bo[4] = {sb.x, sb.y, sb.z, sb.w}, co[4] = {sc.x, sc.y, sc.z,
                                                       sc.w};
  for (int i = 0; i < per; ++i) {
    dB[e + i] = from_f32<T>(bo[i]);
    dC[e + i] = from_f32<T>(co[i]);
  }
}

// Regions of the backward's workspace (floats, each rounded to 16 bytes),
// in order: La, the chunks' decays, their states (then dS), E, the states
// at their starts, <dS, h> by slice, the direct ddt, dt Q by source tile,
// La's gradient and dC from the targets by tile pair, and dB by head.
constexpr int kBwdRegions = 11;
__host__ inline void bwd_regions(int batch, int seq, int heads, int head_dim,
                                 int state, int chunk, long long* out) {
  const long long bhs = (long long)batch * heads, nc = seq / chunk;
  const long long pn = (long long)head_dim * state;
  const long long nt = (chunk + kBwRows - 1) / kBwRows;
  const long long tr = chunk < kBwRows ? chunk : kBwRows;
  const long long pairs = nt * (nt + 1) / 2;
  const long long sizes[kBwdRegions] = {
      bhs * seq, bhs * nc, bhs * nc * pn, bhs * nc * pn, bhs * nc * pn,
      bhs * nc * kHdotParts, bhs * seq, bhs * nc * nt, bhs * nc * pairs * tr,
      bhs * seq * state, bhs * nc * pairs * tr * state};
  for (int i = 0; i < kBwdRegions; ++i) out[i] = round4_ll(sizes[i]);
}

// Kernel A's dynamic shared memory (floats): the two tiles, La, weights.
__host__ inline size_t state_bwd_floats(int P, int N, int L) {
  return (size_t)kBwRows * (bw_width(P) + bw_width(N)) + 2 * (size_t)round4(L);
}

// The backward's four launches (grid x, y, z, threads, dynamic shared
// bytes each), then kernels A and C's tile widths, kernel C's target
// tiles a chunk, rows a partial and target buffers, and kernel B's slices.
constexpr int kBwdPlan = 4 * 5 + 6;
__host__ inline void bwd_plan(int batch, int seq, int heads, int head_dim,
                              int groups, int state, int chunk, size_t elem,
                              long long* out) {
  const int P = head_dim, N = state, L = chunk, nc = seq / chunk;
  const long long bhs = (long long)batch * heads;
  const int nt = (L + kBwRows - 1) / kBwRows;
  const int stages = pair_stages(P, N, L, elem);
  const int hparts = (P * N + kThreads - 1) / kThreads;
  const long long per = N % 4 ? kThreads : 4 * kThreads;
  const long long sums = ((long long)batch * seq * groups * N + per - 1) / per;
  const long long plan[kBwdPlan] = {
      2LL * nc, heads, batch, kThreads,
      (long long)(sizeof(float) * state_bwd_floats(P, N, L)),
      hparts, bhs, 1, kThreads, 0,
      (long long)nt * nc * bhs, 1, 1, kThreads,
      (long long)(sizeof(float) * pair_floats(P, N, L, stages)),
      heads + sums, 1, 1, kThreads, 0,
      bw_width(P), bw_width(N), nt, L < kBwRows ? L : kBwRows, stages, hparts};
  for (int i = 0; i < kBwdPlan; ++i) out[i] = plan[i];
}

// The backward's operands, the workspace's regions and the plan, as the
// launches take them.
template <typename T>
struct BwdArgs {
  const T *x, *Bm, *Cm, *dy;
  const float *dt, *A, *h0, *dh;
  T *dx, *dB, *dC;
  float *ddt, *dA, *dh0;
  float *la, *decay, *states, *estates, *hstart, *hdot, *ddt_dir, *qsum,
      *dla_part, *db_h, *dc_part;
  int batch, vec, vec_s;
  long long plan[kBwdPlan];
};

// The four launches at tile widths W_P x W_N (W_P * W_N <= 8192 always).
template <typename T, int WP, int WN>
int launch_bwd_at(const BwdArgs<T>& a, const Dims& d, cudaStream_t stream) {
  const int nc = d.seq / d.chunk;
  const long long* plan = a.plan;
  // A. La, the decays, the chunk states and E
  auto* fa = ssd_bwd_state_kernel<T, WP, WN>;
  if (int err = set_smem((const void*)fa, (size_t)plan[4])) return err;
  fa<<<dim3((unsigned)plan[0], d.heads, a.batch), kThreads, (size_t)plan[4],
       stream>>>(a.x, a.dt, a.A, a.Bm, a.Cm, a.dy, a.la, a.decay, a.states,
                 a.estates, d, a.vec);
  if (int err = (int)cudaGetLastError()) return err;
  // B. the states at the chunks' starts, then the reverse pass
  ssd_bwd_pass_kernel<<<dim3((unsigned)plan[5], (unsigned)plan[6]), kThreads,
                        0, stream>>>(a.decay, a.states, a.estates, a.hstart,
                                     a.h0, a.dh, a.dh0, a.hdot, nc,
                                     d.head_dim * d.state);
  if (int err = (int)cudaGetLastError()) return err;
  // C. the tile pairs
  auto* fc = ssd_bwd_pair_kernel<T, WP, WN>;
  if (int err = set_smem((const void*)fc, (size_t)plan[14])) return err;
  fc<<<(unsigned)plan[10], kThreads, (size_t)plan[14], stream>>>(
      a.x, a.dt, a.Bm, a.Cm, a.dy, a.la, a.hstart, a.states, a.dx, a.db_h,
      a.ddt_dir, a.qsum, a.dla_part, a.dc_part, d, a.batch, (int)plan[24],
      a.vec, a.vec_s);
  if (int err = (int)cudaGetLastError()) return err;
  // D. the ordered sums: H scan blocks first, then dB and dC
  ssd_bwd_reduce_kernel<T><<<(unsigned)plan[15], kThreads, 0, stream>>>(
      a.dt, a.A, a.decay, a.hdot, a.ddt_dir, a.qsum, a.dla_part, a.db_h,
      a.dc_part, a.dB, a.dC, a.ddt, a.dA, a.batch, d, (int)plan[5],
      d.state % 4 == 0);
  return (int)cudaGetLastError();
}

template <typename T, int WP>
int launch_bwd_n(const BwdArgs<T>& a, const Dims& d, cudaStream_t stream) {
  const int wn = bw_width(d.state);
#define SSD_BWD_AT(W)                                        \
  if constexpr (WP * (W) <= kUFloats)                        \
    if (wn == (W)) return launch_bwd_at<T, WP, W>(a, d, stream);
  SSD_BWD_AT(32)
  SSD_BWD_AT(64)
  SSD_BWD_AT(128)
  SSD_BWD_AT(256)
#undef SSD_BWD_AT
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_bwd(const void* xv, const float* dt, const float* A,
               const void* Bv, const void* Cv, const float* h0,
               const void* dyv, const float* dh, void* dxv, float* ddt,
               float* dA, void* dBv, void* dCv, float* dh0, float* work,
               int batch, const Dims& d, cudaStream_t stream) {
  BwdArgs<T> a;
  a.x = static_cast<const T*>(xv);
  a.Bm = static_cast<const T*>(Bv);
  a.Cm = static_cast<const T*>(Cv);
  a.dy = static_cast<const T*>(dyv);
  a.dt = dt, a.A = A, a.h0 = h0, a.dh = dh;
  a.dx = static_cast<T*>(dxv);
  a.dB = static_cast<T*>(dBv);
  a.dC = static_cast<T*>(dCv);
  a.ddt = ddt, a.dA = dA, a.dh0 = dh0;
  long long sizes[kBwdRegions];
  bwd_regions(batch, d.seq, d.heads, d.head_dim, d.state, d.chunk, sizes);
  float* region[kBwdRegions];
  region[0] = work;
  for (int i = 1; i < kBwdRegions; ++i)
    region[i] = region[i - 1] + sizes[i - 1];
  a.la = region[0], a.decay = region[1], a.states = region[2];
  a.estates = region[3], a.hstart = region[4], a.hdot = region[5];
  a.ddt_dir = region[6], a.qsum = region[7], a.dla_part = region[8];
  a.db_h = region[9], a.dc_part = region[10];
  a.batch = batch;
  // whole 4-element groups staged where rows and pointers allow
  a.vec = aligned16(a.x) && aligned16(a.Bm) && aligned16(a.Cm) &&
          aligned16(a.dy) && d.head_dim % 4 == 0 && d.state % 4 == 0;
  a.vec_s = aligned16(work) && d.state % 4 == 0;
  bwd_plan(batch, d.seq, d.heads, d.head_dim, d.groups, d.state, d.chunk,
           sizeof(T), a.plan);
  switch (bw_width(d.head_dim)) {
    case 32:
      return launch_bwd_n<T, 32>(a, d, stream);
    case 64:
      return launch_bwd_n<T, 64>(a, d, stream);
    case 128:
      return launch_bwd_n<T, 128>(a, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shapes the kernels take, forward and backward: head_dim and state
// dividing 256, head_dim at most 128, head_dim * state at most 8192, and
// every kernel's shared memory within the block limit.
extern "C" int ssd_scan_supported(int head_dim, int state, int chunk) {
  if (head_dim <= 0 || state <= 0 || chunk <= 0) return 0;
  if (kThreads % head_dim || kThreads % state || head_dim > 128 ||
      head_dim * state > kThreads * kMaxAcc)
    return 0;
  const size_t limit = kSmemLimit;
  return state_smem_bytes(head_dim, state, chunk, 1, 4) <= limit &&
         state_smem_bytes(head_dim, state, chunk, 1, 2) <= limit &&
         out_smem_bytes(head_dim, state, chunk, 4) <= limit &&
         out_smem_bytes(head_dim, state, chunk, 2) <= limit &&
         sizeof(float) * state_bwd_floats(head_dim, state, chunk) <= limit &&
         sizeof(float) * pair_floats(head_dim, state, chunk, 1) <= limit;
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

// Floats of workspace one backward call needs: the sum of its regions
// (bwd_regions).
extern "C" long long ssd_scan_bwd_workspace(int batch, int seq, int heads,
                                            int head_dim, int state,
                                            int chunk) {
  long long sizes[kBwdRegions], total = 0;
  bwd_regions(batch, seq, heads, head_dim, state, chunk, sizes);
  for (int i = 0; i < kBwdRegions; ++i) total += sizes[i];
  return total;
}

// The backward's plan as the launcher makes it (bwd_plan: 26 values),
// then its workspace regions (bwd_regions: 11), into `out`;
// 0, or cudaErrorInvalidValue for a shape the kernels do not take.
// dtype as for ssd_chunked_scan_bwd.
extern "C" int ssd_scan_bwd_plan(int batch, int seq, int heads, int head_dim,
                                 int groups, int state, int chunk, int dtype,
                                 long long* out) {
  if (!ssd_scan_supported(head_dim, state, chunk) || seq % chunk ||
      groups <= 0 || heads % groups || batch <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  bwd_plan(batch, seq, heads, head_dim, groups, state, chunk,
           dtype == 0 ? 4 : 2, out);
  bwd_regions(batch, seq, heads, head_dim, state, chunk, out + kBwdPlan);
  return 0;
}

// The backward of ssd_chunked_scan: from its inputs and dy (x's dtype and
// shape) and dh (f32 [B,H,P,N], or null for a final state with no
// gradient), dx, dB, dC in x's dtype and ddt, dA, dh0 in f32 (dh0 also
// when h0 is null: the gradient of a zero start).  work:
// ssd_scan_bwd_workspace() floats.  Every sum runs in a fixed order: two
// calls give the same bits.
extern "C" int ssd_chunked_scan_bwd(const void* x, const float* dt,
                                    const float* A, const void* Bm,
                                    const void* Cm, const float* h0,
                                    const void* dy, const float* dh, void* dx,
                                    float* ddt, float* dA, void* dB, void* dC,
                                    float* dh0, float* work, int batch,
                                    int seq, int heads, int head_dim,
                                    int groups, int state, int chunk,
                                    int dtype, void* stream) {
  if (!ssd_scan_supported(head_dim, state, chunk) || seq % chunk ||
      groups <= 0 || heads % groups || batch <= 0)
    return (int)cudaErrorInvalidValue;
  Dims d{seq, heads, head_dim, groups, state, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, dt, A, Bm, Cm, h0, dy, dh, dx, ddt, dA, dB,
                             dC, dh0, work, batch, d, s);
  if (dtype == 1)
    return launch_bwd<bf16>(x, dt, A, Bm, Cm, h0, dy, dh, dx, ddt, dA, dB, dC,
                            dh0, work, batch, d, s);
  return (int)cudaErrorInvalidValue;
}
