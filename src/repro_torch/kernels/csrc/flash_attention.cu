// Causal GQA prefill attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   * flash_prefill_bf16, flash_prefill_f32  <- _flash_kernel  (:29,
//     pallas_call :97)
//
// What it computes: q [B,S,H,D] against k, v [B,T,KV,D] (query head h
// reads kv head h / (H / KV)), causal with the prefix offset T - S:
//   s(i, t) = scale * q_i . k_t      for t <= i + (T - S), else masked
//   out_i   = sum_t softmax_t(s(i, .)) v_t
// with the online softmax (m / l / acc) in f32, masked scores at -1e30 and
// contributing exactly 0, key / value rows past T read as 0, and a row
// with no valid key (l == 0) writing 0, as the TPU kernel does.  T >= S.
// Layout: q, out [B,S,H,D]; k, v [B,T,KV,D]; contiguous; D in {16, 32,
// 64, 128}.
//
// Bound.  Causal attention does 4 * B * H * D * (pairs i, t on or below
// the diagonal) flops and reads q, k, v once and writes out once.  At the
// path's shape (zamba2's shared block: B = 1, S = T = 1024, H = KV = 32,
// D = 64, bf16) that is 4.3 GFLOP, 4.4 us at the 989 TFLOP/s bf16 peak,
// and 16.8 MB, 5.0 us at 3.35 TB/s: both bounds are a few microseconds,
// so latency, occupancy and the causal tail set the time.
//
// What the first design lost: it converted Q, K and V to f32 in
// shared memory with synchronous element loads, ran every score and every
// P.V term as an FMA on CUDA cores with both operands read from shared
// memory, synchronised four times per K/V tile and overlapped no copy with
// math: 0.673 ms at the path's shape, ~6.4 TFLOP/s, bounded by shared-
// memory traffic.
//
// bf16 route (flash_prefill_bf16), FlashAttention-2 shaped:
//   * one block of 4 warps per (q tile, head, batch row); each warp owns
//     16 rows of the tile per m16 tile and holds their Q fragments in
//     registers (ldmatrix, once).  For D <= 64 a warp runs two m16 tiles
//     (128-row q tiles), so every K and V fragment it loads feeds two
//     products; at D = 128 (registers) one (64-row q tiles);
//   * K and V tiles of 64 keys stay bf16 in a 3-stage shared-memory ring
//     filled by 16-byte cp.async.cg copies (keys >= T zero-filled with
//     src-size 0), XOR-swizzled so ldmatrix is free of bank conflicts; one
//     __syncthreads per tile, the next two tiles' copies in flight while
//     this one is computed;
//   * S = Q K^T and O += P V on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate); the online softmax runs on the accumulator fragments
//     (row max and sum across the quad by shuffles, in log2 units);
//     P is rounded to bf16 in registers and fed back as the A operand of
//     P V, V read with ldmatrix.trans: no trip through shared memory;
//   * only tiles crossing the diagonal (offset T - S, any value) mask;
//     tiles wholly above it are never loaded;
//   * the epilogue scales by 1/l (0 where l == 0), stages bf16 through the
//     Q tile's shared memory and stores 16-byte chunks;
//   * q tiles launch heaviest first (grid z walks them backwards), so the
//     causal tail does not run on a half-empty card.
// f32 route (flash_prefill_f32): the first design, on CUDA cores.  Float32 is
// the type of the card-vs-CPU checks at 2e-5, which TF32 would not hold.
//
// ptxas (-Xptxas -v, sm_90a), bf16 route:
// flash_prefill_tc_kernel<D> uses 167 / 182 / 240 / 179 registers for
// D = 16 / 32 / 64 / 128, no stack, no spills; shared memory is dynamic,
// (q tile rows + 6 * 64) * D * 2 bytes = 16 / 32 / 64 / 112 KB, so two
// blocks (8 warps) fit an SM.  f32 route: 40 / 40 / 48 / 80
// registers, 8 bytes of spill at D = 64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using tiles::bf16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int q_len, kv_len, heads, kv_heads;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;                // keys per tile
constexpr int kStages = 3;             // K/V tiles in the ring

// m16 row tiles per warp: two where the registers allow (the K and V
// fragments then feed two products each), one at D = 128.
template <int D>
__host__ __device__ constexpr int m_tiles() { return D <= 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int block_rows() {
  return 16 * kWarps * m_tiles<D>();
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (block_rows<D>() + 2 * kStages * kBK) * D * (int)sizeof(bf16);
}

// cp.async rows [row0, row0 + ROWS) of a [rows, stride] bf16 matrix into a
// swizzled ROWS x D tile; rows at or past `limit` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long stride, int row0,
                                          int limit) {
  constexpr int C = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool ok = row0 + r < limit;
    const bf16* src = ok ? base + (long long)(row0 + r) * stride + c * 8
                         : base;
    tiles::cp_async_16(dst + tiles::Swizzle<D>::at(r, c), src, ok);
  }
}

// Grid (head, batch row, q tile), q tiles launched heaviest first.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        const Dims g) {
  using Sw = tiles::Swizzle<D>;
  constexpr int KM = m_tiles<D>();     // m16 tiles per warp
  constexpr int BQ = block_rows<D>();  // query rows per block
  constexpr int WR = 16 * KM;          // query rows per warp
  constexpr int KS = D / 16;           // k-slices of a Q row
  constexpr int NB = D / 8;            // 8-column blocks of an output row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [BQ][D]
  bf16* ks = qs + BQ * D;                                // [kStages][kBK][D]
  bf16* vs = ks + kStages * kBK * D;                     // [kStages][kBK][D]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int S = g.q_len, Tk = g.kv_len, H = g.heads, KV = g.kv_heads;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;     // heaviest first
  const int kvh = head / (H / KV);
  const int offset = Tk - S;
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const bf16* qb = q + (long long)b * S * q_row + (long long)head * D;
  bf16* ob = out + (long long)b * S * q_row + (long long)head * D;
  const bf16* kb = k + (long long)b * Tk * kv_row + (long long)kvh * D;
  const bf16* vb = v + (long long)b * Tk * kv_row + (long long)kvh * D;

  // keys any row of the tile sees: t < min(S, q0 + BQ) + offset (<= T)
  const int t_end = min(S, q0 + BQ) + offset;
  const int n_tiles = (t_end + kBK - 1) / kBK;

  load_tile<D, BQ>(qs, qb, q_row, q0, S);
  load_tile<D, kBK>(ks, kb, kv_row, 0, Tk);
  load_tile<D, kBK>(vs, vb, kv_row, 0, Tk);
  tiles::cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      load_tile<D, kBK>(ks + st * kBK * D, kb, kv_row, st * kBK, Tk);
      load_tile<D, kBK>(vs + st * kBK * D, vb, kv_row, st * kBK, Tk);
    }
    tiles::cp_async_commit();
  }

  uint32_t qf[KM][KS][4];
  float o[KM][NB][4];
  float m[KM][2], l[KM][2];
#pragma unroll
  for (int mi = 0; mi < KM; ++mi) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
      o[mi][n][0] = o[mi][n][1] = o[mi][n][2] = o[mi][n][3] = 0.f;
    m[mi][0] = m[mi][1] = kNegInf;
    l[mi][0] = l[mi][1] = 0.f;
  }
  const float scale2 = g.scale * kLog2e;
  const int row_lo = q0 + warp * WR + gq;   // m-tile mi: rows lo + 16 mi (+8)

  for (int j = 0; j < n_tiles; ++j) {
    tiles::cp_async_wait<kStages - 2>();   // tile j (and Q) arrived
    __syncthreads();                       // ... for all; tile j-1 done
    {
      const int jn = j + kStages - 1;      // refill tile j-1's stage
      if (jn < n_tiles) {
        const int st = jn % kStages;
        load_tile<D, kBK>(ks + st * kBK * D, kb, kv_row, jn * kBK, Tk);
        load_tile<D, kBK>(vs + st * kBK * D, vb, kv_row, jn * kBK, Tk);
      }
      tiles::cp_async_commit();
    }
    if (j == 0) {
#pragma unroll
      for (int mi = 0; mi < KM; ++mi)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          tiles::ldmatrix_x4(
              qf[mi][kk],
              qs + Sw::at(warp * WR + mi * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8,
                          kk * 2 + (lane >> 4)));
    }
    const bf16* kt = ks + (j % kStages) * kBK * D;
    const bf16* vt = vs + (j % kStages) * kBK * D;
    const int t0 = j * kBK;

    // S = Q K^T: per m-tile 16 rows x 64 keys, 8 blocks of 8 keys; each
    // K fragment feeds every m-tile
    float sc[KM][8][4];
#pragma unroll
    for (int mi = 0; mi < KM; ++mi)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        sc[mi][n][0] = sc[mi][n][1] = sc[mi][n][2] = sc[mi][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t kf[4];
        tiles::ldmatrix_x4(kf, kt + Sw::at(n2 * 16 + (lane & 7) + (lane >> 4) * 8,
                                           kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int mi = 0; mi < KM; ++mi) {
          tiles::mma_bf16(sc[mi][2 * n2], qf[mi][kk], kf[0], kf[1]);
          tiles::mma_bf16(sc[mi][2 * n2 + 1], qf[mi][kk], kf[2], kf[3]);
        }
      }
    }

    // scores in log2 units; mask only where the tile crosses the diagonal
    const bool masked = t0 + kBK - 1 > q0 + offset;
#pragma unroll
    for (int mi = 0; mi < KM; ++mi) {
      float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[mi][n][e] * scale2;
          if (masked) {
            const int t = t0 + n * 8 + 2 * tq + (e & 1);
            const int i = row_lo + mi * 16 + (e >> 1) * 8;
            if (t > i + offset || t >= Tk) x = kNegInf;
          }
          sc[mi][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = tiles::exp2_approx(m[mi][r] - mx[r]);
        m[mi][r] = mx[r];
        l[mi][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[mi][n][e];
          const float p =
              x == kNegInf ? 0.f : tiles::exp2_approx(x - m[mi][e >> 1]);
          sc[mi][n][e] = p;
          l[mi][e >> 1] += p;
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        o[mi][n][0] *= alpha[0];
        o[mi][n][1] *= alpha[0];
        o[mi][n][2] *= alpha[1];
        o[mi][n][3] *= alpha[1];
      }
    }

    // O += P V: P's C fragments are the A fragments of 16-key slices;
    // each V fragment feeds every m-tile
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      uint32_t pa[KM][4];
#pragma unroll
      for (int mi = 0; mi < KM; ++mi) {
        pa[mi][0] = tiles::pack_bf16(sc[mi][2 * k2][0], sc[mi][2 * k2][1]);
        pa[mi][1] = tiles::pack_bf16(sc[mi][2 * k2][2], sc[mi][2 * k2][3]);
        pa[mi][2] =
            tiles::pack_bf16(sc[mi][2 * k2 + 1][0], sc[mi][2 * k2 + 1][1]);
        pa[mi][3] =
            tiles::pack_bf16(sc[mi][2 * k2 + 1][2], sc[mi][2 * k2 + 1][3]);
      }
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t vf[4];
        tiles::ldmatrix_x4_trans(
            vf, vt + Sw::at(k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            dd * 2 + (lane >> 4)));
#pragma unroll
        for (int mi = 0; mi < KM; ++mi) {
          tiles::mma_bf16(o[mi][2 * dd], pa[mi], vf[0], vf[1]);
          tiles::mma_bf16(o[mi][2 * dd + 1], pa[mi], vf[2], vf[3]);
        }
      }
    }
  }
  tiles::cp_async_wait<0>();

  // epilogue: 1/l (0 where l == 0), bf16 through this warp's Q rows
  __syncwarp();
#pragma unroll
  for (int mi = 0; mi < KM; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mi][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
      const int row = warp * WR + mi * 16 + gq + r * 8;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        *reinterpret_cast<uint32_t*>(qs + Sw::at(row, n) + 2 * tq) =
            tiles::pack_bf16(o[mi][n][2 * r] * inv,
                             o[mi][n][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  for (int i = lane; i < WR * NB; i += 32) {
    const int r = i / NB, c = i % NB;
    const int qi = q0 + warp * WR + r;
    if (qi < S)
      *reinterpret_cast<uint4*>(ob + (long long)qi * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(qs + Sw::at(warp * WR + r, c));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           const Dims& g, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;      // once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int BQ = block_rows<D>();
  const dim3 grid(g.heads, batch, (g.q_len + BQ - 1) / BQ);
  flash_prefill_tc_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 route: the first design, on CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // keys per tile

// Shared memory (floats) one block needs; the host computes the same sum.
__host__ __device__ constexpr int smem_floats(int D) {
  return kBQ * D                 // qs [kBQ][D]
         + kBK * (D + 1)         // ks [kBK][D+1]
         + kBK * D               // vs [kBK][D]
         + kBQ * (kBK + 1)       // ps [kBQ][kBK+1]
         + 3 * kBQ;              // m, l, alpha
}

// One block per (q tile of 64 rows, head, batch row): Q staged in shared
// memory, K/V tiles walked up to the causal diagonal (keys padded by one
// float per row), one thread per (row, key) score, one warp per row for
// the softmax statistics, the accumulator in registers for a fixed
// column d and rows strided by 256 / D.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         const Dims g) {
  extern __shared__ float smem[];
  constexpr int kRows = kThreads / D;          // accumulator row stride
  constexpr int kAcc = kBQ / kRows;            // accumulator registers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, b = blockIdx.z;
  const int S = g.q_len, Tk = g.kv_len, H = g.heads, KV = g.kv_heads;
  const int kvh = head / (H / KV);
  const int offset = Tk - S;

  float* qs = smem;
  float* ks = qs + kBQ * D;
  float* vs = ks + kBK * (D + 1);
  float* ps = vs + kBK * D;
  float* m = ps + kBQ * (kBK + 1);
  float* l = m + kBQ;
  float* alpha = l + kBQ;

  const long long q_row = (long long)H * D;
  const long long kv_row = (long long)KV * D;
  const float* qb = q + (long long)b * S * q_row + (long long)head * D;
  float* ob = out + (long long)b * S * q_row + (long long)head * D;
  const float* kb = k + (long long)b * Tk * kv_row + (long long)kvh * D;
  const float* vb = v + (long long)b * Tk * kv_row + (long long)kvh * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = q0 + r < S ? qb[(long long)(q0 + r) * q_row + d] : 0.f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int dcol = tid % D, r0 = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  // keys any row of this tile may see: t <= q0 + kBQ - 1 + offset, t < Tk
  const int t_end = min(Tk, q0 + kBQ + offset);
  for (int t0 = 0; t0 < t_end; t0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool ok = t0 + r < Tk;
      const long long at = (long long)(t0 + r) * kv_row + d;
      ks[r * (D + 1) + d] = ok ? kb[at] : 0.f;
      vs[r * D + d] = ok ? vb[at] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int qi = q0 + r, t = t0 + c;
      float s = kNegInf;
      if (qi < S && t < Tk && t <= qi + offset) {
        const float* qr = qs + r * D;
        const float* kr = ks + c * (D + 1);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          s0 += qr[d] * kr[d];
          s1 += qr[d + 1] * kr[d + 1];
          s2 += qr[d + 2] * kr[d + 2];
          s3 += qr[d + 3] * kr[d + 3];
        }
        s = ((s0 + s1) + (s2 + s3)) * g.scale;
      }
      ps[r * (kBK + 1) + c] = s;
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kWarps) {
      float* row = ps + r * (kBK + 1);
      const float m_prev = m[r];
      float m_cur = m_prev;
      for (int c = lane; c < kBK; c += 32) m_cur = fmaxf(m_cur, row[c]);
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      float sum = 0.f;
      for (int c = lane; c < kBK; c += 32) {
        const float e = row[c] == kNegInf ? 0.f : expf(row[c] - m_cur);
        row[c] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_cur);
        l[r] = l[r] * a + sum;
        m[r] = m_cur;
        alpha[r] = a;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] *= alpha[r0 + j * kRows];
    for (int c = 0; c < kBK; ++c) {
      const float vv = vs[c * D + dcol];
#pragma unroll
      for (int j = 0; j < kAcc; ++j)
        acc[j] += ps[(r0 + j * kRows) * (kBK + 1) + c] * vv;
    }
  }
  __syncthreads();     // l is complete even when no tile ran

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = r0 + j * kRows;
    if (q0 + r < S) {
      const float lv = l[r];
      ob[(long long)(q0 + r) * q_row + dcol] = lv == 0.f ? 0.f : acc[j] / lv;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           const Dims& g, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * (size_t)smem_floats(D);
  static bool configured = false;
  if (bytes > 48 * 1024 && !configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((g.q_len + kBQ - 1) / kBQ, g.heads, batch);
  flash_prefill_f32_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace f32

using LaunchFn = int (*)(const void*, const void*, const void*, void*, int,
                         const Dims&, cudaStream_t);

// by_dim: the route's launcher for D = 16, 32, 64, 128.
int dispatch(const LaunchFn (&by_dim)[4], int head_dim, const void* q,
             const void* k, const void* v, void* out, int batch, int q_len,
             int kv_len, int heads, int kv_heads, float scale, void* stream) {
  if (kv_len < q_len || kv_heads <= 0 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const int at = head_dim == 16 ? 0 : head_dim == 32 ? 1
               : head_dim == 64 ? 2 : head_dim == 128 ? 3 : -1;
  if (at < 0) return (int)cudaErrorInvalidValue;
  const Dims g{q_len, kv_len, heads, kv_heads, scale};
  return by_dim[at](q, k, v, out, batch, g,
                    static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, k, v, out: bf16, contiguous, 16-byte aligned.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int batch, int q_len, int kv_len,
                                  int heads, int kv_heads, int head_dim,
                                  float scale, void* stream) {
  static const LaunchFn by_dim[4] = {tc::launch<16>, tc::launch<32>,
                                     tc::launch<64>, tc::launch<128>};
  return dispatch(by_dim, head_dim, q, k, v, out, batch, q_len, kv_len,
                  heads, kv_heads, scale, stream);
}

// q, k, v, out: float32, contiguous.
extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 void* out, int batch, int q_len, int kv_len,
                                 int heads, int kv_heads, int head_dim,
                                 float scale, void* stream) {
  static const LaunchFn by_dim[4] = {f32::launch<16>, f32::launch<32>,
                                     f32::launch<64>, f32::launch<128>};
  return dispatch(by_dim, head_dim, q, k, v, out, batch, q_len, kv_len,
                  heads, kv_heads, scale, stream);
}
