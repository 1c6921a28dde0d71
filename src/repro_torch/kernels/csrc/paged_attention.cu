// Decode attention for Hopper (sm_90a): paged GQA, paged absorbed MLA and
// GQA over a contiguous cache.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   * paged_gqa_decode_bf16 / _f32       <- _paged_kernel      (:121,
//                                           pallas_call :203)
//   * paged_mla_decode_bf16 / _f32       <- _paged_mla_kernel  (:225,
//                                           pallas_call :304)
//   * contiguous_gqa_decode_bf16 / _f32  <- _decode_kernel     (:35,
//                                           pallas_call :110)
//
// What they compute (one new token per sequence):
//   s(t)  = (q * scale) . k_t       for t < length
//   out   = sum_t softmax(s)_t v_t  (online softmax, m / l / acc in f32)
// with every guard of the TPU kernels: pages whose id is < 0 are skipped,
// positions at or past `length` are never read, their scores are -1e30
// and contribute exactly 0, and a row with no valid position (l == 0,
// length 0 included) writes 0.  q * scale is computed in f32 and rounded
// to q's type before the dot, inside every kernel, as the TPU wrappers
// fold the scale (paged_attention.py:92,183,284).
//
// Layout.  The paged kernels read the FLAT pool [n_pages, page_elems] in
// place: token t of page p starts at  pool + p * page_elems + t * per_tok.
//   GQA: a token is [2, KV, D] (K heads, then V heads); query head h reads
//        kv head h / G, G = H / KV.
//   MLA: a token is [r + rp] (latent | rope key); the score dot runs over
//        the whole row and the value is the latent prefix [:r].
// Typed views of the pool (pool[:, :tpp * per_tok].reshape(...)) would
// copy the whole pool whenever a page has slack (MLA: 28 * 288 < 8192),
// so the kernels compute their own addresses.  Each block loads its own
// page ids and length: that replaces the TPU's scalar prefetch.  The
// contiguous entry points are the GQA kernels under another addressing
// policy: K and V are two tensors [B, T, KV, D], read as if row b were one
// page of T tokens of KV * D elements (no table: page id = b).
//
// Bound.  Decode attention reads each valid KV token once:
//   B * length * per_tok * itemsize bytes at 3.35 TB/s (H100 SXM); its
//   2 * H * length * (k_dim + v_dim) flops are far below any peak.  At the
//   split path's shape (qwen3-moe: H 64, KV 4, D 128, 8 tokens a page;
//   B = 4, context 1024, bf16) that is 8.4 MB, 2.5 us; at B = 1, context
//   8192, 16.8 MB, 5.0 us; zamba2's contiguous cache (H = KV = 32, D = 64)
//   at B = 4, T = 1024: 33.6 MB, 10 us; minicpm3's MLA rows (288 bf16,
//   28 tokens a 16 KiB page) at B = 4, context 1024: 2.4 MB, 0.7 us, at
//   context 8192: 18.9 MB, 5.6 us.
//
// What the first GQA design lost: one block per (kv head, batch
// row) walked the whole context, so qwen3-moe ran 16 blocks at B = 4 and
// 4 at B = 1 on 132 SMs; every tile was staged through registers into f32
// shared memory with no copy overlapping math, and scores and P.V were
// scalar loops over shared memory: 0.35 ms at B = 4, ~140x its bound.
//
// bf16 GQA route (split namespace), flash-decoding:
//   * grid (kv head x head group, batch row, split).  The split count comes
//     from host-known shapes only (B, KV, the table's token capacity, the
//     SM count; kernels/paged_attention.py kv_splits), never from
//     `lengths`: split s covers the whole 64-token tiles [s * n / S,
//     (s + 1) * n / S) of the n the table can address, and one that starts
//     at or past its row's length writes m = -1e30, l = 0 (or, unsplit,
//     the 0 output) and exits.  With splits > 1 the block writes
//     f32 partials (acc [B,H,S,D], m and l [B,H,S], allocated by the
//     wrapper) and merge_splits_kernel combines them; with one split the
//     block writes `out` and there is no second launch;
//   * each of the block's 4 warps owns 16 tokens of every tile and copies
//     their K and V rows with 16-byte cp.async.cg into its own 3-stage
//     bf16 ring (swizzled; tokens past `length` or on pages < 0 are
//     zero-filled with src-size 0 and never read from memory, so NaN past
//     a length cannot reach a tensor-core product), the next two tiles in
//     flight while one is computed; page ids are read one tile ahead;
//     warps need only __syncwarp, and merge their (m, l, acc) at the end;
//   * G >= 8 (qwen3-moe, G = 16): scores and P.V on mma.sync.m16n8k16
//     with the (up to 16) query heads of the kv head as the 16 rows;
//     G < 8 (moonshot and zamba2 are MHA, G = 1): bf16x2 products on CUDA
//     cores, 8 lanes per token and 4 tokens per step, up to 4 heads per
//     block (tensor cores would waste most of the tile);
//   * head dims 8 (the smoke configs'; CUDA cores only: m16n8k16 steps k
//     by 16), 16, 32, 64 and 128;
//   * the wrapper makes no host read and no allocation beyond
//     torch.empty, so a call can be captured in a CUDA graph.
// bf16 MLA route (mla namespace), the same flash-decoding over the latent
// row that all heads share:
//   * grid (group of 16 heads, batch row, split); minicpm3's 40 heads take
//     three groups, the last one's rows 40-47 empty.  The split count is
//     the GQA route's (kernels/paged_attention.py mla_split_plan), the
//     partials [B,H,S,r] merge in the same body (mla_merge_splits_kernel,
//     its own name so a profile tells the two routes apart), and one
//     split writes `out` with no second launch;
//   * each of the 4 warps copies its 16 tokens of a 64-token tile into one
//     block-wide 2-stage ring (a token row is 288 bf16 = 576 bytes, so a
//     stage is 37 KB with the row padding; two stages keep two blocks on
//     an SM, and a split holds 1-6 tiles at the timed shapes, so a deeper
//     ring would only lengthen the prologue); page ids are read one tile
//     ahead, tokens past the length or on pages < 0 are zero-filled;
//   * scores on mma.sync.m16n8k16: the 16 heads are the A rows, from q
//     staged once in shared memory (scaled, rounded, zero past E); K is
//     read straight from the ring rows, which lie along the reduction
//     (ldmatrix, no transpose): 18 k-steps at r + rp = 288, 5 at 80, 2 at
//     24 (its k padded to 32 with zero columns in q and the ring);
//   * a warp that owned its tokens' whole P.V would hold a 16 x 256 f32
//     accumulator (128 registers a lane).  So warps split tokens for the
//     scores, the tile's row maximum is combined through shared memory,
//     P goes to shared memory as bf16, and warps then split the VALUE
//     COLUMNS for P.V (r / 4 = 64 columns, 32 accumulator registers, V by
//     ldmatrix.trans from the ring rows' latent prefix).  At r = 16 the
//     four warps split the tile's tokens instead and add their
//     accumulators at the end (the row maximum is common, so they add);
//   * rows of q and the ring are an odd number of 16-byte chunks apart
//     (296 elements at 288), so 8 rows of one ldmatrix phase fall on 8
//     distinct bank groups; three barriers a tile;
//   * the wrapper makes no host read and no allocation beyond
//     torch.empty (graph-capturable, as GQA).
//   Times (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700 W, median of
//   20, L2 flushed): minicpm3 0.0174 / 0.0203 ms at context 1024, B = 1 /
//   4, and 0.0247 / 0.0347 ms at 8192 (the first design: 0.35 / 0.35 /
//   2.65 / 2.65 ms).
// f32 GQA and f32 MLA: the first design (paged_decode_block), one block
// per (kv head or group of 8 MLA heads, batch row) over the whole
// context, f32 tiles in shared memory, CUDA cores; it holds the card
// against the CPU at 2e-5.  Its bf16 MLA instance ran minicpm3 at 0.3455
// ms (B = 4, context 1024) and 2.63 ms (context 8192, B = 1 and 4): 5 or
// 20 blocks on 132 SMs, time linear in the context.
//
// ptxas (-Xptxas -v, sm_90a): no stack and no
// spills in any kernel.  split_decode_kernel<D, R> registers:
//            R = 16 (tensor cores)   R = 1    R = 2    R = 4
//   D = 128          168               80      128      236
//   D =  64          124               56       72      128
//   D =  32           64               40       64       80
//   D =  16           48               40       40       64
//   D =   8           --               32       40       48
// shared memory (dynamic): the ring, 3 * 4 * 2 * 16 * D * 2 bytes = 96 /
// 48 / 24 / 12 / 6 KB for D = 128 / 64 / 32 / 16 / 8 (two blocks fit an
// SM at D = 128).  merge_splits_kernel and mla_merge_splits_kernel: 32
// registers.  mla_split_decode_kernel<r, rp>: 125 / 67 / 48 registers at
// (256, 32) / (64, 16) / (16, 8); dynamic shared memory 86 / 27.5 / 14 KB
// (ring, q, P, row maxima and sums).  The first design (f32 only now): 40
// (scalar) / 64 (16-byte) registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// Each entry point returns cudaGetLastError() after its launch(es)
// (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// The first design: f32 GQA and MLA
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;               // loads in flight per thread
constexpr int kMlaHeadsPerBlock = 8;
constexpr int kMaxTile = 64;             // tokens per tile
constexpr int kSmemLimit = 200 * 1024;   // of the 227 KB a block may use
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// VEC elements loaded by one instruction (16 bytes when VEC * sizeof(T)
// is 16 and every row start is 16-byte aligned; else one element).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Where one block finds its query heads and its key / value rows.
struct Geometry {
  int heads;            // query heads of the layer (H)
  int heads_per_block;  // query heads one block serves
  int k_dim;            // key row length: the score dot product
  int v_dim;            // value row length: the output width
  int k_base;           // key row offset in a token: k_base + bx * k_step
  int k_step;
  int v_base;           // value row offset in a token: v_base + bx * v_step
  int v_step;
  int kv_shared;        // 1: the value row is the key row's prefix (MLA)
  int tokens_per_page;
  int per_tok;          // elements one token occupies in a page
  long long page_elems;
  int max_pages;        // page table width
  int tile;             // tokens per tile (<= kMaxTile)
  float q_scale;        // q * q_scale, rounded to T, before the dot
};

// q and key rows sit in shared memory with one float of padding, so the
// threads of a warp (consecutive tokens, or heads) hit distinct banks.
__host__ __device__ inline int row_stride(int dim) { return dim + 1; }

// Shared memory (floats) one block needs; the host computes the same sum.
__host__ __device__ inline int smem_floats(const Geometry& g) {
  const int hpb = g.heads_per_block, tt = g.tile;
  const int ks = row_stride(g.k_dim);
  return hpb * ks + tt * ks + (g.kv_shared ? 0 : tt * g.v_dim) +
         hpb * g.v_dim + hpb * tt + 3 * hpb + tt;
}

// Copy `dim` elements at offset `off` of every token of the tile into
// dst[t * stride + ...] as f32 (zeros for tokens whose page is -1).
template <typename T, int VEC>
__device__ __forceinline__ void load_rows(
    float* __restrict__ dst, int stride, const T* __restrict__ pool,
    const int* __restrict__ tile_page, int t0, int dim, int off,
    const Geometry& g) {
  using P = Pack<T, VEC>;
  const int vecs = dim / VEC;
  const int units = g.tile * vecs;
  for (int base = threadIdx.x; base < units; base += kThreads * kUnroll) {
    P regs[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = base + j * kThreads;
      int page = -1, t = 0, vj = 0;
      if (u < units) {
        t = u / vecs;
        vj = u - t * vecs;
        page = tile_page[t];
      }
      if (page >= 0) {
        const size_t slot = (size_t)((t0 + t) % g.tokens_per_page);
        regs[j] = *reinterpret_cast<const P*>(
            pool + (size_t)page * g.page_elems + slot * g.per_tok + off +
            vj * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) regs[j].v[e] = from_f32<T>(0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = base + j * kThreads;
      if (u < units) {
        const int t = u / vecs;
        float* row = dst + t * stride + (u - t * vecs) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) row[e] = to_f32(regs[j].v[e]);
      }
    }
  }
}

// `kpool` holds the key rows and `vpool` the value rows (the same pool
// for the paged kernels); a null `table` means page id = batch row.
template <typename T, int VEC>
__device__ __forceinline__ void paged_decode_block(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out,
    const Geometry& g) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int hpb = g.heads_per_block, tt = g.tile;
  const int h0 = blockIdx.x * hpb;
  const int nh = min(hpb, g.heads - h0);
  const int k_stride = row_stride(g.k_dim);
  const int v_stride = g.kv_shared ? k_stride : g.v_dim;

  float* qs = smem;                                        // [hpb][k_stride]
  float* ks = qs + hpb * k_stride;                         // [tt][k_stride]
  float* vs = g.kv_shared ? ks : ks + tt * k_stride;       // [tt][v_stride]
  float* acc = ks + tt * k_stride + (g.kv_shared ? 0 : tt * g.v_dim);
  float* sc = acc + hpb * g.v_dim;                         // [hpb][tt]
  float* m = sc + hpb * tt;
  float* l = m + hpb;
  float* alpha = l + hpb;
  int* tile_page = reinterpret_cast<int*>(alpha + hpb);    // [tt]

  const int length = min(lengths[b], g.max_pages * g.tokens_per_page);
  for (int i = tid; i < hpb * g.k_dim; i += kThreads) {
    const int hh = i / g.k_dim, d = i % g.k_dim;
    qs[hh * k_stride + d] = hh < nh
        ? to_f32(from_f32<T>(
              to_f32(q[((size_t)b * g.heads + h0 + hh) * g.k_dim + d]) *
              g.q_scale))
        : 0.f;
  }
  for (int i = tid; i < hpb * g.v_dim; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < hpb; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int k_off = g.k_base + blockIdx.x * g.k_step;
  const int v_off = g.v_base + blockIdx.x * g.v_step;
  for (int t0 = 0; t0 < length; t0 += tt) {
    // the tile's page ids: -1 for unmapped pages and positions >= length
    for (int t = tid; t < tt; t += kThreads) {
      const int pos = t0 + t;
      tile_page[t] = pos >= length ? -1
          : table ? table[(size_t)b * g.max_pages + pos / g.tokens_per_page]
                  : b;
    }
    __syncthreads();
    load_rows<T, VEC>(ks, k_stride, kpool, tile_page, t0, g.k_dim, k_off, g);
    if (!g.kv_shared)
      load_rows<T, VEC>(vs, v_stride, vpool, tile_page, t0, g.v_dim, v_off,
                        g);
    __syncthreads();

    // scores: one thread per (head, token) pair, four partial sums
    for (int pr = tid; pr < hpb * tt; pr += kThreads) {
      const int hh = pr / tt, t = pr - hh * tt;
      float s = kNegInf;
      if (tile_page[t] >= 0) {
        const float* qr = qs + hh * k_stride;
        const float* kr = ks + t * k_stride;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int d = 0;
        for (; d + 4 <= g.k_dim; d += 4) {
          s0 += qr[d] * kr[d];
          s1 += qr[d + 1] * kr[d + 1];
          s2 += qr[d + 2] * kr[d + 2];
          s3 += qr[d + 3] * kr[d + 3];
        }
        for (; d < g.k_dim; ++d) s0 += qr[d] * kr[d];
        s = (s0 + s1) + (s2 + s3);
      }
      sc[hh * tt + t] = s;
    }
    __syncthreads();

    // online-softmax statistics: one warp per head, lanes over the tile
    for (int hh = warp; hh < hpb; hh += kWarps) {
      float* row = sc + hh * tt;
      const float m_prev = m[hh];
      float m_cur = m_prev;
      for (int t = lane; t < tt; t += 32) m_cur = fmaxf(m_cur, row[t]);
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      float sum = 0.f;
      for (int t = lane; t < tt; t += 32) {
        const float e = tile_page[t] >= 0 ? expf(row[t] - m_cur) : 0.f;
        row[t] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_cur);
        l[hh] = l[hh] * a + sum;
        m[hh] = m_cur;
        alpha[hh] = a;
      }
    }
    __syncthreads();

    for (int i = tid; i < hpb * g.v_dim; i += kThreads) {
      const int hh = i / g.v_dim, d = i - hh * g.v_dim;
      const float* pr = sc + hh * tt;
      const float* vc = vs + d;
      float a0 = 0.f, a1 = 0.f;
      int t = 0;
      for (; t + 2 <= tt; t += 2) {
        a0 += pr[t] * vc[t * v_stride];
        a1 += pr[t + 1] * vc[(t + 1) * v_stride];
      }
      if (t < tt) a0 += pr[t] * vc[t * v_stride];
      acc[i] = acc[i] * alpha[hh] + (a0 + a1);
    }
    __syncthreads();
  }
  __syncthreads();     // l is complete even when no tile ran (length 0)

  for (int i = tid; i < nh * g.v_dim; i += kThreads) {
    const int hh = i / g.v_dim, d = i % g.v_dim;
    const float lv = l[hh];
    out[((size_t)b * g.heads + h0 + hh) * g.v_dim + d] =
        from_f32<T>(lv == 0.f ? 0.f : acc[i] / lv);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
paged_gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        const Geometry g) {
  paged_decode_block<T, VEC>(q, kpool, vpool, table, lengths, out, g);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
paged_mla_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        const Geometry g) {
  paged_decode_block<T, VEC>(q, kpool, vpool, table, lengths, out, g);
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, const int*,
                          const int*, T*, const Geometry);

// Largest tile whose shared memory fits the limit.
inline int pick_tile(Geometry g) {
  for (g.tile = kMaxTile; g.tile > 1; g.tile /= 2)
    if (sizeof(float) * (size_t)smem_floats(g) <= (size_t)kSmemLimit) break;
  return g.tile;
}

template <typename T>
bool vectorizable(const void* kpool, const void* vpool, const Geometry& g) {
  constexpr int vec = 16 / sizeof(T);
  const long long elems[] = {g.k_dim, g.v_dim, g.k_base, g.k_step, g.v_base,
                             g.v_step, g.per_tok, g.page_elems};
  for (long long e : elems)
    if (e % vec) return false;
  return reinterpret_cast<uintptr_t>(kpool) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(vpool) % 16 == 0;
}

template <typename T>
int launch(KernelFn<T> kernel, const void* q, const void* kpool,
           const void* vpool, const int* table, const int* lengths,
           void* out, int batch, int grid_x, const Geometry& g,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(g);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(grid_x, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), table, lengths, static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T, bool kMla>
int dispatch(const void* q, const void* kpool, const void* vpool,
             const int* table, const int* lengths, void* out, int batch,
             int grid_x, Geometry g, cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  g.tile = pick_tile(g);
  if (vectorizable<T>(kpool, vpool, g))
    return launch<T>(kMla ? paged_mla_decode_kernel<T, vec>
                          : paged_gqa_decode_kernel<T, vec>,
                     q, kpool, vpool, table, lengths, out, batch, grid_x, g,
                     stream);
  return launch<T>(kMla ? paged_mla_decode_kernel<T, 1>
                        : paged_gqa_decode_kernel<T, 1>,
                   q, kpool, vpool, table, lengths, out, batch, grid_x, g,
                   stream);
}

// GQA geometry shared by the paged and the contiguous entry points.
Geometry gqa_geometry(int heads, int kv_heads, int head_dim,
                      float scale) {
  Geometry g;
  g.heads = heads;
  g.heads_per_block = heads / kv_heads;
  g.k_dim = head_dim;
  g.v_dim = head_dim;
  g.k_base = 0;
  g.k_step = head_dim;
  g.v_base = 0;
  g.v_step = head_dim;
  g.kv_shared = 0;
  g.tile = kMaxTile;
  g.q_scale = scale;
  return g;
}


// ---------------------------------------------------------------------------
// bf16 GQA route: split-KV over a cp.async ring
// ---------------------------------------------------------------------------

namespace split {

using tiles::bf16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpTokens = 16;               // tokens per warp per tile
constexpr int kTile = kWarps * kWarpTokens;   // tokens per tile (64)
constexpr int kStages = 3;                    // tiles in each warp's ring
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;             // [B, H, D]
  const bf16* kbuf;          // key rows: kbuf + page * page_elems +
  const bf16* vbuf;          //   slot * per_tok + k_off + kv_head * D
  const int* table;          // [B, max_pages]; null: page id = batch row
  const int* lengths;        // [B]
  bf16* out;                 // [B, H, D]
  float* part_acc;           // [B, H, splits, D]   (splits > 1)
  float* part_m;             // [B, H, splits], log2 units
  float* part_l;             // [B, H, splits]
  int heads, group;          // H, G = H / KV
  int head_groups;           // blocks per kv head: ceil(G / rows)
  int tokens_per_page, per_tok, max_pages;
  long long page_elems;
  int k_off, v_off;
  int splits, tiles;          // split s: tiles [s * tiles / splits,
  float scale;                //   (s + 1) * tiles / splits) of 64 tokens
};

// Per warp and stage: K rows [16][D] then V rows [16][D], swizzled.  The
// ring is reused, once every copy has landed, for the warps' partial
// (m, l, acc) of R rows each.
template <int D, int R>
constexpr int smem_bytes() {
  constexpr int ring = kStages * kWarps * 2 * kWarpTokens * D * 2;
  constexpr int merge = kWarps * R * (D + 2) * 4;
  return ring > merge ? ring : merge;
}

// f32(q) * scale rounded to bf16, as the wrappers of the TPU kernels fold
// the scale (src/repro/kernels/paged_attention.py:92,183).
__device__ __forceinline__ float2 scaled_pair(const bf16* p, float scale) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return __bfloat1622float2(__floats2bfloat162_rn(f.x * scale, f.y * scale));
}

// f32(q) * scale rounded to bf16, one element (D = 8: one per lane).
__device__ __forceinline__ float scaled_one(const bf16* p, float scale) {
  return __bfloat162float(__float2bfloat16(__bfloat162float(*p) * scale));
}

// Tokens [x, y) of `split`: the whole tiles [split * tiles / splits,
// (split + 1) * tiles / splits), capped at what the table addresses.
__device__ __forceinline__ int2 split_range(int split, int splits, int tiles,
                                            int max_tokens) {
  return make_int2(
      (int)((long long)split * tiles / splits) * kTile,
      min(max_tokens, (int)((long long)(split + 1) * tiles / splits) * kTile));
}

// A split that holds none of its row's tokens: with one split the rows'
// output is 0, else the split leaves an empty partial (m = -1e30, l = 0)
// that the merge drops.
__device__ __forceinline__ void write_empty_split(
    bf16* out, float* part_m, float* part_l, long long row0, int rows,
    int width, int splits, int split) {
  if (splits == 1) {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x)
      out[row0 * width + i] = __float2bfloat16(0.f);
  } else {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      part_m[(row0 + r) * splits + split] = kNegInf;
      part_l[(row0 + r) * splits + split] = 0.f;
    }
  }
}

// E consecutive elements (E = D / 8) of row `tok`, from element e0 on, as
// f32.
template <int D, int E>
__device__ __forceinline__ void load_row(float (&x)[E], const bf16* tile,
                                         int tok, int e0) {
  using Sw = tiles::Swizzle<D>;
  if constexpr (E == 1) {
    x[0] = __bfloat162float(tile[Sw::at(tok, e0 / 8) + e0 % 8]);
  } else if constexpr (E >= 8) {
#pragma unroll
    for (int c = 0; c < E / 8; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          tile + Sw::at(tok, e0 / 8 + c));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[c * 8 + 2 * i] = f.x;
        x[c * 8 + 2 * i + 1] = f.y;
      }
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(
        tile + Sw::at(tok, e0 / 8) + e0 % 8);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// One block per (kv head x head group, batch row, split); each of its 4
// warps walks 16 tokens of every 64-token tile of the split through its own
// ring, with its own online softmax, and the block merges the 4 at the end.
// R = query rows per block: 16 -> tensor cores (mma.sync, the G heads as
// rows), 1 / 2 / 4 -> bf16x2 products on CUDA cores (8 lanes per token).
template <int D, int R>
__global__ void __launch_bounds__(kThreads)
split_decode_kernel(const Args a) {
  using Sw = tiles::Swizzle<D>;
  constexpr bool kTc = R == 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x / a.head_groups;
  const int g0 = (blockIdx.x % a.head_groups) * R;
  const int b = blockIdx.y, split = blockIdx.z;
  const int nh = min(R, a.group - g0);                 // rows served
  const long long row0 = (long long)b * a.heads + kvh * a.group + g0;
  const int max_tokens = a.max_pages * a.tokens_per_page;
  const int2 range = split::split_range(split, a.splits, a.tiles, max_tokens);
  const int start = range.x, cap = range.y;
  const bf16* kbase = a.kbuf + a.k_off + kvh * D;
  const bf16* vbase = a.vbuf + a.v_off + kvh * D;
  auto slot = [&](int stage) {
    return ring + (stage * kWarps + warp) * 2 * kWarpTokens * D;
  };

  // page id of lane's token (lanes < 16) of tile jt of the split, -1 past
  // what the table addresses; needs no length, so it is read while the
  // length is
  auto page_of = [&](int jt) -> int {
    const int pos = start + jt * kTile + warp * kWarpTokens + lane;
    if (lane >= kWarpTokens || pos >= cap) return -1;
    return a.table ? a.table[(long long)b * a.max_pages +
                             pos / a.tokens_per_page]
                   : b;
  };
  int pages[kStages];
#pragma unroll
  for (int st = 0; st < kStages; ++st) pages[st] = page_of(st);
  const int length = max(0, min(a.lengths[b], max_tokens));
  const int end = min(length, cap);

  // q * scale rounded to bf16: the G heads as mma A fragments (rows past
  // nh are 0), or E elements of each of the R heads per lane
  const int gq = lane >> 2, tq = lane & 3;      // mma fragment coordinates
  const int gi = lane >> 3, li = lane & 7;      // CUDA-core token groups
  constexpr int E = D / 8;
  constexpr int TR = kTc ? 2 : R;               // rows a thread tracks
  uint32_t qf[kTc ? D / 16 : 1][4];
  float qv[kTc ? 1 : R][E];
  if constexpr (kTc) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gq + (i & 1) * 8, col = kk * 16 + 2 * tq + (i >> 1) * 8;
        float2 f = make_float2(0.f, 0.f);
        if (r < nh) f = scaled_pair(a.q + (row0 + r) * D + col, a.scale);
        qf[kk][i] = tiles::pack_bf16(f.x, f.y);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bf16* qr = a.q + (row0 + r) * D + li * E;
      if constexpr (E == 1) {
        qv[r][0] = r < nh ? scaled_one(qr, a.scale) : 0.f;
      } else {
#pragma unroll
        for (int e = 0; e < E; e += 2) {
          float2 f = make_float2(0.f, 0.f);
          if (r < nh) f = scaled_pair(qr + e, a.scale);
          qv[r][e] = f.x;
          qv[r][e + 1] = f.y;
        }
      }
    }
  }

  if (start >= end) {                 // nothing of this row in the split
    split::write_empty_split(a.out, a.part_m, a.part_l, row0, nh, D,
                             a.splits, split);
    return;
  }
  const int n_tiles = (end - start + kTile - 1) / kTile;

  // cp.async the warp's 16 K and V rows of tile jt; returns the mask of
  // tokens that hold data (the others, past the length or on pages < 0,
  // are zero-filled and never read)
  auto fetch = [&](int jt, int page) -> unsigned {
    const int pos = start + jt * kTile + warp * kWarpTokens + lane;
    const long long off =
        page < 0 || pos >= end
            ? -1
            : (long long)page * a.page_elems +
                  (long long)(pos % a.tokens_per_page) * a.per_tok;
    const unsigned mask = __ballot_sync(0xffffffffu, off >= 0) & 0xffffu;
    bf16* ks = slot(jt % kStages);
    bf16* vs = ks + kWarpTokens * D;
    constexpr int CT = D / 4;          // 16-byte chunks per token, K then V
#pragma unroll
    for (int it = 0; it < kWarpTokens * CT / 32; ++it) {
      const int idx = it * 32 + lane, tok = idx / CT, c = idx % CT;
      const long long o = __shfl_sync(0xffffffffu, off, tok);
      const bool is_v = c >= D / 8;
      const int cc = is_v ? c - D / 8 : c;
      const bf16* src = o < 0 ? a.kbuf : (is_v ? vbase : kbase) + o + cc * 8;
      tiles::cp_async_16((is_v ? vs : ks) + Sw::at(tok, cc), src, o >= 0);
    }
    return mask;
  };

  // prologue: the first kStages - 1 tiles in flight
  unsigned long long masks = 0;        // 16 bits per tile in flight
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      masks |= (unsigned long long)fetch(st, pages[st]) << (16 * st);
    tiles::cp_async_commit();
  }
  int page_next = pages[kStages - 1];

  float o[kTc ? D / 8 : R][kTc ? 4 : E];
  float m[TR], l[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (kTc ? D / 8 : R); ++i)
#pragma unroll
    for (int e = 0; e < (kTc ? 4 : E); ++e) o[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int jn = j + kStages - 1;
    if (jn < n_tiles)
      masks |= (unsigned long long)fetch(jn, page_next) << (16 * (kStages - 1));
    tiles::cp_async_commit();
    page_next = page_of(jn + 1);       // consumed by the next fetch
    tiles::cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned mask = (unsigned)(masks & 0xffffu);
    masks >>= 16;
    const bf16* kt = slot(j % kStages);
    const bf16* vt = kt + kWarpTokens * D;

    if constexpr (kTc) {
      // S = Q K^T: the G heads x 16 tokens
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4];
        tiles::ldmatrix_x4(kf, kt + Sw::at((lane & 7) + (lane >> 4) * 8,
                                           kk * 2 + ((lane >> 3) & 1)));
        tiles::mma_bf16(sc[0], qf[kk], kf[0], kf[1]);
        tiles::mma_bf16(sc[1], qf[kk], kf[2], kf[3]);
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = n * 8 + 2 * tq + (e & 1);
          const float x = (mask >> t) & 1u ? sc[n][e] * kLog2e : kNegInf;
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = tiles::exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sc[n][e] == kNegInf
                              ? 0.f
                              : tiles::exp2_approx(sc[n][e] - m[e >> 1]);
          sc[n][e] = p;
          l[e >> 1] += p;
        }
      }
      const uint32_t pa[4] = {tiles::pack_bf16(sc[0][0], sc[0][1]),
                              tiles::pack_bf16(sc[0][2], sc[0][3]),
                              tiles::pack_bf16(sc[1][0], sc[1][1]),
                              tiles::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        o[2 * dd][0] *= alpha[0];
        o[2 * dd][1] *= alpha[0];
        o[2 * dd][2] *= alpha[1];
        o[2 * dd][3] *= alpha[1];
        o[2 * dd + 1][0] *= alpha[0];
        o[2 * dd + 1][1] *= alpha[0];
        o[2 * dd + 1][2] *= alpha[1];
        o[2 * dd + 1][3] *= alpha[1];
        uint32_t vf[4];
        tiles::ldmatrix_x4_trans(
            vf, vt + Sw::at((lane & 7) + ((lane >> 3) & 1) * 8,
                            dd * 2 + (lane >> 4)));
        tiles::mma_bf16(o[2 * dd], pa, vf[0], vf[1]);
        tiles::mma_bf16(o[2 * dd + 1], pa, vf[2], vf[3]);
      }
    } else {
      // 4 steps of 4 tokens; lane group gi takes token 4 * step + gi, its
      // 8 lanes E elements each; scores reduced over the 8 lanes
      float s[R][4];
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const int t = 4 * st + gi;
        float kx[E];
        load_row<D, E>(kx, kt, t, li * E);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qv[r][e], kx[e], dot);
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          dot += __shfl_xor_sync(0xffffffffu, dot, 4);
          s[r][st] = (mask >> t) & 1u ? dot * kLog2e : kNegInf;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        mx = fmaxf(mx, m[r]);
        const float alpha = tiles::exp2_approx(m[r] - mx);
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) o[r][e] *= alpha;
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        float vx[E];
        load_row<D, E>(vx, vt, 4 * st + gi, li * E);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = s[r][st] == kNegInf
                              ? 0.f
                              : tiles::exp2_approx(s[r][st] - m[r]);
          l[r] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) o[r][e] = fmaf(p, vx[e], o[r][e]);
        }
      }
    }
    __syncwarp();                      // the stage is refilled next round
  }
  tiles::cp_async_wait<0>();

  // each warp's (m, l, acc) per row into shared memory, then merged
  if constexpr (kTc) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 8);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 16);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o[r][e] += __shfl_xor_sync(0xffffffffu, o[r][e], 8);
        o[r][e] += __shfl_xor_sync(0xffffffffu, o[r][e], 16);
      }
    }
  }
  __syncthreads();                     // every warp is done with the ring
  float* wm = reinterpret_cast<float*>(smem_raw);     // [kWarps][R]
  float* wl = wm + kWarps * R;                         // [kWarps][R]
  float* wo = wl + kWarps * R;                         // [kWarps][R][D]
  if constexpr (kTc) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = gq + 8 * r;
      if (tq == 0) {
        wm[warp * R + row] = m[r];
        wl[warp * R + row] = l[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(wo + (warp * R + row) * D + n * 8 + 2 * tq) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
  } else if (gi == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (li == 0) {
        wm[warp * R + r] = m[r];
        wl[warp * R + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) wo[(warp * R + r) * D + li * E + e] = o[r][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * R + r]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = wl[w * R + r];
      if (lw > 0.f) {
        const float f = tiles::exp2_approx(wm[w * R + r] - mx);
        lsum += f * lw;
        acc += f * wo[(w * R + r) * D + d];
      }
    }
    if (a.splits == 1) {
      a.out[(row0 + r) * D + d] =
          __float2bfloat16(lsum == 0.f ? 0.f : acc / lsum);
    } else {
      const long long at = (row0 + r) * a.splits + split;
      a.part_acc[at * D + d] = acc;
      if (d == 0) {
        a.part_m[at] = mx;
        a.part_l[at] = lsum;
      }
    }
  }
}

// out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s over the splits
// with l_s > 0 (M their largest m_s), and 0 where there is none.  One block
// of kMergeLanes x D threads per (batch row, head): the splits' m and l are
// staged in shared memory with one load each and their weights computed
// once; thread (p, d) sums column d over the splits s = p mod kMergeLanes,
// loads in flight together, and the kMergeLanes sums are added at the end.
// The MLA route launches the same body under its own name
// (mla::mla_merge_splits_kernel), so a profile tells the two apart.
constexpr int kMergeLanes = 4;

__device__ __forceinline__ void merge_splits(const float* __restrict__ acc,
                                             const float* __restrict__ m,
                                             const float* __restrict__ l,
                                             bf16* __restrict__ out,
                                             int splits) {
  extern __shared__ float stage[];     // w, l [splits]; num, den [lanes][D]
  const int D = blockDim.x / kMergeLanes;
  const int d = threadIdx.x % D, p = threadIdx.x / D;
  float* w = stage;
  float* ls = w + splits;
  float* nums = ls + splits;
  float* dens = nums + kMergeLanes * D;
  const long long row = blockIdx.x;
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    w[s] = m[row * splits + s];
    ls[s] = l[row * splits + s];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s)
    if (ls[s] > 0.f) mx = fmaxf(mx, w[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < splits; s += blockDim.x)
    w[s] = ls[s] > 0.f ? tiles::exp2_approx(w[s] - mx) : 0.f;
  __syncthreads();
  const float* col = acc + row * splits * D + d;
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = p; s < splits; s += kMergeLanes) {
    // read even where the weight is 0: a split with no token left its
    // acc unset, and the select drops it
    const float f = w[s], a = col[(long long)s * D];
    den = fmaf(f, ls[s], den);
    num += f != 0.f ? f * a : 0.f;
  }
  nums[p * D + d] = num;
  dens[p * D + d] = den;
  __syncthreads();
  if (p == 0) {
    for (int i = 1; i < kMergeLanes; ++i) {
      num += nums[i * D + d];
      den += dens[i * D + d];
    }
    out[row * D + d] = __float2bfloat16(den == 0.f ? 0.f : num / den);
  }
}

__global__ void merge_splits_kernel(const float* __restrict__ acc,
                                    const float* __restrict__ m,
                                    const float* __restrict__ l,
                                    bf16* __restrict__ out, int splits) {
  merge_splits(acc, m, l, out, splits);
}

// Shared memory of a merge launch over D columns.
inline size_t merge_bytes(int splits, int D) {
  return sizeof(float) * (2 * splits + 2 * kMergeLanes * D);
}

using LaunchFn = int (*)(const Args&, int, int, cudaStream_t);

template <int D, int R>
int launch(const Args& a, int kv_heads, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, R>();
  static bool configured = false;      // once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        split_decode_kernel<D, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(kv_heads * a.head_groups, batch, a.splits);
  split_decode_kernel<D, R><<<grid, kThreads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  merge_splits_kernel<<<batch * a.heads, kMergeLanes * D,
                        merge_bytes(a.splits, D), stream>>>(
      a.part_acc, a.part_m, a.part_l, a.out, a.splits);
  return (int)cudaGetLastError();
}

// D = 8 (the smoke configs' head dim) has no tensor-core route: m16n8k16
// takes k in steps of 16.
template <int D>
LaunchFn pick_rows(int rows) {
  if constexpr (D >= 16)
    if (rows == 16) return launch<D, 16>;
  switch (rows) {
    case 4: return launch<D, 4>;
    case 2: return launch<D, 2>;
    case 1: return launch<D, 1>;
    default: return nullptr;
  }
}

LaunchFn pick(int head_dim, int rows) {
  switch (head_dim) {
    case 8: return pick_rows<8>(rows);
    case 16: return pick_rows<16>(rows);
    case 32: return pick_rows<32>(rows);
    case 64: return pick_rows<64>(rows);
    case 128: return pick_rows<128>(rows);
    default: return nullptr;
  }
}

// The geometry shared by the paged and the contiguous entry points; the
// caller sets the addressing fields.
int run(Args a, int batch, int kv_heads, int head_dim, int rows,
        void* stream) {
  const LaunchFn fn = pick(head_dim, rows);
  if (fn == nullptr || kv_heads <= 0 || a.heads % kv_heads ||
      a.splits < 1 || a.splits > a.tiles ||
      (a.splits > 1 && !(a.part_acc && a.part_m && a.part_l)))
    return (int)cudaErrorInvalidValue;
  a.group = a.heads / kv_heads;
  a.head_groups = (a.group + rows - 1) / rows;
  return fn(a, kv_heads, batch, static_cast<cudaStream_t>(stream));
}

}  // namespace split

// ---------------------------------------------------------------------------
// bf16 MLA route: split-KV on tensor cores over one block-wide cp.async ring
// ---------------------------------------------------------------------------

namespace mla {

using tiles::bf16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                     // query heads a block serves
constexpr int kTile = split::kTile;           // tokens per tile (64)
constexpr int kWarpTokens = kTile / kWarps;   // a warp's tokens of a tile
constexpr int kStages = 2;                    // tiles in the ring
constexpr float kLog2e = split::kLog2e;

struct Args {
  const bf16* q;             // [B, H, E]
  const bf16* pool;          // token row: pool + page * page_elems + slot * E
  const int* table;          // [B, max_pages]
  const int* lengths;        // [B]
  bf16* out;                 // [B, H, R]
  float* part_acc;           // [B, H, splits, R]   (splits > 1)
  float* part_m;             // [B, H, splits], log2 units
  float* part_l;             // [B, H, splits]
  int heads;
  int tokens_per_page, max_pages;
  long long page_elems;
  int splits, tiles;         // as split::Args
  float scale;
};

// One instance: R latent and RP rope elements a token (E = R + RP).  The
// score's reduction runs over E padded to the mma's k of 16 (EK; the pad
// columns of q and of the ring are zero).  Rows of q and of the ring are
// LD elements apart, an odd number of 16-byte chunks, so the 8 rows one
// ldmatrix phase reads (or one cp.async wave writes) fall on 8 distinct
// bank groups; the P tile's rows are 9 chunks apart for the same reason.
// P.V: the R value columns go to kColWarps warps in runs of kCols; where
// R is too narrow for four (R = 16), kTokWarps warps split the tile's
// tokens instead and add their accumulators at the end (the tile's row
// maximum is common to all warps, so the sums simply add).
template <int R, int RP>
struct Geo {
  static_assert((R + RP) % 8 == 0 && R % 16 == 0, "uninstantiable width");
  static constexpr int E = R + RP;
  static constexpr int EK = (E + 15) / 16 * 16;
  static constexpr int CT = E / 8;                     // chunks a token
  static constexpr int LD = ((EK / 8) | 1) * 8;
  static constexpr int LDP = (kTile / 8 + 1) * 8;
  static constexpr int kColWarps = R / 16 < kWarps ? R / 16 : kWarps;
  static constexpr int kTokWarps = kWarps / kColWarps;
  static constexpr int kCols = R / kColWarps;
  static constexpr int kKSteps = kTile / 16 / kTokWarps;
  static constexpr int kRing = kStages * kTile * LD;   // elements
  static constexpr int kQ = kRows * LD;
  static constexpr int kP = kRows * LDP;
  // ring, q, P (bf16); tile row maxima and final row sums (f32)
  static constexpr int kSmem = (kRing + kQ + kP) * 2 + 2 * kWarps * kRows * 4;
  static_assert(kTokWarps == 1 || kWarps * kRows * kCols * 4 <= kRing * 2,
                "the ring holds the warps' partial accumulators");
};

// One block per (group of 16 heads, batch row, split).  Each warp copies
// its 16 tokens of every tile into the block's ring (cp.async, one tile in
// flight while one is computed; tokens past the length or on pages < 0
// are zero-filled with src-size 0 and never read from memory, so NaN past
// a length cannot reach a tensor-core product) and takes their scores on
// mma.sync (A = the 16 heads' q from shared memory, B = the ring's rows,
// which lie along the reduction); the tile's row maximum is combined
// across warps through shared memory, P goes to shared memory as bf16,
// and P.V runs on mma.sync with V = the rows' latent prefix read by
// ldmatrix.trans.  Three barriers a tile.
template <int R, int RP>
__global__ void __launch_bounds__(kThreads)
mla_split_decode_kernel(const Args a) {
  using G = Geo<R, RP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = ring + G::kRing;                          // [kRows][LD]
  bf16* ps = qs + G::kQ;                               // [kRows][LDP]
  float* red = reinterpret_cast<float*>(ps + G::kP);   // [kWarps][kRows]
  float* wl = red + kWarps * kRows;                    // [kWarps][kRows]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;             // mma coordinates
  const int cw = warp % G::kColWarps, tw = warp / G::kColWarps;
  const int h0 = blockIdx.x * kRows;
  const int b = blockIdx.y, split = blockIdx.z;
  const int nh = min(kRows, a.heads - h0);
  const long long row0 = (long long)b * a.heads + h0;
  const int max_tokens = a.max_pages * a.tokens_per_page;
  const int2 range = split::split_range(split, a.splits, a.tiles, max_tokens);
  const int start = range.x, cap = range.y;

  // page id of lane's token (lanes < 16) of the warp's part of tile jt,
  // -1 past what the table addresses; read ahead of the length
  auto page_of = [&](int jt) -> int {
    const int pos = start + jt * kTile + warp * kWarpTokens + lane;
    if (lane >= kWarpTokens || pos >= cap) return -1;
    return a.table[(long long)b * a.max_pages + pos / a.tokens_per_page];
  };
  int pages[kStages];
#pragma unroll
  for (int st = 0; st < kStages; ++st) pages[st] = page_of(st);
  const int length = max(0, min(a.lengths[b], max_tokens));
  const int end = min(length, cap);

  if (start >= end) {                 // nothing of this row in the split
    split::write_empty_split(a.out, a.part_m, a.part_l, row0, nh, R,
                             a.splits, split);
    return;
  }
  const int n_tiles = (end - start + kTile - 1) / kTile;

  // cp.async the warp's 16 token rows of tile jt into its stage; returns
  // the mask of tokens that hold data
  auto fetch = [&](int jt, int page) -> unsigned {
    const int pos = start + jt * kTile + warp * kWarpTokens + lane;
    const long long off =
        page < 0 || pos >= end
            ? -1
            : (long long)page * a.page_elems +
                  (long long)(pos % a.tokens_per_page) * G::E;
    const unsigned mask = __ballot_sync(0xffffffffu, off >= 0) & 0xffffu;
    bf16* dst = ring + ((jt % kStages) * kTile + warp * kWarpTokens) * G::LD;
    constexpr int kChunks = kWarpTokens * G::CT;
#pragma unroll
    for (int it = 0; it < (kChunks + 31) / 32; ++it) {
      const int idx = it * 32 + lane;
      const int tok = min(idx / G::CT, kWarpTokens - 1), c = idx % G::CT;
      const long long o = __shfl_sync(0xffffffffu, off, tok);
      if (kChunks % 32 == 0 || idx < kChunks)
        tiles::cp_async_16(dst + tok * G::LD + c * 8,
                           o < 0 ? a.pool : a.pool + o + c * 8, o >= 0);
    }
    return mask;
  };

  // the first tile in flight while q is staged
  unsigned long long masks = 0;        // 16 bits per warp-tile in flight
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      masks |= (unsigned long long)fetch(st, pages[st]) << (16 * st);
    tiles::cp_async_commit();
  }
  int page_next = pages[kStages - 1];

  // q * scale rounded to bf16 (rows past nh and columns past E are 0);
  // the ring's pad columns (E <= c < EK) are zeroed once, never copied to
  for (int i = threadIdx.x; i < kRows * G::LD / 2; i += kThreads) {
    const int r = i / (G::LD / 2), c = i % (G::LD / 2) * 2;
    float2 f = make_float2(0.f, 0.f);
    if (r < nh && c < G::E)
      f = split::scaled_pair(a.q + (row0 + r) * G::E + c, a.scale);
    *reinterpret_cast<uint32_t*>(qs + r * G::LD + c) =
        tiles::pack_bf16(f.x, f.y);
  }
  if constexpr (G::EK > G::E) {
    for (int i = threadIdx.x; i < kStages * kTile; i += kThreads)
#pragma unroll
      for (int c = G::E; c < G::EK; c += 8)
        *reinterpret_cast<uint4*>(ring + i * G::LD + c) =
            make_uint4(0u, 0u, 0u, 0u);
  }

  float o[G::kCols / 8][4];
#pragma unroll
  for (int i = 0; i < G::kCols / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};     // rows gq, gq + 8: common to warps
  float l[2] = {0.f, 0.f};             // ... over this warp's tokens

  for (int j = 0; j < n_tiles; ++j) {
    tiles::cp_async_wait<kStages - 2>();
    __syncthreads();                   // tile j landed for all warps, q
                                       // staged, tile j - 1's stage free
    const int jn = j + kStages - 1;
    if (jn < n_tiles)
      masks |= (unsigned long long)fetch(jn, page_next) << (16 * (kStages - 1));
    tiles::cp_async_commit();
    page_next = page_of(jn + 1);
    const unsigned mask = (unsigned)(masks & 0xffffu);
    masks >>= 16;
    const bf16* kt = ring + (j % kStages) * kTile * G::LD;

    // S = Q K^T: 16 heads x the warp's 16 tokens
    const bf16* kw = kt + warp * kWarpTokens * G::LD;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < G::EK / 16; ++kk) {
      uint32_t qa[4], kf[4];
      tiles::ldmatrix_x4(qa, qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * G::LD +
                                 (kk * 2 + (lane >> 4)) * 8);
      tiles::ldmatrix_x4(kf, kw + ((lane & 7) + (lane >> 4) * 8) * G::LD +
                                 (kk * 2 + ((lane >> 3) & 1)) * 8);
      tiles::mma_bf16(sc[0], qa, kf[0], kf[1]);
      tiles::mma_bf16(sc[1], qa, kf[2], kf[3]);
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = n * 8 + 2 * tq + (e & 1);
        const float x = (mask >> t) & 1u ? sc[n][e] * kLog2e : kNegInf;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (tq == 0) {
      red[warp * kRows + gq] = mx[0];
      red[warp * kRows + gq + 8] = mx[1];
    }
    __syncthreads();                   // every warp's maxima

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = m[r];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        mt = fmaxf(mt, red[w * kRows + gq + 8 * r]);
      alpha[r] = tiles::exp2_approx(m[r] - mt);
      m[r] = mt;
      l[r] *= alpha[r];
    }
    bf16* pw = ps + warp * kWarpTokens;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[n][e] == kNegInf
                            ? 0.f
                            : tiles::exp2_approx(sc[n][e] - m[e >> 1]);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
      *reinterpret_cast<uint32_t*>(pw + gq * G::LDP + n * 8 + 2 * tq) =
          tiles::pack_bf16(sc[n][0], sc[n][1]);
      *reinterpret_cast<uint32_t*>(pw + (gq + 8) * G::LDP + n * 8 + 2 * tq) =
          tiles::pack_bf16(sc[n][2], sc[n][3]);
    }
    __syncthreads();                   // the tile's P

    // O += P V over the warp's columns (and tokens)
#pragma unroll
    for (int i = 0; i < G::kCols / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
#pragma unroll
    for (int ks = 0; ks < G::kKSteps; ++ks) {
      const int k0 = (tw * G::kKSteps + ks) * 16;
      uint32_t pa[4];
      tiles::ldmatrix_x4(pa, ps + ((lane & 7) + ((lane >> 3) & 1) * 8) * G::LDP +
                                 k0 + (lane >> 4) * 8);
#pragma unroll
      for (int dd = 0; dd < G::kCols / 16; ++dd) {
        uint32_t vf[4];
        tiles::ldmatrix_x4_trans(
            vf, kt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * G::LD +
                    cw * G::kCols + dd * 16 + (lane >> 4) * 8);
        tiles::mma_bf16(o[2 * dd], pa, vf[0], vf[1]);
        tiles::mma_bf16(o[2 * dd + 1], pa, vf[2], vf[3]);
      }
    }
  }
  tiles::cp_async_wait<0>();

  // row sums over the warps; with kTokWarps > 1 the token groups'
  // accumulators added through the (now idle) ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();                     // every warp is done with the ring
  if (tq == 0) {
    wl[warp * kRows + gq] = l[0];
    wl[warp * kRows + gq + 8] = l[1];
  }
  float* wo = reinterpret_cast<float*>(smem_raw);   // [kWarps][kRows][kCols]
  if constexpr (G::kTokWarps > 1) {
#pragma unroll
    for (int i = 0; i < G::kCols / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            wo + (warp * kRows + gq + 8 * r) * G::kCols + i * 8 + 2 * tq) =
            make_float2(o[i][2 * r], o[i][2 * r + 1]);
  }
  __syncthreads();
  if (tw != 0) return;
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lsum[0] += wl[w * kRows + gq];
    lsum[1] += wl[w * kRows + gq + 8];
  }
  if constexpr (G::kTokWarps > 1) {
#pragma unroll
    for (int i = 0; i < G::kCols / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 1; t < G::kTokWarps; ++t) {
          const float2 v = *reinterpret_cast<const float2*>(
              wo + ((cw + t * G::kColWarps) * kRows + gq + 8 * r) * G::kCols +
              i * 8 + 2 * tq);
          o[i][2 * r] += v.x;
          o[i][2 * r + 1] += v.y;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    if (row >= nh) continue;
    const long long at = (row0 + row) * a.splits + split;
#pragma unroll
    for (int i = 0; i < G::kCols / 8; ++i) {
      const int col = cw * G::kCols + i * 8 + 2 * tq;
      const float v0 = o[i][2 * r], v1 = o[i][2 * r + 1];
      if (a.splits == 1) {
        const float inv = lsum[r] == 0.f ? 0.f : 1.f / lsum[r];
        *reinterpret_cast<uint32_t*>(a.out + (row0 + row) * R + col) =
            tiles::pack_bf16(v0 * inv, v1 * inv);
      } else {
        *reinterpret_cast<float2*>(a.part_acc + at * R + col) =
            make_float2(v0, v1);
      }
    }
    if (a.splits > 1 && cw == 0 && tq == 0) {
      a.part_m[at] = m[r];
      a.part_l[at] = lsum[r];
    }
  }
}

__global__ void mla_merge_splits_kernel(const float* __restrict__ acc,
                                        const float* __restrict__ m,
                                        const float* __restrict__ l,
                                        bf16* __restrict__ out, int splits) {
  split::merge_splits(acc, m, l, out, splits);
}

template <int R, int RP>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int bytes = Geo<R, RP>::kSmem;
  static bool configured = false;      // once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        mla_split_decode_kernel<R, RP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((a.heads + kRows - 1) / kRows, batch, a.splits);
  mla_split_decode_kernel<R, RP><<<grid, kThreads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  mla_merge_splits_kernel<<<batch * a.heads, split::kMergeLanes * R,
                            split::merge_bytes(a.splits, R), stream>>>(
      a.part_acc, a.part_m, a.part_l, a.out, a.splits);
  return (int)cudaGetLastError();
}

// (latent, rope) widths: minicpm3 at its published width, the f32 card
// check's small geometry and the smoke config (the serve CLI's default).
using LaunchFn = int (*)(const Args&, int, cudaStream_t);
LaunchFn pick(int latent_dim, int rope_dim) {
  if (latent_dim == 256 && rope_dim == 32) return launch<256, 32>;
  if (latent_dim == 64 && rope_dim == 16) return launch<64, 16>;
  if (latent_dim == 16 && rope_dim == 8) return launch<16, 8>;
  return nullptr;
}

}  // namespace mla

}  // namespace

// q, pool, out: bf16.  part_*: f32 partials, used when splits > 1.
// rows: query heads a block serves (16: tensor cores; 1, 2, 4: CUDA
// cores).
extern "C" int paged_gqa_decode_bf16(
    const void* q, const void* pool, const int* table, const int* lengths,
    void* out, float* part_acc, float* part_m, float* part_l, int batch,
    int heads, int kv_heads, int head_dim, int rows, int max_pages,
    int tokens_per_page, long long page_elems, int splits, int tiles,
    float scale, void* stream) {
  using split::bf16;
  split::Args a{};
  a.q = static_cast<const bf16*>(q);
  a.kbuf = a.vbuf = static_cast<const bf16*>(pool);
  a.table = table;
  a.lengths = lengths;
  a.out = static_cast<bf16*>(out);
  a.part_acc = part_acc;
  a.part_m = part_m;
  a.part_l = part_l;
  a.heads = heads;
  a.tokens_per_page = tokens_per_page;
  a.per_tok = 2 * kv_heads * head_dim;
  a.max_pages = max_pages;
  a.page_elems = page_elems;
  a.k_off = 0;
  a.v_off = kv_heads * head_dim;
  a.splits = splits;
  a.tiles = tiles;
  a.scale = scale;
  return split::run(a, batch, kv_heads, head_dim, rows, stream);
}

// k, v: bf16 [batch, max_len, kv_heads, head_dim] each, contiguous.
extern "C" int contiguous_gqa_decode_bf16(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* part_acc, float* part_m, float* part_l, int batch,
    int heads, int kv_heads, int head_dim, int rows, int max_len,
    int splits, int tiles, float scale, void* stream) {
  using split::bf16;
  split::Args a{};
  a.q = static_cast<const bf16*>(q);
  a.kbuf = static_cast<const bf16*>(k);
  a.vbuf = static_cast<const bf16*>(v);
  a.table = nullptr;
  a.lengths = lengths;
  a.out = static_cast<bf16*>(out);
  a.part_acc = part_acc;
  a.part_m = part_m;
  a.part_l = part_l;
  a.heads = heads;
  a.tokens_per_page = max_len;
  a.per_tok = kv_heads * head_dim;
  a.max_pages = 1;
  a.page_elems = (long long)max_len * kv_heads * head_dim;
  a.k_off = 0;
  a.v_off = 0;
  a.splits = splits;
  a.tiles = tiles;
  a.scale = scale;
  return split::run(a, batch, kv_heads, head_dim, rows, stream);
}

// q, pool, out: float32.
extern "C" int paged_gqa_decode_f32(const void* q, const void* pool,
                                    const int* table, const int* lengths,
                                    void* out, int batch, int heads,
                                    int kv_heads, int head_dim, int max_pages,
                                    int tokens_per_page, long long page_elems,
                                    float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return (int)cudaErrorInvalidValue;
  Geometry g = gqa_geometry(heads, kv_heads, head_dim, scale);
  g.v_base = kv_heads * head_dim;
  g.tokens_per_page = tokens_per_page;
  g.per_tok = 2 * kv_heads * head_dim;
  g.page_elems = page_elems;
  g.max_pages = max_pages;
  return dispatch<float, false>(q, pool, pool, table, lengths, out, batch,
                                kv_heads, g, static_cast<cudaStream_t>(stream));
}

// k, v: float32 [batch, max_len, kv_heads, head_dim] each, contiguous.
extern "C" int contiguous_gqa_decode_f32(const void* q, const void* k,
                                         const void* v, const int* lengths,
                                         void* out, int batch, int heads,
                                         int kv_heads, int head_dim,
                                         int max_len, float scale,
                                         void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return (int)cudaErrorInvalidValue;
  Geometry g = gqa_geometry(heads, kv_heads, head_dim, scale);
  g.tokens_per_page = max_len;
  g.per_tok = kv_heads * head_dim;
  g.page_elems = (long long)max_len * kv_heads * head_dim;
  g.max_pages = 1;
  return dispatch<float, false>(q, k, v, nullptr, lengths, out, batch,
                                kv_heads, g, static_cast<cudaStream_t>(stream));
}

// q, pool, out: bf16; part_*: f32 partials, used when splits > 1.  The
// split-KV tensor-core kernel; (latent_dim, rope_dim) must be one of
// mla::pick's instances.
extern "C" int paged_mla_decode_bf16(
    const void* q, const void* pool, const int* table, const int* lengths,
    void* out, float* part_acc, float* part_m, float* part_l, int batch,
    int heads, int latent_dim, int rope_dim, int max_pages,
    int tokens_per_page, long long page_elems, int splits, int tiles,
    float scale, void* stream) {
  const mla::LaunchFn fn = mla::pick(latent_dim, rope_dim);
  if (fn == nullptr || heads <= 0 || splits < 1 || splits > tiles ||
      (splits > 1 && !(part_acc && part_m && part_l)))
    return (int)cudaErrorInvalidValue;
  mla::Args a{};
  a.q = static_cast<const mla::bf16*>(q);
  a.pool = static_cast<const mla::bf16*>(pool);
  a.table = table;
  a.lengths = lengths;
  a.out = static_cast<mla::bf16*>(out);
  a.part_acc = part_acc;
  a.part_m = part_m;
  a.part_l = part_l;
  a.heads = heads;
  a.tokens_per_page = tokens_per_page;
  a.max_pages = max_pages;
  a.page_elems = page_elems;
  a.splits = splits;
  a.tiles = tiles;
  a.scale = scale;
  return fn(a, batch, static_cast<cudaStream_t>(stream));
}

// q, pool, out: float32; the first design (paged_decode_block).
extern "C" int paged_mla_decode_f32(const void* q, const void* pool,
                                    const int* table, const int* lengths,
                                    void* out, int batch, int heads,
                                    int latent_dim, int rope_dim,
                                    int max_pages, int tokens_per_page,
                                    long long page_elems, float scale,
                                    void* stream) {
  Geometry g;
  g.heads = heads;
  g.heads_per_block = heads < kMlaHeadsPerBlock ? heads : kMlaHeadsPerBlock;
  g.k_dim = latent_dim + rope_dim;
  g.v_dim = latent_dim;
  g.k_base = 0;
  g.k_step = 0;
  g.v_base = 0;
  g.v_step = 0;
  g.kv_shared = 1;
  g.tokens_per_page = tokens_per_page;
  g.per_tok = latent_dim + rope_dim;
  g.page_elems = page_elems;
  g.max_pages = max_pages;
  g.tile = kMaxTile;
  g.q_scale = scale;
  const int grid_x = (heads + g.heads_per_block - 1) / g.heads_per_block;
  return dispatch<float, true>(q, pool, pool, table, lengths, out, batch,
                               grid_x, g, static_cast<cudaStream_t>(stream));
}
