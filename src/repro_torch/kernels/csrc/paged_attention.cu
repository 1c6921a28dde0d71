// Decode attention for Hopper (sm_90a): paged GQA, paged absorbed MLA and
// GQA over a contiguous cache.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   * paged_gqa_decode       <- _paged_kernel      (:121, pallas_call :203)
//   * paged_mla_decode       <- _paged_mla_kernel  (:225, pallas_call :304)
//   * contiguous_gqa_decode  <- _decode_kernel     (:35,  pallas_call :110)
//
// What they compute (one new token per sequence):
//   s(t)  = q . k_t                 for t < length (q arrives pre-scaled)
//   out   = sum_t softmax(s)_t v_t  (online softmax, m / l / acc in f32)
// with every guard of the TPU kernels: pages whose id is < 0 are skipped,
// positions past `length` are never read, scores at positions >= length
// are -1e30, value rows past `length` read as 0 (0 * garbage never makes
// NaN), and a row with no valid position (l == 0) writes 0.
//
// Layout.  The paged kernels read the FLAT pool [n_pages, page_elems] in
// place: token t of page p starts at  pool + p * page_elems + t * per_tok.
//   GQA: a token is [2, KV, D] (K heads, then V heads); block (kv_head, b)
//        serves the G = H / KV query heads that share kv_head.
//   MLA: a token is [r + rp] (latent | rope key); the score dot runs over
//        the whole row and the value is the latent prefix [:r]; block
//        (head_group, b) serves up to kMlaHeadsPerBlock query heads.
// Typed views of the pool (pool[:, :tpp * per_tok].reshape(...)) would
// copy the whole pool whenever a page has slack (MLA: 28 * 288 < 8192),
// so the kernels compute their own addresses instead.  Each block loads
// its own page ids and length: that replaces the TPU's scalar prefetch.
// The contiguous kernel is the paged GQA kernel under another addressing
// policy: K and V are two tensors [B, T, KV, D], read as if row b were
// one page of T tokens of KV * D elements (no table: page id = b).
//
// Bound.  Decode attention reads each valid KV token once:
//   B * length * per_tok * itemsize bytes at 3.35 TB/s (H100 SXM); its
//   2 * H * length * (k_dim + v_dim) flops are far below any peak.
// Design.  Simple and right first.  A block walks the context in tiles of
// `tile` tokens (several pages): it looks up the tile's page ids, copies
// the tile's key / value rows to shared memory as f32 with 16-byte loads
// staged through registers (kUnroll independent loads in flight per
// thread: a decode block is latency-bound, and one load at a time made the
// first version ~5000x slower than the bound), then one thread per (head,
// token) score, one warp per head for the online-softmax statistics, and
// the f32 accumulator update.  There is no split over the context yet, so
// at B = 1 only B * KV blocks run (qwen3-moe: 4 blocks on 132 SMs);
// split-KV (flash-decoding), TMA page copies and tensor cores are the next
// step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;               // loads in flight per thread
constexpr int kMlaHeadsPerBlock = 8;
constexpr int kMaxTile = 64;             // tokens per tile
constexpr int kSmemLimit = 200 * 1024;   // of the 227 KB a block may use
constexpr float kNegInf = -1e30f;

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
        ? to_f32(q[((size_t)b * g.heads + h0 + hh) * g.k_dim + d]) : 0.f;
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
Geometry gqa_geometry(int heads, int kv_heads, int head_dim) {
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
  return g;
}

template <bool kMla>
int dispatch_dtype(int dtype, const void* q, const void* kpool,
                   const void* vpool, const int* table, const int* lengths,
                   void* out, int batch, int grid_x, const Geometry& g,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, kMla>(q, kpool, vpool, table, lengths, out, batch,
                                 grid_x, g, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, kMla>(q, kpool, vpool, table, lengths,
                                         out, batch, grid_x, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the KV and out share it).
extern "C" int paged_gqa_decode(const void* q, const void* pool,
                                const int* table, const int* lengths,
                                void* out, int batch, int heads, int kv_heads,
                                int head_dim, int max_pages,
                                int tokens_per_page, long long page_elems,
                                int dtype, void* stream) {
  Geometry g = gqa_geometry(heads, kv_heads, head_dim);
  g.v_base = kv_heads * head_dim;
  g.tokens_per_page = tokens_per_page;
  g.per_tok = 2 * kv_heads * head_dim;
  g.page_elems = page_elems;
  g.max_pages = max_pages;
  return dispatch_dtype<false>(dtype, q, pool, pool, table, lengths, out,
                               batch, kv_heads, g, stream);
}

// k, v: [batch, max_len, kv_heads, head_dim] each, contiguous.
extern "C" int contiguous_gqa_decode(const void* q, const void* k,
                                     const void* v, const int* lengths,
                                     void* out, int batch, int heads,
                                     int kv_heads, int head_dim, int max_len,
                                     int dtype, void* stream) {
  Geometry g = gqa_geometry(heads, kv_heads, head_dim);
  g.tokens_per_page = max_len;
  g.per_tok = kv_heads * head_dim;
  g.page_elems = (long long)max_len * kv_heads * head_dim;
  g.max_pages = 1;
  return dispatch_dtype<false>(dtype, q, k, v, nullptr, lengths, out, batch,
                               kv_heads, g, stream);
}

extern "C" int paged_mla_decode(const void* q, const void* pool,
                                const int* table, const int* lengths,
                                void* out, int batch, int heads,
                                int latent_dim, int rope_dim, int max_pages,
                                int tokens_per_page, long long page_elems,
                                int dtype, void* stream) {
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
  const int grid_x = (heads + g.heads_per_block - 1) / g.heads_per_block;
  return dispatch_dtype<true>(dtype, q, pool, pool, table, lengths, out,
                              batch, grid_x, g, stream);
}
