// Causal GQA prefill attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   * flash_prefill  <- _flash_kernel  (:29, pallas_call :97)
//
// What it computes: q [B,S,H,D] against k, v [B,T,KV,D] (query head h
// reads kv head h / (H / KV)), causal with the prefix offset T - S:
//   s(i, t) = scale * q_i . k_t      for t <= i + (T - S), else masked
//   out_i   = sum_t softmax_t(s(i, .)) v_t
// with the online softmax (m / l / acc) in f32, masked scores at -1e30 and
// contributing exactly 0, value rows past T read as 0, and a row with no
// valid key (l == 0) writing 0, as the TPU kernel does.  T >= S.
//
// Layout.  q, out [B,S,H,D]; k, v [B,T,KV,D]; contiguous, f32 or bf16.
//
// Bound.  Causal attention does 4 * B * H * D * (pairs i, t with t on or
// below the diagonal) flops and reads q, k, v once and writes out once;
// at the path's shapes (S = T = 1024, D = 64) the flops over the bf16
// peak and the bytes over 3.35 TB/s are of the same order (a few
// microseconds each); the kernel is far from either.
// Design.  Simple and right first.  One block per (q tile of 64 rows,
// head, batch row): it stages its Q tile in shared memory as f32, then
// walks K/V tiles of 64 keys only up to the causal diagonal, staging each
// (keys padded by one float per row so a warp's lanes hit distinct banks).
// One thread per (row, key) score (16 per thread), one warp per row for
// the online-softmax statistics, then the probabilities times V into the
// f32 accumulator that each thread keeps in registers for a fixed column d
// and rows strided by 256 / D.  Templated on D (16, 32, 64, 128): the
// accumulator is D / 4 registers.  All on CUDA cores; tensor cores
// (mma.sync / wgmma on the QK^T and PV tiles) and TMA tile loads are the
// next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// The entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // keys per tile
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

struct Dims {
  int q_len, kv_len, heads, kv_heads;
  float scale;
};

// Shared memory (floats) one block needs; the host computes the same sum.
__host__ __device__ constexpr int smem_floats(int D) {
  return kBQ * D                 // qs [kBQ][D]
         + kBK * (D + 1)         // ks [kBK][D+1]
         + kBK * D               // vs [kBK][D]
         + kBQ * (kBK + 1)       // ps [kBQ][kBK+1]
         + 3 * kBQ;              // m, l, alpha
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
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
  const T* qb = q + (long long)b * S * q_row + (long long)head * D;
  T* ob = out + (long long)b * S * q_row + (long long)head * D;
  const T* kb = k + (long long)b * Tk * kv_row + (long long)kvh * D;
  const T* vb = v + (long long)b * Tk * kv_row + (long long)kvh * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = q0 + r < S ? to_f32(qb[(long long)(q0 + r) * q_row + d]) : 0.f;
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
      ks[r * (D + 1) + d] = ok ? to_f32(kb[at]) : 0.f;
      vs[r * D + d] = ok ? to_f32(vb[at]) : 0.f;
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
      ob[(long long)(q0 + r) * q_row + dcol] =
          from_f32<T>(lv == 0.f ? 0.f : acc[j] / lv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int batch, const Dims& g, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * (size_t)smem_floats(D);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((g.q_len + kBQ - 1) / kBQ, g.heads, batch);
  flash_prefill_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             void* out, int batch, const Dims& g, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, out, batch, g, stream);
    case 32: return launch<T, 32>(q, k, v, out, batch, g, stream);
    case 64: return launch<T, 64>(q, k, v, out, batch, g, stream);
    case 128: return launch<T, 128>(q, k, v, out, batch, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int batch, int q_len, int kv_len,
                             int heads, int kv_heads, int head_dim,
                             float scale, int dtype, void* stream) {
  if (kv_len < q_len || kv_heads <= 0 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const Dims g{q_len, kv_len, heads, kv_heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(head_dim, q, k, v, out, batch, g, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(head_dim, q, k, v, out, batch, g, s);
  return (int)cudaErrorInvalidValue;
}
