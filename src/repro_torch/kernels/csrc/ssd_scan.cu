// Mamba2 SSD chunked scan for Hopper (sm_90a).
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
// heads (head h reads group h / (H / G)).  Everything is summed in f32.
//
// Layout.  x [B,S,H,P] and y as x; dt [B,S,H] f32; A [H] f32; Bm, Cm
// [B,S,G,N] (x's dtype); h0, h_out [B,H,P,N] f32; all contiguous.
//
// Bound.  Each input is read once and each output written once:
//   (B*S*H*(2P + 1) + 2*B*S*G*N) * itemsize + 8*B*H*P*N bytes; the work is
//   about B*H*(S*L*(N + P) + 4*S*P*N) flops, which at the path's shapes
//   (S = 1024, L = 256) stays below the bf16 peak's share of those bytes:
//   bytes bound the kernel on this card.
// Design.  Simple and right first.  One block per (head, batch row) walks
// the chunks in order (the TPU's sequential grid axis becomes a loop), with
// the carried state h [P][N] f32 in shared memory (16 KiB for zamba2,
// P = N = 64; 32 KiB for mamba2, N = 128).  The L x L score matrix of a
// chunk (256 KiB f32 at L = 256) does not fit, so each chunk is walked in
// 64 x 64 (target, source) tiles on and below the diagonal: a target tile
// stages its C rows, takes the inter term from h, then adds each source
// tile's (C.B ⊙ decay ⊙ dt) x product, exp taken only where s <= t (the
// upper triangle is never exponentiated).  The state update then re-reads
// the chunk's B and x tile by tile.  Each thread keeps its outputs in
// registers: a fixed column (p, or n) and rows strided by 256 / width.
// Only B * H blocks run (zamba2 B = 1: 64 of 132 SMs), all on CUDA cores;
// tensor cores (mma.sync on the tile products) and splitting the heads'
// P across blocks are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
// The entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // target / source rows per tile
constexpr int kMaxAcc = 32;        // register outputs per thread
constexpr int kSmemLimit = 200 * 1024;   // of the 227 KB a block may use

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
  int seq, heads, head_dim, groups, state, chunk;
};

// Shared memory (floats) one block needs; the host computes the same sum.
__host__ __device__ inline int smem_floats(const Dims& d) {
  const int P = d.head_dim, N = d.state, L = d.chunk;
  return P * (N + 1)              // h      [P][N+1]
         + 3 * L                  // la, dts, wend  [L]
         + 2 * kTile * (N + 1)    // cs, bs [kTile][N+1]
         + kTile * P              // xs     [kTile][P]
         + kTile * (kTile + 1);   // sc     [kTile][kTile+1]
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

// dst[r][c] (row stride `stride`) = src row (row0 + r), `width` elements,
// for r < rows (0 beyond); source rows are `row_step` elements apart.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          long long row_step, int rows,
                                          int width) {
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * stride + c] = r < rows ? to_f32(src[r * row_step + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out, const Dims d) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int head = blockIdx.x, b = blockIdx.y;
  const int S = d.seq, H = d.heads, P = d.head_dim, N = d.state;
  const int L = d.chunk, G = d.groups;
  const int g = head / (H / G);
  const int ns = N + 1;

  float* hs = smem;                        // [P][ns]
  float* la = hs + P * ns;                 // [L]
  float* dts = la + L;                     // [L]
  float* wend = dts + L;                   // [L]
  float* cs = wend + L;                    // [kTile][ns]
  float* bs = cs + kTile * ns;             // [kTile][ns]
  float* xs = bs + kTile * ns;             // [kTile][P]
  float* sc = xs + kTile * P;              // [kTile][kTile + 1]

  const float a_h = A[head];
  const long long x_row = (long long)H * P;      // x / y step per position
  const long long bc_row = (long long)G * N;     // B / C step per position
  const T* xb = x + (long long)b * S * x_row + (long long)head * P;
  T* yb = y + (long long)b * S * x_row + (long long)head * P;
  const T* bb = Bm + (long long)b * S * bc_row + (long long)g * N;
  const T* cb = Cm + (long long)b * S * bc_row + (long long)g * N;
  const float* dtb = dt + (long long)b * S * H + head;
  const long long h_off = ((long long)b * H + head) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    hs[(i / N) * ns + i % N] = h0 ? h0[h_off + i] : 0.f;

  // y outputs: column p fixed, rows yr0 + j * y_rows (j < n_y)
  const int y_rows = kThreads / P, n_y = kTile / y_rows;
  const int yp = tid % P, yr0 = tid / P;
  // state outputs: column n fixed, rows hr0 + j * h_rows (j < n_h)
  const int h_rows = kThreads / N, n_h = (P + h_rows - 1) / h_rows;
  const int hn = tid % N, hr0 = tid / N;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();
    for (int i = tid; i < L; i += kThreads) {
      const float dv = dtb[(long long)(c0 + i) * H];
      dts[i] = dv;
      la[i] = dv * a_h;
    }
    __syncthreads();
    block_inclusive_scan(la, L, warp_sums);
    for (int i = tid; i < L; i += kThreads)
      wend[i] = expf(la[L - 1] - la[i]) * dts[i];

    for (int t0 = 0; t0 < L; t0 += kTile) {
      const int tr = min(kTile, L - t0);
      __syncthreads();
      load_tile(cs, ns, cb + (long long)(c0 + t0) * bc_row, bc_row, tr, N);
      __syncthreads();
      float acc[kMaxAcc];
      // inter term from the state at the chunk's start
#pragma unroll
      for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float hv = hs[yp * ns + n];
#pragma unroll
        for (int j = 0; j < kMaxAcc; ++j)
          if (j < n_y) acc[j] += cs[(yr0 + j * y_rows) * ns + n] * hv;
      }
#pragma unroll
      for (int j = 0; j < kMaxAcc; ++j) {
        const int r = yr0 + j * y_rows;
        if (j < n_y && r < tr) acc[j] *= expf(la[t0 + r]);
      }
      // intra term: source tiles on and below the diagonal
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        const int sr = min(kTile, L - s0);
        __syncthreads();
        load_tile(bs, ns, bb + (long long)(c0 + s0) * bc_row, bc_row, sr, N);
        load_tile(xs, P, xb + (long long)(c0 + s0) * x_row, x_row, sr, P);
        __syncthreads();
        for (int i = tid; i < kTile * kTile; i += kThreads) {
          const int r = i / kTile, s = i - r * kTile;
          const int gt = t0 + r, gs = s0 + s;
          float v = 0.f;
          if (r < tr && s < sr && gs <= gt) {
            const float* cr = cs + r * ns;
            const float* br = bs + s * ns;
            float d0 = 0.f, d1 = 0.f;
            int n = 0;
            for (; n + 2 <= N; n += 2) {
              d0 += cr[n] * br[n];
              d1 += cr[n + 1] * br[n + 1];
            }
            if (n < N) d0 += cr[n] * br[n];
            v = (d0 + d1) * expf(la[gt] - la[gs]) * dts[gs];
          }
          sc[r * (kTile + 1) + s] = v;
        }
        __syncthreads();
        for (int s = 0; s < sr; ++s) {
          const float xv = xs[s * P + yp];
#pragma unroll
          for (int j = 0; j < kMaxAcc; ++j)
            if (j < n_y)
              acc[j] += sc[(yr0 + j * y_rows) * (kTile + 1) + s] * xv;
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxAcc; ++j) {
        const int r = yr0 + j * y_rows;
        if (j < n_y && r < tr)
          yb[(long long)(c0 + t0 + r) * x_row + yp] = from_f32<T>(acc[j]);
      }
    }

    // state update: h <- exp(La_L) h + sum_s wend_s x_s ⊗ B_s
    float hacc[kMaxAcc];
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) hacc[j] = 0.f;
    for (int s0 = 0; s0 < L; s0 += kTile) {
      const int sr = min(kTile, L - s0);
      __syncthreads();
      load_tile(bs, ns, bb + (long long)(c0 + s0) * bc_row, bc_row, sr, N);
      load_tile(xs, P, xb + (long long)(c0 + s0) * x_row, x_row, sr, P);
      __syncthreads();
      for (int s = 0; s < sr; ++s) {
        const float bv = bs[s * ns + hn] * wend[s0 + s];
#pragma unroll
        for (int j = 0; j < kMaxAcc; ++j) {
          const int p = hr0 + j * h_rows;
          if (j < n_h && p < P) hacc[j] += bv * xs[s * P + p];
        }
      }
    }
    __syncthreads();
    const float total = expf(la[L - 1]);
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int p = hr0 + j * h_rows;
      if (j < n_h && p < P)
        hs[p * ns + hn] = hs[p * ns + hn] * total + hacc[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    h_out[h_off + i] = hs[(i / N) * ns + i % N];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* h_out, int batch,
           const Dims& d, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(d);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_scan_kernel<T><<<dim3(d.heads, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), h_out, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest supported shapes: kThreads % head_dim == 0 and
// kThreads % state == 0, head_dim * kTile and head_dim * state at most
// kThreads * kMaxAcc, and the shared memory within the block limit.
extern "C" int ssd_scan_supported(int head_dim, int state, int chunk) {
  Dims d{0, 0, head_dim, 1, state, chunk};
  return head_dim > 0 && state > 0 && chunk > 0 &&
         kThreads % head_dim == 0 && kThreads % state == 0 &&
         head_dim * kTile <= kThreads * kMaxAcc &&
         head_dim * state <= kThreads * kMaxAcc &&
         sizeof(float) * (size_t)smem_floats(d) <= (size_t)kSmemLimit;
}

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it).  h0 may be
// null (the scan starts from 0).
extern "C" int ssd_chunked_scan(const void* x, const float* dt,
                                const float* A, const void* Bm,
                                const void* Cm, const float* h0, void* y,
                                float* h_out, int batch, int seq, int heads,
                                int head_dim, int groups, int state,
                                int chunk, int dtype, void* stream) {
  if (!ssd_scan_supported(head_dim, state, chunk) || seq % chunk ||
      heads % groups)
    return (int)cudaErrorInvalidValue;
  Dims d{seq, heads, head_dim, groups, state, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, h_out, batch, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, h_out, batch, d,
                                 s);
  return (int)cudaErrorInvalidValue;
}
