// Paged KV write for Hopper (sm_90a): the shared pool's one scatter.
//
// Not a TPU kernel: the reference stores a layer's new KV rows with one
// XLA scatter in mode="drop" (src/repro/kernels/ops.py:79-104,
// paged_kv_write).  What it computes, for each of n token rows i:
//   pool[pages[i], slots[i] * e : (slots[i] + 1) * e] = rows[i]
// and a row whose page id is below 0 (an unmapped table entry, an
// inactive batch slot) is dropped, as are ids past the pool and elements
// past the end of the page (mode="drop" drops every out-of-range index).
// Kept rows are stored bit for bit: the kernel moves bytes and does no
// arithmetic on them.
//
// Why a kernel.  The plain version selects the kept rows with a boolean
// mask (pages[keep]), which reads the mask's count back to the host: one
// synchronisation per layer per decode step, and no CUDA graph can hold
// it.  Here each block reads its own page id and returns when the row is
// dropped, so the call makes no host read and can be captured.  A scratch
// page past the pool would change pool.shape[0], which the kernels, the
// virtualizer and the reference's shapes rely on; sending dropped rows to
// page 0 with torch.where races with a kept row on the same slot.
//
// Design: one block per row, 128 threads copying the row in vectors of
// `vec` bytes (16 when the row, the page and both base pointers allow it,
// else 8, 4, 2 or 1; the wrapper picks it).  Rows are at most a few KB
// (qwen3-moe: 2 x 4 x 128 bf16 = 2 KB; minicpm3's MLA row 576 B), so one
// pass of 128 16-byte stores covers them.
//
// Bound: the row bytes are read once and written once, plus 8 bytes of
// page id and slot a row: 2 * n * e * itemsize + 8 * n bytes at 3.35 TB/s.
// At decode (B = 4 rows of 2 KB) that is 16 KB, ~5 ns: the launch, not
// the bytes, is the cost, which is why it belongs inside the step's graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename V>
__global__ void kv_write_kernel(char* __restrict__ pool,
                                const char* __restrict__ rows,
                                const int* __restrict__ pages,
                                const int* __restrict__ slots, int n_pages,
                                long long page_bytes, long long row_bytes) {
  const int i = blockIdx.x;
  const int page = pages[i];
  const int slot = slots[i];
  if (page < 0 || page >= n_pages || slot < 0) return;   // dropped row
  const long long start = (long long)slot * row_bytes;
  if (start >= page_bytes) return;
  // vec divides row_bytes and page_bytes, so the bytes left in the page
  // are a whole number of vectors: elements past the page are dropped
  const long long n_vec =
      (row_bytes < page_bytes - start ? row_bytes : page_bytes - start) /
      (long long)sizeof(V);
  V* dst = reinterpret_cast<V*>(pool + (long long)page * page_bytes + start);
  const V* src = reinterpret_cast<const V*>(rows + (long long)i * row_bytes);
  for (long long j = threadIdx.x; j < n_vec; j += kThreads) dst[j] = src[j];
}

template <typename V>
void launch(void* pool, const void* rows, const int* pages, const int* slots,
            int n_rows, int n_pages, long long page_bytes, long long row_bytes,
            cudaStream_t stream) {
  kv_write_kernel<V><<<n_rows, kThreads, 0, stream>>>(
      static_cast<char*>(pool), static_cast<const char*>(rows), pages, slots,
      n_pages, page_bytes, row_bytes);
}

}  // namespace

// pool [n_pages, page_bytes] and rows [n_rows, row_bytes] as bytes (the
// wrapper has cast the rows to the pool's type); pages / slots [n_rows]
// int32; vec in {16, 8, 4, 2, 1} divides row_bytes, page_bytes and both
// base addresses.  Returns the launch's CUDA error code.
extern "C" int paged_kv_write(void* pool, const void* rows, const int* pages,
                              const int* slots, int n_rows, int n_pages,
                              long long page_bytes, long long row_bytes,
                              int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16:
      launch<uint4>(pool, rows, pages, slots, n_rows, n_pages, page_bytes,
                    row_bytes, s);
      break;
    case 8:
      launch<uint2>(pool, rows, pages, slots, n_rows, n_pages, page_bytes,
                    row_bytes, s);
      break;
    case 4:
      launch<uint32_t>(pool, rows, pages, slots, n_rows, n_pages, page_bytes,
                       row_bytes, s);
      break;
    case 2:
      launch<uint16_t>(pool, rows, pages, slots, n_rows, n_pages, page_bytes,
                       row_bytes, s);
      break;
    case 1:
      launch<uint8_t>(pool, rows, pages, slots, n_rows, n_pages, page_bytes,
                      row_bytes, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
