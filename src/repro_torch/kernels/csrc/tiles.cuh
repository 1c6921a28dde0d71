// Tile building blocks shared by the attention kernels (sm_90a): 16-byte
// cp.async copies with zero-fill, ldmatrix, the bf16 m16n8k16 tensor-core
// product and the XOR swizzle of bf16 row tiles in shared memory.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), as the PTX manual gives them:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1)    a1 = (g+8, 2t..2t+1)
//                           a2 = (g, 2t+8..2t+9)  a3 = (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0 = (2t..2t+1, g)    b1 = (2t+8..2t+9, g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1)  c2, c3 = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column blocks are, packed to
// bf16, the A fragment of the next product over those 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tiles {

using bf16 = __nv_bfloat16;

// Copy 16 bytes global -> shared, bypassing L1; with `valid` false nothing
// is read and the 16 bytes are zero-filled (src-size 0).  `src` must be a
// valid address either way.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a * b: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx: ~2 ulp; a result below
// the smallest normal float flushes to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A row tile of D bf16 per row, in 16-byte chunks whose index is XORed
// with the row's position in its 128-byte line group: the 8 rows one
// ldmatrix phase (or one 16-byte cp.async per lane) touches fall on 8
// distinct 16-byte bank groups for every D in {16, 32, 64, 128}.
template <int D>
struct Swizzle {
  static constexpr int kChunks = D / 8;               // chunks per row
  static constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  // element offset of chunk c of row r
  __device__ static __forceinline__ int at(int r, int c) {
    return r * D + ((c ^ ((r / kRowsPerLine) & kMask)) << 3);
  }
};

}  // namespace tiles
