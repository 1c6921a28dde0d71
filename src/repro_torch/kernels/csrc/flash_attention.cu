// Causal GQA prefill attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   * flash_prefill_bf16, flash_prefill_f32  <- _flash_kernel  (:29,
//     pallas_call :97, wrapper flash_attention :81)
//
// What it computes: q [B,S,H,D] against k, v [B,T,KV,D] (query head h
// reads kv head h / (H / KV)), causal with the prefix offset T - S:
//   s(i, t) = scale * q_i . k_t      for t <= i + (T - S), else masked
//   out_i   = sum_t softmax_t(s(i, .)) v_t
// with the online softmax (m / l / acc) in f32, masked scores at -1e30 and
// contributing exactly 0, key / value rows past T read as 0, and a row
// with no valid key (l == 0) writing 0, as the TPU kernel does.  T >= S.
// Layout: q, out [B,S,H,D]; k, v [B,T,KV,D]; contiguous; D in {16, 32,
// 64, 128, 256}, and 8 in float32 (the smoke configs' head dim: below
// wgmma's k16, so the bf16 body refuses it).
//
// Bound.  Causal attention does 4 * B * H * D * (pairs i, t on or below
// the diagonal) flops and reads q, k, v once and writes out once: the
// operations bound every shape the paths give it, at the bf16 tensor-core
// peak (989 TFLOP/s) in bf16 and at the FP32 FFMA peak (67 TFLOP/s) in
// float32; HBM (3.35 TB/s) is the bound only below ~300 flops a byte.
// gemma3's global layers (B = 4, S = T = 2048, H 16 over KV 8, D = 256)
// are 137 GFLOP: 0.139 ms in bf16.  A moonshot rank of (2,2) (B = 2,
// S = T = 512, H = KV = 8, D = 128) is 1.08 GFLOP: 0.016 ms in float32.
//
// What the earlier designs lost (NVIDIA H100 80GB HBM3, 700 W, median of
// 20 with L2 flushed):
//   * bf16, a FlashAttention-2 body on mma.sync.m16n8k16, one block of 4
//     warps a 64-row q tile: 0.8355 ms on gemma3's global layers (cuDNN
//     0.2546).  At D = 256 its 16 x 256 f32 accumulator took 128
//     registers a lane and the ring 160 KB, so four warps ran an SM, and
//     mma.sync cannot reach the tensor cores' full rate;
//   * float32, the first design: K and V staged element by element with
//     no copy in flight, four __syncthreads a K/V tile, two shared loads
//     per FMA (one thread a score), P through shared memory and re-read
//     per column, a warp a softmax row, and 64-row q tiles launched
//     lightest first: 0.2770 ms at the moonshot rank (SDPA's best float32
//     backend 0.0596), whose 128 blocks are one wave on 132 SMs, so the
//     call took as long as the 64-row diagonal tile over all 512 keys
//     (16.8 MFLOP on one SM, 33 us at its FP32 peak).
//
// bf16 body (flash_prefill_wgmma_kernel<D>), FlashAttention-3 shaped:
//   * a block of 128 query rows: two warpgroups of 64 rows each, one block
//     an SM.  Q once and K / V tiles stream in by TMA into a ring of NS
//     stages; each stage has full mbarriers (the TMA's byte count) for K
//     and for V and empty ones (one arrival per warp) for each, and thread
//     0 refills a stage's K as soon as both warpgroups have S of its tile,
//     its V once both have P V;
//   * S = Q K^T on wgmma.m64nBKk16 with Q and K K-major in shared memory;
//     the online softmax runs on the accumulator fragments in f32, log2
//     units (row max and sum across the quad by shuffles); P, rounded to
//     bf16 in pairs, is the register A operand of O += P V, with V read
//     MN-major from shared memory (wgmma's transposed B): P never leaves
//     the registers;
//   * software pipelined as FlashAttention-3's intra-warpgroup overlap: S
//     of tile j and P V of tile j - 1 are issued together, the softmax of
//     tile j runs while P V runs, then O is rescaled and P's registers
//     take tile j;
//   * rows of D bf16 are TMA boxes of at most 64 columns in the swizzle of
//     their span (32, 64 or 128 bytes), so D = 256 loads as four 64-column
//     blocks; key tiles BK = 128 (64 at D = 256) and NS = 3 stages (2 from
//     D = 128): at D = 256 Q 64 KB + 2 x (32 + 32) KB = 192 KB;
//   * tensor maps over [B, L, heads, D] are built on the host at each call
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint) and passed
//     as __grid_constant__ parameters; rows past S or T are the TMA's zero
//     fill, and the epilogue (1/l, 0 where l == 0) writes bf16 into the
//     warpgroup's Q rows in the same swizzle and stores them by TMA, which
//     clips rows >= S;
//   * tiles are walked from the diagonal down: only tiles that cross it
//     mask, a warpgroup skips a tile none of its rows sees, tiles above it
//     are never loaded, and q tiles launch heaviest first (grid z walks
//     them backwards);
//   * no producer warpgroup and no setmaxnreg.  Twelve warps (a producer
//     warpgroup beside the two) leave a thread 168 registers (three warps
//     share a scheduler's 16K); with setmaxnreg moving 40 / 232 (and 24 /
//     240) ptxas (CUDA 12.9) still compiled the consumers within 168,
//     spilled and serialised every wgmma at D = 128 and 256 (C7512,
//     "insufficient register resources"), and a lone producer warp (nine
//     warps) has the same limit.  Eight warps give 255: D = 256 holds O
//     (128), S (32) and P (16) with no spill, and the TMA issue is a few
//     instructions of thread 0.
// float32 body (flash_prefill_f32_kernel<D>): FFMA only (no TF32: the
// card-vs-CPU checks run at 2e-5):
//   * balanced causal work: 32-row q tiles, and a block takes a heavy tile
//     and its mirror (tile n - 1 - p, then tile p), so every block does
//     the same work (n + 1 half tiles; the middle tile of an odd count
//     alone, launched last).  Smaller tiles alone would leave the wave to
//     the heaviest block; pairing keeps a 32-row tile's reuse and fills
//     the card with equal blocks (the moonshot rank: 128 blocks of 17
//     32 x 32 units, against a heaviest 64-row tile of 32 before);
//   * 8 warps: two row warps of 16 rows x four column warps; a round of
//     BK = 64 keys (32 at D = 256) gives each column warp its own 16 (8)
//     keys, so the four keep their own online softmax (m, l and the 16 x
//     D accumulator in registers) and need no barrier but one
//     __syncthreads a round; at the end of a tile their partials merge
//     through shared memory in column-warp order (no atomics: two calls
//     give the same bits);
//   * K / V rounds in a cp.async ring (16 bytes a copy, rows >= T
//     zero-filled; three stages where they fit at the residency asked
//     for, else two), the next rounds' copies in flight while this one is
//     computed; rounds wholly above the diagonal are not loaded,
//     sub-tiles above it are skipped;
//   * S = Q K^T from Q in registers (D <= 128): a row's 8 lanes each hold
//     D / 8 of its d and sum their chunk of every key; three xor shuffles,
//     each keeping half the keys, leave a lane 4 rows x 2 keys (at D = 256
//     Q would take 128 more registers: Q and K come from shared memory as
//     float4 along d there); the row max and sum by shuffles over the 8
//     lanes of a row; P once through the warp's own shared tile (float4
//     reads along the keys); O += P V with a thread's 4 rows x D / 8
//     columns (float4 reads of V).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9): flash_prefill_wgmma_kernel<D>
// uses 167 / 168 / 167 / 192 / 208 registers for D = 16 / 32 / 64 / 128 /
// 256, no stack, no spills, no serialised wgmma; dynamic shared memory
// (Plan<D>::SMEM) 29.8 / 58.5 / 115.9 / 164.9 / 197.8 KB.
// flash_prefill_f32_kernel<D> uses 128 registers for D = 8 / 16 / 32 / 64
// (two blocks an SM; 48 bytes of spill stores at D = 64, none below), 255
// at D = 128 and 244 at D = 256 (one block an SM, no spills); shared
// memory 25.1 / 38.4 / 65.0 / 84.5 / 224.8 / 171.5 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int q_len, kv_len, heads, kv_heads;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 body: TMA + wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;               // query rows of a block
// Two warpgroups of 64 query rows each; thread 0 also issues the TMA
// loads.  Eight warps (two a scheduler) may hold 255 registers a thread.
constexpr int kThreads = 256;

template <int D>
struct Plan {
  static constexpr int BK = D == 256 ? 64 : 128;       // keys of a tile
  static constexpr int NS = D >= 128 ? 2 : 3;          // ring stages
  static constexpr int BC = D < 64 ? D : 64;           // columns of a box
  static constexpr int RB = BC * 2;                    // bytes of a tile row
  static constexpr int NCB = D / BC;                   // column blocks
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;          // one K (or V) stage
  static constexpr int BARS = 1 + 4 * NS;              // q; k, v full, empty
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * NS * KV_BYTES + 8 * BARS;
  static_assert(SMEM <= 232448, "bf16 flash plan exceeds shared memory");
  static_assert(BK % 16 == 0 && D % 16 == 0, "wgmma steps k by 16");
};

// The online softmax of one tile's scores for this lane's two rows (the
// accumulator's rows g and g + 8; log2 units; masked only where the tile
// crosses the diagonal, or T): s becomes P in f32, m and l are updated,
// and alpha is the rescale of the rows' earlier sums.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               float scale2, bool masked,
                                               int t0, int row_lo, int tq4,
                                               int offset, int Tk) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * nb + e] * scale2;
      if (masked) {
        const int t = t0 + 8 * nb + 2 * tq4 + (e & 1);
        const int i = row_lo + 8 * (e >> 1);
        if (t > i + offset || t >= Tk) x = kNegInf;
      }
      s[4 * nb + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = tiles::exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float x = s[i];
    s[i] = x == kNegInf ? 0.f : tiles::exp2_approx(x - m[r]);
    l[r] += s[i];
  }
}

// P in bf16 A fragments: columns 8 nb .. 8 nb + 7 are half of k-slice
// nb / 2.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
    pa[nb / 2][2 * (nb & 1)] = tiles::pack_bf16(s[4 * nb], s[4 * nb + 1]);
    pa[nb / 2][2 * (nb & 1) + 1] =
        tiles::pack_bf16(s[4 * nb + 2], s[4 * nb + 3]);
  }
}

// Keeps P's fragments in their registers until a wgmma that reads them
// has been waited for.
template <int BK>
__device__ __forceinline__ void fence_frags(uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i])::"memory");
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           const Dims g) {
  using P = Plan<D>;
  constexpr int BK = P::BK, NS = P::NS, BC = P::BC, RB = P::RB;
  constexpr uint32_t kSw = hopper::swizzle_code(RB);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + P::Q_BYTES;               // + st * KV_BYTES
  const uint32_t v_s = k_s + NS * P::KV_BYTES;
  const uint32_t bars = v_s + NS * P::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + NS + st); };
  auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * NS + st); };
  auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * NS + st); };

  const int S = g.q_len, Tk = g.kv_len, H = g.heads, KV = g.kv_heads;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  const int kvh = head / (H / KV);
  const int offset = Tk - S;
  // keys any row of the block sees: t < min(S, q0 + kBQ) + offset (<= T)
  const int t_end = min(S, q0 + kBQ) + offset;
  const int n_tiles = (t_end + BK - 1) / BK;
  const int cw = threadIdx.x / 128;           // this thread's warpgroup

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < NS; ++st) {
      hopper::mbar_init(k_full(st), 1);
      hopper::mbar_init(v_full(st), 1);
      hopper::mbar_init(k_empty(st), 8);     // the block's 8 warps
      hopper::mbar_init(v_empty(st), 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 keeps the ring full: K (or V) of tile i goes into its stage
  // once both warpgroups released the tile NS before it.  Tiles are walked
  // from the diagonal down.
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                  uint32_t empty, int i) {
    const int st = i % NS;
    if (i >= NS) hopper::mbar_wait(empty, ((i / NS) - 1) & 1);
    hopper::mbar_expect_tx(full, P::KV_BYTES);
#pragma unroll
    for (int c = 0; c < P::NCB; ++c)
      hopper::tma_load_4d(ring + st * P::KV_BYTES + c * BK * RB, map, full,
                          c * BC, kvh, (n_tiles - 1 - i) * BK, b);
  };
  auto refill_k = [&](int i) {               // after K of tile i - NS
    if (threadIdx.x == 0 && i < n_tiles)
      load(&tk, k_s, k_full(i % NS), k_empty(i % NS), i);
    __syncwarp();
  };
  auto refill_v = [&](int i) {
    if (threadIdx.x == 0 && i < n_tiles)
      load(&tv, v_s, v_full(i % NS), v_empty(i % NS), i);
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    hopper::prefetch_map(&tq);
    hopper::prefetch_map(&tk);
    hopper::prefetch_map(&tv);
    hopper::mbar_expect_tx(q_full, P::Q_BYTES);
#pragma unroll
    for (int c = 0; c < P::NCB; ++c)
      hopper::tma_load_4d(q_s + c * kBQ * RB, &tq, q_full, c * BC, head, q0,
                          b);
  }
  for (int i = 0; i < NS; ++i) {
    refill_k(i);
    refill_v(i);
  }

  // ---- 64 query rows a warpgroup ----
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq4 = lane & 3;
  const int wg_row0 = q0 + 64 * cw;
  const int row_lo = wg_row0 + 16 * warp + gq;       // and row_lo + 8
  // the last row of this warpgroup that exists, and the last key it sees
  const int wg_last_key = min(wg_row0 + 63, S - 1) + offset;
  const float scale2 = g.scale * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // A (Q, this warpgroup's rows) and B (K) descriptors, K-major; B of
  // P V (V), MN-major: 16 keys a step, 64-column blocks LBO apart.
  auto desc_q = [&](int kk) {
    return hopper::make_desc(q_s + (kk * 16 / BC) * (kBQ * RB) +
                                 64 * cw * RB + (kk * 16 % BC) * 2,
                             16, 8 * RB, kSw);
  };
  auto desc_k = [&](int st, int kk) {
    return hopper::make_desc(k_s + st * P::KV_BYTES +
                                 (kk * 16 / BC) * (BK * RB) +
                                 (kk * 16 % BC) * 2,
                             16, 8 * RB, kSw);
  };
  auto desc_v = [&](int st, int kk) {
    return hopper::make_desc(v_s + st * P::KV_BYTES + kk * 16 * RB,
                             BK * RB, 8 * RB, kSw);
  };

  // Tiles above every row of this warpgroup lead the walk (it starts at
  // the diagonal): their stages are released once landed, unread.
  const int n_skip = wg_row0 >= S ? n_tiles
                     : max(0, n_tiles - 1 - wg_last_key / BK);
  // A stage's K is released once S of its tile has landed, its V once
  // P V has: thread 0 refills K a tile earlier than V.
  auto release_k = [&](int it) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(k_empty(it % NS));
  };
  auto release_v = [&](int it) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(v_empty(it % NS));
  };
  for (int it = 0; it < n_skip; ++it) {
    hopper::mbar_wait(k_full(it % NS), (it / NS) & 1);
    release_k(it);
    refill_k(it + NS);
    hopper::mbar_wait(v_full(it % NS), (it / NS) & 1);
    release_v(it);
    refill_v(it + NS);
  }

  // Waits for tile `it`'s K (V) to land.  They come before the
  // wgmma.fence of a batch: a spin loop between the fence and the
  // products would make ptxas serialise every wgmma.
  auto wait_k = [&](int it) {
    hopper::mbar_wait(k_full(it % NS), (it / NS) & 1);
  };
  auto wait_v = [&](int it) {
    hopper::mbar_wait(v_full(it % NS), (it / NS) & 1);
  };
  auto masked = [&](int it) {             // the tile crosses the diagonal
    const int t0 = (n_tiles - 1 - it) * BK;
    return t0 + BK - 1 > wg_row0 + offset || t0 + BK > Tk;
  };

  // Software pipeline (FlashAttention-3's intra-warpgroup overlap): S of
  // tile it and P V of tile it - 1 are issued together, the softmax of
  // tile it runs while P V runs, and once P V has landed O is rescaled
  // and P's registers take tile it's probabilities.
  hopper::mbar_wait(q_full, 0);
  if (n_skip < n_tiles) {
    float s[BK / 2], alpha[2];
    uint32_t pa[BK / 16][4];
    wait_k(n_skip);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BK>(s, desc_q(kk), desc_k(n_skip % NS, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    release_k(n_skip);
    refill_k(n_skip + NS);
    online_softmax<BK>(s, m, l, alpha, scale2, masked(n_skip),
                       (n_tiles - 1 - n_skip) * BK, row_lo, tq4, offset, Tk);
    pack_p<BK>(s, pa);                     // o is 0: nothing to rescale
    for (int it = n_skip + 1; it < n_tiles; ++it) {
      const int st = it % NS, prev = (it - 1) % NS;
      wait_k(it);
      wait_v(it - 1);
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BK>(s, desc_q(kk), desc_k(st, kk), kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_rs<D>(o, pa[kk], desc_v(prev, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();              // S of tile it has landed
      hopper::fence_regs(s);
      release_k(it);
      refill_k(it + NS);
      online_softmax<BK>(s, m, l, alpha, scale2, masked(it),
                         (n_tiles - 1 - it) * BK, row_lo, tq4, offset, Tk);
      hopper::wgmma_wait<0>();              // P V of tile it - 1 too
      hopper::fence_regs(o);
      fence_frags<BK>(pa);
      release_v(it - 1);
      refill_v(it - 1 + NS);
      rescale<D>(o, alpha);
      pack_p<BK>(s, pa);
    }
    wait_v(n_tiles - 1);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<D>(o, pa[kk], desc_v((n_tiles - 1) % NS, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    fence_frags<BK>(pa);
    release_v(n_tiles - 1);
  }

  // epilogue: 1/l (0 where l == 0), bf16 into this warpgroup's Q rows in
  // the tile's swizzle, then one TMA store per column block
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    inv[r] = lr == 0.f ? 0.f : 1.f / lr;
  }
  const int row_in = 64 * cw + 16 * warp + gq;       // row in the tile
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = 8 * nb + 2 * tq4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = (col / BC) * (kBQ * RB) + (row_in + 8 * r) * RB +
                           (col % BC) * 2;
      *reinterpret_cast<uint32_t*>(gbase + hopper::swizzle<RB>(off)) =
          tiles::pack_bf16(o[4 * nb + 2 * r] * inv[r],
                           o[4 * nb + 2 * r + 1] * inv[r]);
    }
  }
  hopper::fence_proxy_async();
  hopper::bar_sync(1 + cw, 128);
  if (threadIdx.x % 128 == 0 && wg_row0 < S) {
#pragma unroll
    for (int c = 0; c < P::NCB; ++c)
      hopper::tma_store_4d(&to, q_s + c * kBQ * RB + 64 * cw * RB, c * BC,
                           head, wg_row0, b);
    hopper::bulk_commit();
    hopper::bulk_wait_read();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           const Dims& g, cudaStream_t stream) {
  using P = Plan<D>;
  static bool configured = false;      // once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tq, tk, tv, to;
  if (!hopper::bf16_rows_map(&tq, q, batch, g.q_len, g.heads, D, kBQ, P::BC) ||
      !hopper::bf16_rows_map(&tk, k, batch, g.kv_len, g.kv_heads, D, P::BK,
                             P::BC) ||
      !hopper::bf16_rows_map(&tv, v, batch, g.kv_len, g.kv_heads, D, P::BK,
                             P::BC) ||
      !hopper::bf16_rows_map(&to, out, batch, g.q_len, g.heads, D, 64,
                             P::BC))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(g.heads, batch, (g.q_len + kBQ - 1) / kBQ);
  flash_prefill_wgmma_kernel<D><<<grid, kThreads, P::SMEM, stream>>>(
      tq, tk, tv, to, g);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 body: FFMA, register-tiled, mirrored q tiles
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kBQ = 32;                // rows of a q tile
constexpr int kColWarps = 4;           // column warps (x two row warps)

// Dynamic shared bytes of a block: `stages` ring stages of `stage`
// floats (the merge area of `merge` floats reuses the ring) beside
// `rest` floats (the Q tile and the warps' P tiles).
constexpr int block_bytes(int stages, int stage, int merge, int rest) {
  return 4 * (rest + (stages * stage > merge ? stages * stage : merge));
}

template <int D>
struct Plan {
  static constexpr int KW = D <= 128 ? 16 : 8;         // keys of a warp a round
  static constexpr int NJ = KW / 8;                    // keys of a thread
  static constexpr int BK = kColWarps * KW;            // keys of a round
  static constexpr int QS = D + 4, KS = D + 4, VS = D; // row strides (floats)
  static constexpr int PS = KW;                        // P row stride
  static constexpr int MS = D + 4;                     // merge row stride
  static constexpr int VEC = D >= 32 ? 4 : D / 8;      // a thread's column run
  static constexpr int NC = D / 8;                     // columns of a thread
  static constexpr int NV = NC / VEC;                  // runs of a thread
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;   // blocks an SM
  static constexpr int MERGE = kColWarps * kBQ * (MS + 2);
  // ring stages: three where they fit beside the rest at MIN_BLOCKS
  // blocks an SM (each also holds 1 KB the hardware reserves), else two
  static constexpr int NS =
      MIN_BLOCKS * (block_bytes(3, BK * (KS + VS), MERGE,
                                kBQ * QS + 8 * 16 * PS) + 1024) <= 233472
          ? 3 : 2;
  static constexpr int RING = NS * BK * (KS + VS);
  static constexpr int AREA = RING > MERGE ? RING : MERGE;
  static constexpr int SMEM = block_bytes(NS, BK * (KS + VS), MERGE,
                                          kBQ * QS + 8 * 16 * PS);
  // S from Q in registers, split along d over a row's 8 lanes (D / 8
  // each); at D = 256 those would take 128 registers beside the 128 of
  // the output, so Q is read from shared memory there
  static constexpr bool Q_REGS = D <= 128;
  static_assert(SMEM * MIN_BLOCKS <= 232448,
                "f32 flash plan exceeds shared memory");
};

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = *src;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    *dst = src[0];
  }
}

// cp.async rows [row0, row0 + ROWS) of a [*, stride] f32 matrix (W floats a
// row) into a tile of row stride LD; rows at or past `limit` zero-filled.
template <int ROWS, int W, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long long stride, int row0,
                                          int limit) {
  constexpr int C = W / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool ok = row0 + r < limit;
    const float* src = ok ? base + (long long)(row0 + r) * stride + 4 * c
                          : base;
    tiles::cp_async_16(dst + r * LD + 4 * c, src, ok);
  }
}

// Grid (head, batch row, pair p): tile n - 1 - p, then its mirror p.
template <int D>
__global__ void __launch_bounds__(kThreads, Plan<D>::MIN_BLOCKS)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         const Dims g) {
  using P = Plan<D>;
  constexpr int KW = P::KW, NJ = P::NJ, BK = P::BK, NS = P::NS;
  constexpr int QS = P::QS, KS = P::KS, VS = P::VS, PS = P::PS, MS = P::MS;
  constexpr int VEC = P::VEC, NC = P::NC, NV = P::NV;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                              // [kBQ][QS]
  float* const area = qs + kBQ * QS;                   // ring, then merge
  float* const ks = area;                              // [NS][BK][KS]
  float* const vs = ks + NS * BK * KS;                 // [NS][BK][VS]
  float* const mo = area;                              // [4][kBQ][MS]
  float* const mml = mo + kColWarps * kBQ * MS;        // [4][kBQ][2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp / kColWarps, cw = warp % kColWarps;
  // lane = 8 rg + kg: rows rg + 4 i of the warp's 16; kg is the lane's d
  // chunk in S = Q K^T, then its keys kg * NJ + jj and its output columns
  const int rg = lane >> 3, kg = lane & 7;
  float* const pw = area + P::AREA + warp * 16 * PS;   // this warp's P

  const int S = g.q_len, Tk = g.kv_len, H = g.heads, KV = g.kv_heads;
  const int head = blockIdx.x, b = blockIdx.y, pair = blockIdx.z;
  const int kvh = head / (H / KV);
  const int offset = Tk - S;
  const int n_q = (S + kBQ - 1) / kBQ;
  const float scale2 = g.scale * kLog2e;
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const float* qb = q + (long long)b * S * q_row + (long long)head * D;
  float* ob = out + (long long)b * S * q_row + (long long)head * D;
  const float* kb = k + (long long)b * Tk * kv_row + (long long)kvh * D;
  const float* vb = v + (long long)b * Tk * kv_row + (long long)kvh * D;

  for (int pass = 0; pass < 2; ++pass) {
    const int tile = pass == 0 ? n_q - 1 - pair : pair;
    if (pass == 1 && tile >= n_q - 1 - pair) break;    // no mirror
    const int q0 = tile * kBQ;
    // keys any row of the tile sees: t < min(S, q0 + kBQ) + offset (<= T)
    const int t_end = min(S, q0 + kBQ) + offset;
    const int n_rounds = (t_end + BK - 1) / BK;
    auto load_round = [&](int r) {
      const int st = r % NS;
      load_rows<BK, D, KS>(ks + st * BK * KS, kb, kv_row, r * BK, Tk);
      load_rows<BK, D, VS>(vs + st * BK * VS, vb, kv_row, r * BK, Tk);
    };
    load_rows<kBQ, D, QS>(qs, qb, q_row, q0, S);
    load_round(0);
    tiles::cp_async_commit();
#pragma unroll
    for (int r = 1; r < NS - 1; ++r) {
      if (r < n_rounds) load_round(r);
      tiles::cp_async_commit();
    }

    // this thread: rows row_w + rg + 4 i of the warp's 16; keys kg * NJ + j
    // of the warp's KW; output columns ((c / VEC) * 8 + kg) * VEC + c % VEC
    const int row_w = q0 + 16 * rw;                     // first row of the warp
    const int last_key = min(row_w + 15, S - 1) + offset;
    float o[4][NC];
    float m[4], l[4];
    float qr[P::Q_REGS ? 4 : 1][P::Q_REGS ? NC : 1];   // Q, the lane's d chunk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
    }

    for (int r = 0; r < n_rounds; ++r) {
      tiles::cp_async_wait<NS - 2>();      // round r (and Q) arrived
      __syncthreads();                     // ... for all; round r-1 done
      if (r + NS - 1 < n_rounds) load_round(r + NS - 1);
      tiles::cp_async_commit();
      if constexpr (P::Q_REGS) {
        if (r == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < NV; ++n) {
              float run[VEC];
              load_vec<VEC>(run, qs + (16 * rw + rg + 4 * i) * QS +
                                     (n * 8 + kg) * VEC);
#pragma unroll
              for (int e = 0; e < VEC; ++e) qr[i][n * VEC + e] = run[e];
            }
        }
      }
      const int st = r % NS;
      const int t_sub = r * BK + cw * KW;  // first key of the warp's part
      if (row_w >= S || t_sub > last_key) continue;   // above the diagonal
      const float* kt = ks + st * BK * KS + cw * KW * KS;
      const float* vt = vs + st * BK * VS + cw * KW * VS;

      // S = Q K^T for 4 rows x KW keys of the warp
      float sc[4][NJ];
      if constexpr (P::Q_REGS) {
        // each lane sums its d chunk of every key; the 8 partials of a
        // (row, key) then meet by a transposed reduction: each of 3 xor
        // steps keeps half the keys and adds the partner's half, so lane
        // kg ends with keys kg * NJ + jj.  Lane kg walks the keys in the
        // order j ^ (kg * NJ), so what it keeps is always its low half.
        float half[4][KW / 2];
#pragma unroll
        for (int j = 0; j < KW / 2; ++j) {
          float kv[2][NC];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* krow = kt + ((j + h * KW / 2) ^ (kg * NJ)) * KS;
#pragma unroll
            for (int n = 0; n < NV; ++n) {
              float run[VEC];
              load_vec<VEC>(run, krow + (n * 8 + kg) * VEC);
#pragma unroll
              for (int e = 0; e < VEC; ++e) kv[h][n * VEC + e] = run[e];
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = 0.f, c2 = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              a = fmaf(qr[i][c], kv[0][c], a);
              c2 = fmaf(qr[i][c], kv[1][c], c2);
            }
            half[i][j] = a + __shfl_xor_sync(0xffffffffu, c2, 4);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < KW / 4; ++j)
            half[i][j] += __shfl_xor_sync(0xffffffffu, half[i][j + KW / 4], 2);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            sc[i][j] = half[i][j] +
                       __shfl_xor_sync(0xffffffffu, half[i][j + NJ], 1);
        }
      } else {
        // Q and K from shared memory, float4 reads along d (NJ = 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) sc[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; d += 4) {
          float4 qv[4], kv[NJ];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qv[i] = *reinterpret_cast<const float4*>(
                qs + (16 * rw + rg + 4 * i) * QS + d);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            kv[j] = *reinterpret_cast<const float4*>(
                kt + (kg * NJ + j) * KS + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
              sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
              sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
              sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
            }
        }
      }

      // online softmax in log2 units; masks only where the part crosses
      // the diagonal of the warp's first row, or T
      const bool masked = t_sub + KW - 1 > row_w + offset || t_sub + KW > Tk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float x = sc[i][j] * scale2;
          if (masked) {
            const int t = t_sub + kg * NJ + j;
            if (t > row_w + rg + 4 * i + offset || t >= Tk) x = kNegInf;
          }
          sc[i][j] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float alpha = tiles::exp2_approx(m[i] - mx);
        m[i] = mx;
        float p[NJ], sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float x = sc[i][j];
          p[j] = x == kNegInf ? 0.f : tiles::exp2_approx(x - mx);
          sum += p[j];
        }
        store_vec<NJ>(pw + (rg + 4 * i) * PS + kg * NJ, p);
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
      }
      __syncwarp();

      // O += P V: P read as float4 along the keys, V as runs of VEC
#pragma unroll
      for (int k4 = 0; k4 < KW; k4 += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(pw + (rg + 4 * i) * PS + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vrow = vt + (k4 + kk) * VS;
          float vv[NC];
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            float run[VEC];
            load_vec<VEC>(run, vrow + (n * 8 + kg) * VEC);
#pragma unroll
            for (int e = 0; e < VEC; ++e) vv[n * VEC + e] = run[e];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y
                          : kk == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int c = 0; c < NC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
          }
        }
      }
      __syncwarp();
    }
    tiles::cp_async_wait<0>();
    __syncthreads();                       // the ring is free: merge there

    // each column warp's partial: m, l (summed over the row's 8 lanes), O
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li += __shfl_xor_sync(0xffffffffu, li, 4);
      const int row = 16 * rw + rg + 4 * i;
      float* dst = mo + (cw * kBQ + row) * MS;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float run[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) run[e] = o[i][n * VEC + e];
        store_vec<VEC>(dst + (n * 8 + kg) * VEC, run);
      }
      if (kg == 0) {
        mml[(cw * kBQ + row) * 2] = m[i];
        mml[(cw * kBQ + row) * 2 + 1] = li;
      }
    }
    __syncthreads();

    // merge in column-warp order: 8 threads a row, runs of VEC columns
    {
      const int row = tid >> 3, part = tid & 7;
      float mc[kColWarps], w[kColWarps];
      float mmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kColWarps; ++c) {
        mc[c] = mml[(c * kBQ + row) * 2];
        mmax = fmaxf(mmax, mc[c]);
      }
      float lsum = 0.f;
#pragma unroll
      for (int c = 0; c < kColWarps; ++c) {
        w[c] = mc[c] == kNegInf ? 0.f : tiles::exp2_approx(mc[c] - mmax);
        lsum += w[c] * mml[(c * kBQ + row) * 2 + 1];
      }
      const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
      if (q0 + row < S) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int col = (n * 8 + part) * VEC;
          float acc[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
          for (int c = 0; c < kColWarps; ++c) {
            float run[VEC];
            load_vec<VEC>(run, mo + (c * kBQ + row) * MS + col);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w[c], run[e], acc[e]);
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] *= inv;
          store_vec<VEC>(ob + (long long)(q0 + row) * q_row + col, acc);
        }
      }
    }
    __syncthreads();                       // Q and the area are reused
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           const Dims& g, cudaStream_t stream) {
  using P = Plan<D>;
  static bool configured = false;      // once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_q = (g.q_len + kBQ - 1) / kBQ;
  const dim3 grid(g.heads, batch, (n_q + 1) / 2);
  flash_prefill_f32_kernel<D><<<grid, kThreads, P::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace f32

using LaunchFn = int (*)(const void*, const void*, const void*, void*, int,
                         const Dims&, cudaStream_t);

int dim_index(int head_dim) {
  return head_dim == 8 ? 0 : head_dim == 16 ? 1 : head_dim == 32 ? 2
       : head_dim == 64 ? 3 : head_dim == 128 ? 4 : head_dim == 256 ? 5 : -1;
}

// by_dim: the body's launcher for D = 8, 16, 32, 64, 128, 256 (null
// where the body has no instance).
int dispatch(const LaunchFn (&by_dim)[6], int head_dim, const void* q,
             const void* k, const void* v, void* out, int batch, int q_len,
             int kv_len, int heads, int kv_heads, float scale, void* stream) {
  if (kv_len < q_len || kv_heads <= 0 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  const int at = dim_index(head_dim);
  if (at < 0 || by_dim[at] == nullptr) return (int)cudaErrorInvalidValue;
  const Dims g{q_len, kv_len, heads, kv_heads, scale};
  return by_dim[at](q, k, v, out, batch, g,
                    static_cast<cudaStream_t>(stream));
}

// The plan a body is launched with: rows of a q tile, key tile, stages,
// warps and dynamic shared bytes.
template <typename P>
void fill_plan(int (&out)[5], int rows, int keys, int warps) {
  out[0] = rows;
  out[1] = keys;
  out[2] = P::NS;
  out[3] = warps;
  out[4] = P::SMEM;
}

}  // namespace

// q, k, v, out: bf16, contiguous, 16-byte aligned.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int batch, int q_len, int kv_len,
                                  int heads, int kv_heads, int head_dim,
                                  float scale, void* stream) {
  static const LaunchFn by_dim[6] = {nullptr, tc::launch<16>,
                                     tc::launch<32>, tc::launch<64>,
                                     tc::launch<128>, tc::launch<256>};
  return dispatch(by_dim, head_dim, q, k, v, out, batch, q_len, kv_len,
                  heads, kv_heads, scale, stream);
}

// q, k, v, out: float32, contiguous, 16-byte aligned.
extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 void* out, int batch, int q_len, int kv_len,
                                 int heads, int kv_heads, int head_dim,
                                 float scale, void* stream) {
  static const LaunchFn by_dim[6] = {f32::launch<8>, f32::launch<16>,
                                     f32::launch<32>, f32::launch<64>,
                                     f32::launch<128>, f32::launch<256>};
  return dispatch(by_dim, head_dim, q, k, v, out, batch, q_len, kv_len,
                  heads, kv_heads, scale, stream);
}

// The launch plan of the body for `dtype_code` (0 float32, 1 bf16) at
// `head_dim` into out[5] (rows of a q tile, keys of a tile or round,
// stages, warps, dynamic shared bytes); returns 0, or -1 where the body
// has no instance.  kernels/flash_attention.py flash_plan mirrors it.
extern "C" int flash_prefill_plan(int dtype_code, int head_dim, int* out) {
  int p[5];
  switch (dtype_code * 8 + dim_index(head_dim)) {
#define F32_PLAN(i, d) \
    case i: fill_plan<f32::Plan<d>>(p, f32::kBQ, f32::Plan<d>::BK, 8); break;
    F32_PLAN(0, 8) F32_PLAN(1, 16) F32_PLAN(2, 32) F32_PLAN(3, 64)
    F32_PLAN(4, 128) F32_PLAN(5, 256)
#undef F32_PLAN
#define TC_PLAN(i, d) \
    case 8 + i: fill_plan<tc::Plan<d>>(p, tc::kBQ, tc::Plan<d>::BK, 8); break;
    TC_PLAN(1, 16) TC_PLAN(2, 32) TC_PLAN(3, 64) TC_PLAN(4, 128)
    TC_PLAN(5, 256)
#undef TC_PLAN
    default: return -1;
  }
  for (int i = 0; i < 5; ++i) out[i] = p[i];
  return 0;
}
