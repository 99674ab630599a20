// k-NN max-relative selection on Hopper: the row kernel (forward, and pass
// A of the backward) and the key kernel (pass B of the backward) shared by
// csrc/mrconv_concat.cu, csrc/max_neighbors.cu and csrc/grapher_block.cu.
// They are the body of the TPU kernels grafp_tpu/ops/pallas_knn.py:
// _select_rounds / _one_forward (forward) and _one_backward (backward).
//
// rel(x)_i is the max over row i's k most similar nodes of their features,
// under the Pallas kernels' selection rule (grafp_tpu/ops/pallas_knn.py:
// _select_rounds, _one_forward):
//   * scores are dots of normalised rows xn (in the matmul dtype: bf16 for
//     bf16 x) accumulated in f32;
//   * k threshold rounds on immutable scores: round r takes the whole tie
//     group at the r-th largest distinct score level and extracts the MEAN
//     of its rows of x; round r is active only while the counts of rounds
//     0..r-1 sum to less than k;
//   * rel is the running max of the active rounds' means.
// Where xn comes from is the caller's business: mrconv_concat and the
// fused Grapher normalise in f32 in normalize_rows_kernel; max_neighbors
// takes keys that PyTorch normalised in x's dtype, as XLA does outside
// the Pallas call.
//
// Layout flag kConcat:
//   true:  the forward writes [x || rel - x] (B, N, 2C), rel - x rounded in
//          x's dtype; the backward's cotangent is [g_x || g_rel] (B, N, 2C)
//          and dx gets the direct term g_x - g_rel;
//   false: the forward writes rel (B, N, C) in x's dtype; the cotangent is
//          g_rel (B, N, C) and there is no direct term.
//
// Bound on this card: the score product 2*B*N^2*C at the dtype's peak (989
// TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32), a compare and a
// select per score and round on the f32 units, or the bytes of x in and
// the output written, whichever is larger (chip_smoke.py:bound_ms). The
// product sets it at N = 1024, the bytes at N <= 512 in bf16. What the
// design does about it: the (N, N) scores never leave the chip, bf16
// scores run on the tensor cores, and no score goes through shared memory.
//
// Tiles. A score tile is 64 rows x 128 keys, computed by 8 warps as 4 x 2
// warp tiles of 16 rows x 64 keys, so a row tile has 64 rows at every
// stage and a key tile is no wider than N at N >= 128. A pass of scores
// (ScorePass) runs the fixed tile against every tile of the other side:
//   bf16: a stream of (tile, 64-channel step) items staged as bf16 by
//         cp.async into a double buffer, zero-filled past N and C, the next
//         item in flight while the warps run mma.sync m16n8k16 (bf16 x bf16
//         -> f32) on ldmatrix fragments, 4 k-steps of 16 an item;
//   f32:  32 channels a step, transposed, and one __fmaf_rn chain per score
//         over the channels in order (the tensor cores would round f32 to
//         TF32 and change the selection).
// Either way a score is a fixed sequence of instructions on its own row
// and key, in the same order for every tile: two passes that compute the
// same (row tile, key tile) agree bit for bit, and identical (or power-of-
// two scaled) rows tie exactly. Each thread then holds, in the mma
// accumulator layout, the scores of 2 rows (g, g + 8 of its warp tile) x
// 16 keys of a tile.
//
// Row kernel: one block per (item, tile of 64 rows), 256 threads; KC, the
// levels a row keeps in registers, is 3 for k <= 3 (the models' k) and for
// the split shapes below, else 8:
//   1. pass 1: each thread folds its accumulator registers into a list of
//      each of its two rows' k largest distinct levels with counts
//      (topk_insert), taking a tile's distinct levels largest first and
//      stopping at the first that cannot enter: at most k + 1 inserts a
//      row and tile, whatever the number of scores. After each tile the
//      quad shares its best k-th level, a bound under which no score can
//      enter the row's top k. The lists of a row are merged across the
//      quad with shuffles, then across the two warp columns through shared
//      memory;
//   2. pass 2 recomputes the scores and marks each key whose score equals
//      an active round's level in a per-(row, round) bitmap over the N keys
//      in shared memory (atomicOr, which is order-free);
//   3. four threads per row, each over 16 channels at a time (8 for k >
//      3), walk the set bits in key order and sum the raw features in f32
//      registers with 16-byte loads, so that every thread keeps its own
//      rows' loads in flight. Then the means, the running max over the
//      active rounds, and the output
//      row (forward) or, for the backward, per (row, channel) the winning
//      round and G_r = g_rel / cnt_r rounded to the matmul dtype, written to
//      scratch G (B, N, k, C), and the levels of the active non-empty
//      rounds to scratch (B, N, k) f32 (NaN for the others, so they never
//      match).
// Tie groups may be as large as N (silent segments give identical rows),
// so no per-row state holds indices: only levels, counts and bitmaps.
//
// Key kernel (pass B): one block per (item, tile of 128 keys j); it loops
// over the row tiles and computes S(row tile, key tile) with the row tile
// as the A operand and the same tiles, steps and k-order as pass A, so
// every score is pass A's bit for bit by construction. A score equal to an
// active level of row i marks bit i of a per-(key, round) bitmap over the
// N rows; two threads per key, 32 channels each at a time, then walk the
// set bits in row order and sum G_r(i) in f32, then the direct term
// (kConcat) and the cast. No float atomics: the sums run in the same order
// as in the f32 design before this one (a chain per (row, round) or per
// key, in index order), so f32 outputs are bit-identical to it, and dx is
// bit-equal run to run. The bitmaps' per-row and per-key strides are odd,
// so the threads' walks read distinct shared-memory banks.
//
// Any k <= N and any N (make_plan). The one-pass kernels above take k <= 8
// and k * N <= kMaxKN (8192 bits of bitmap per row or key): every shape
// of the models at k <= 8. Past that the same kernels run split (kSplit),
// as the Pallas kernels' _select_rounds would with its thresh carried:
//   * the rounds go in groups of KC = kGroup (3). Pass 1 of group g keeps
//     the KC largest distinct levels strictly under group g - 1's last
//     level; the consumed count and that level carry from group to group in
//     shared memory, and a block stops after the group in which every
//     row's counts reach k (pass B after the last group with a level);
//   * the bitmaps cover a window of keys (row kernel) or rows (key kernel)
//     at a time, sized so that two blocks stay on an SM; the row kernel's
//     pass 2 and walk run window by window, the key kernel's score pass
//     and walk group by group and window by window;
//   * the f32 sums keep their chains: a round's sum carries from window to
//     window through a workspace (B, N, KC, C) f32, in key order, and
//     pass B's per-key sum from pass to pass through (B, N, C) f32. The
//     running max carries from group to group through (B, N, C) f32 (max
//     is exact and order-free), and pass A keeps the winner as it goes:
//     the first round whose mean reaches the max, none after a NaN; its
//     G_r are written after the last group, with each round's count floored
//     at 1 from (B, N, k). The caller allocates the workspace
//     (select_workspace gives its size).
// Scores stay one fixed instruction sequence per (row, key): every pass of
// every group and window recomputes them bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kMaxK = 8;                 // levels in registers, one-pass, k <= 8
constexpr int kSmallK = 3;               // levels in registers for k <= 3
// levels in registers of a split call, the rounds of one group: three
// passes of 3 levels run faster than two of 8 (PERF.md, PR 12)
constexpr int kGroup = kSmallK;
constexpr int kMaxKN = 8192;             // k * N bits of one bitmap over all N
constexpr int kRows = 64;                // row tile: 4 warp rows of 16 (the mma's M)
constexpr int kKeys = 128;               // key tile: 2 warp columns of 64
constexpr int kWarpKeys = 64;
constexpr int kNT = kWarpKeys / 8;       // mma n8 tiles per warp
constexpr int kStep16 = 64;              // bf16 channels staged per step
constexpr int kPitch16 = kStep16 + 8;    // 144-byte rows: ldmatrix without bank conflicts
constexpr int kStep32 = 32;              // f32 channels staged per step
constexpr int kPitchA32 = kRows + 1;
constexpr int kPitchB32 = kKeys + 2;     // even: float2 reads
constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemMax = 232448;      // 227 KB opt-in per block
constexpr size_t kSmemPair = 115712;     // two blocks on an SM's 228 KB, 1 KB reserved each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// jnp.maximum: NaN propagates
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Fold level s with count w into a descending list of at most k <= KC
// distinct levels. Empty slots hold -inf with count 0. NaN and -inf scores
// never enter. ix keeps the key of a level whose count is 1 (j: the key of
// s when w is 1).
template <int KC>
__device__ __forceinline__ void topk_insert(float (&lv)[KC], int (&ct)[KC], int (&ix)[KC],
                                            float& floor_lv, float s, int w, int j, int k) {
  if (!(s > -INFINITY) || s < floor_lv) return;
  bool equal = false;
#pragma unroll
  for (int r = 0; r < KC; ++r) {
    if (r < k && lv[r] == s) { ct[r] += w; equal = true; }
  }
  if (equal) return;
#pragma unroll
  for (int r = KC - 1; r >= 0; --r) {
    if (r >= k) continue;
    if (r > 0 && lv[r - 1] < s) {
      lv[r] = lv[r - 1];
      ct[r] = ct[r - 1];
      ix[r] = ix[r - 1];
    } else if (lv[r] < s) {
      lv[r] = s;
      ct[r] = w;
      ix[r] = j;
    }
  }
#pragma unroll
  for (int r = 0; r < KC; ++r) {
    if (r == k - 1) floor_lv = lv[r];
  }
}

// --- the score tile ---------------------------------------------------------

template <typename T> __host__ __device__ constexpr size_t stage_bytes();
// two buffers of (64 rows + 128 keys) x 64 channels, bf16
template <> __host__ __device__ constexpr size_t stage_bytes<__nv_bfloat16>() {
  return 2 * (size_t)(kRows + kKeys) * kPitch16 * sizeof(__nv_bfloat16);
}
// one buffer of 32 channels x (64 rows, 128 keys), f32, transposed
template <> __host__ __device__ constexpr size_t stage_bytes<float>() {
  return (size_t)kStep32 * (kPitchA32 + kPitchB32) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16, row-major) . b (16 x 8, col-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Channels c0 .. c0+63 of rows i0.. (buffer rows 0..63) and keys j0..
// (buffer rows 64..191), zero past n and c. vec: 16-byte cp.async (C a
// multiple of 8, keys 16-byte aligned), else plain loads.
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ xnb, int n, int c,
                                           int i0, int j0, int c0, __nv_bfloat16* buf,
                                           bool vec) {
  constexpr int kSegs = kStep16 / 8;
  if (vec) {
    for (int e = threadIdx.x; e < (kRows + kKeys) * kSegs; e += kThreads) {
      const int rr = e / kSegs, ch = c0 + (e % kSegs) * 8;
      const int node = rr < kRows ? i0 + rr : j0 + rr - kRows;
      const bool ok = node < n && ch < c;
      cp_async16(buf + rr * kPitch16 + (e % kSegs) * 8,
                 ok ? xnb + (size_t)node * c + ch : xnb, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < (kRows + kKeys) * kStep16; e += kThreads) {
      const int rr = e / kStep16, cc = e % kStep16, ch = c0 + cc;
      const int node = rr < kRows ? i0 + rr : j0 + rr - kRows;
      buf[rr * kPitch16 + cc] = (node < n && ch < c) ? xnb[(size_t)node * c + ch] : zero;
    }
  }
}

// One 16-channel-step group of the staged item into each warp's
// accumulators, in the m16n8 layout: acc[t][2h + e] is row wr*16 + g + 8h,
// key wc*64 + 8t + 2q + e (warp = wc*4 + wr, lane = 4g + q). ks: the
// item's 16-channel steps (the last zero-padded).
__device__ __forceinline__ void mma_item(const __nv_bfloat16* buf, int ks,
                                         float (&acc)[kNT][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = warp % 4, wc = warp / 4, m = lane / 8, r8 = lane % 8;
  // ldmatrix row addresses: A as a0..a3 (rows 0-7 / 8-15 x k 0-7 / 8-15),
  // B as (tile 2p, k 0-7), (2p, 8-15), (2p+1, 0-7), (2p+1, 8-15)
  const __nv_bfloat16* a_row = buf + (wr * 16 + (m % 2) * 8 + r8) * kPitch16 + (m / 2) * 8;
  const __nv_bfloat16* b_row =
      buf + (kRows + wc * kWarpKeys + (m / 2) * 8 + r8) * kPitch16 + (m % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < kStep16 / 16; ++kk) {
    if (kk < ks) {
      uint32_t a[4];
      ldmatrix_x4(a, a_row + kk * 16);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        uint32_t bq[4];
        ldmatrix_x4(bq, b_row + p * 16 * kPitch16 + kk * 16);
        mma_bf16(acc[2 * p], a, bq[0], bq[1]);
        mma_bf16(acc[2 * p + 1], a, bq[2], bq[3]);
      }
    }
  }
}

// The largest of this thread's 16 scores of its row h (NaN ignored): a
// tile whose largest score is under a row's bound needs no per-score test.
__device__ __forceinline__ float row_max(const float (&acc)[kNT][4], int h) {
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < kNT; ++t) m = fmaxf(m, fmaxf(acc[t][2 * h], acc[t][2 * h + 1]));
  return m;
}

// Row i's active levels of rounds r0 .. r0 + kr - 1 (NaN for the others)
// from the backward's scratch, and the smallest of them (+inf if none).
template <int KC>
__device__ __forceinline__ void row_levels(const float* __restrict__ levels, int n, int k, int i,
                                           int r0, int kr, float (&al)[KC], float& lo) {
  lo = INFINITY;
#pragma unroll
  for (int r = 0; r < KC; ++r) {
    al[r] = (i < n && r < kr) ? levels[(size_t)i * k + r0 + r] : __int_as_float(0x7fc00000);
    if (al[r] == al[r]) lo = fminf(lo, al[r]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
}

// One pass of scores: the fixed tile (the rows from ``fixed`` when
// kRowsFixed, else the keys from ``fixed``) against the tiles of the other
// side from ``lo`` (a multiple of the tile) up to ``hi`` (default: all N),
// in order. next(acc, origin) computes the next tile into acc and gives the
// first row or key of that tile; false at the end.
template <typename T, bool kRowsFixed>
struct ScorePass;

// bf16: the tensor cores, on a stream of (tile, channel step) items through
// a double buffer; the next item's cp.async is in flight while this one
// runs and while the caller selects from acc.
template <bool kRowsFixed>
struct ScorePass<__nv_bfloat16, kRowsFixed> {
  static constexpr int kBuf = (kRows + kKeys) * kPitch16;
  static constexpr int kSpan = kRowsFixed ? kKeys : kRows;
  const __nv_bfloat16* xnb;
  __nv_bfloat16* bufs;
  int n, c, fixed, lo, steps, items, it;
  bool vec;

  __device__ __forceinline__ ScorePass(const __nv_bfloat16* xnb_, int n_, int c_, int fixed_,
                                       void* stage, int lo_ = 0, int hi = -1)
      : xnb(xnb_), bufs(static_cast<__nv_bfloat16*>(stage)), n(n_), c(c_), fixed(fixed_),
        lo(lo_), steps((c_ + kStep16 - 1) / kStep16), it(0),
        vec(c_ % 8 == 0 && reinterpret_cast<uintptr_t>(xnb_) % 16 == 0) {
    items = ((hi < 0 ? n : hi) - lo + kSpan - 1) / kSpan * steps;
    stage_item(0);
  }

  __device__ __forceinline__ void stage_item(int item) {
    const int o = lo + item / steps * kSpan;
    stage_bf16(xnb, n, c, kRowsFixed ? fixed : o, kRowsFixed ? o : fixed,
               item % steps * kStep16, bufs + item % 2 * kBuf, vec);
    cp_async_commit();
  }

  __device__ __forceinline__ bool next(float (&acc)[kNT][4], int& origin) {
    if (it >= items) return false;
    origin = lo + it / steps * kSpan;
    zero(acc);
    for (int s = 0; s < steps; ++s, ++it) {
      if (it + 1 < items) {
        stage_item(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // 16-channel steps in this item, the last zero-padded
      mma_item(bufs + it % 2 * kBuf, min(kStep16, c - s * kStep16 + 15) / 16, acc);
      __syncthreads();   // this buffer is free for the item after next
    }
    return true;
  }
};

// f32: one fmaf chain per score over channels 0..C-1 in order (zero-padded
// channels add exactly nothing).
template <bool kRowsFixed>
struct ScorePass<float, kRowsFixed> {
  static constexpr int kSpan = kRowsFixed ? kKeys : kRows;
  const float* xnb;
  float* as;   // [channel][row]
  float* bs;   // [channel][key]
  int n, c, fixed, o, hi;

  __device__ __forceinline__ ScorePass(const float* xnb_, int n_, int c_, int fixed_,
                                       void* stage, int lo_ = 0, int hi_ = -1)
      : xnb(xnb_), as(static_cast<float*>(stage)),
        bs(static_cast<float*>(stage) + kStep32 * kPitchA32), n(n_), c(c_), fixed(fixed_),
        o(lo_), hi(hi_ < 0 ? n_ : hi_) {}

  __device__ __forceinline__ bool next(float (&acc)[kNT][4], int& origin) {
    if (o >= hi) return false;
    origin = o;
    const int i0 = kRowsFixed ? fixed : o, j0 = kRowsFixed ? o : fixed;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int ra = (warp % 4) * 16 + lane / 4;
    const int kb = (warp / 4) * kWarpKeys + 2 * (lane % 4);
    zero(acc);
    for (int c0 = 0; c0 < c; c0 += kStep32) {
      __syncthreads();   // the previous step's (or tile's) readers are done
      for (int e = tid; e < kRows * kStep32; e += kThreads) {
        const int rr = e / kStep32, cc = e % kStep32, i = i0 + rr, ch = c0 + cc;
        as[cc * kPitchA32 + rr] = (i < n && ch < c) ? xnb[(size_t)i * c + ch] : 0.f;
      }
      for (int e = tid; e < kKeys * kStep32; e += kThreads) {
        const int kk = e / kStep32, cc = e % kStep32, j = j0 + kk, ch = c0 + cc;
        bs[cc * kPitchB32 + kk] = (j < n && ch < c) ? xnb[(size_t)j * c + ch] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kStep32; ++cc) {
        const float a0 = as[cc * kPitchA32 + ra], a1 = as[cc * kPitchA32 + ra + 8];
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          const float2 bv = *reinterpret_cast<const float2*>(bs + cc * kPitchB32 + kb + 8 * t);
          acc[t][0] = __fmaf_rn(a0, bv.x, acc[t][0]);
          acc[t][1] = __fmaf_rn(a0, bv.y, acc[t][1]);
          acc[t][2] = __fmaf_rn(a1, bv.x, acc[t][2]);
          acc[t][3] = __fmaf_rn(a1, bv.y, acc[t][3]);
        }
      }
    }
    o += kSpan;
    return true;
  }
};

// --- the walks' row loads and stores -----------------------------------------

constexpr int kLaneCh = 32;   // channels a thread of pass B sums at a time

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Channels c0 .. c0 + W - 1 (W a multiple of 8) of a row as f32, zero
// past c. full: 16-byte loads (the row 16-byte aligned, every channel
// inside c).
template <int W>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* __restrict__ row, int c0, int c,
                                          bool full, float (&v)[W]) {
  if (full) {
    const uint4* q = reinterpret_cast<const uint4*>(row + c0);
#pragma unroll
    for (int u = 0; u < W / 8; ++u) {
      const uint4 w = q[u];
      const unsigned h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[8 * u + 2 * e] = __uint_as_float(h[e] << 16);
        v[8 * u + 2 * e + 1] = __uint_as_float(h[e] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = c0 + e < c ? to_f(row[c0 + e]) : 0.f;
  }
}

template <int W>
__device__ __forceinline__ void load_lane(const float* __restrict__ row, int c0, int c,
                                          bool full, float (&v)[W]) {
  if (full) {
    const float4* q = reinterpret_cast<const float4*>(row + c0);
#pragma unroll
    for (int u = 0; u < W / 4; ++u) {
      const float4 f = q[u];
      v[4 * u] = f.x;
      v[4 * u + 1] = f.y;
      v[4 * u + 2] = f.z;
      v[4 * u + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = c0 + e < c ? row[c0 + e] : 0.f;
  }
}

// v rounded to the row's dtype into channels c0 .. of a row (none past c).
template <int W>
__device__ __forceinline__ void store_lane(__nv_bfloat16* __restrict__ row, int c0, int c,
                                           bool full, const float (&v)[W]) {
  if (full) {
    uint4* q = reinterpret_cast<uint4*>(row + c0);
#pragma unroll
    for (int u = 0; u < W / 8; ++u) {
      unsigned h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[8 * u + 2 * e])) |
               ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[8 * u + 2 * e + 1])) << 16);
      }
      q[u] = make_uint4(h[0], h[1], h[2], h[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      if (c0 + e < c) row[c0 + e] = __float2bfloat16_rn(v[e]);
    }
  }
}

template <int W>
__device__ __forceinline__ void store_lane(float* __restrict__ row, int c0, int c, bool full,
                                           const float (&v)[W]) {
  if (full) {
    float4* q = reinterpret_cast<float4*>(row + c0);
#pragma unroll
    for (int u = 0; u < W / 4; ++u)
      q[u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      if (c0 + e < c) row[c0 + e] = v[e];
    }
  }
}

// Channels c0 .. c0 + W - 1 of a row copied as they are (none past c).
template <int W, typename T>
__device__ __forceinline__ void copy_lane(const T* __restrict__ src, T* __restrict__ dst,
                                          int c0, int c, bool full) {
  if (full) {
    const uint4* q = reinterpret_cast<const uint4*>(src + c0);
    uint4* d = reinterpret_cast<uint4*>(dst + c0);
#pragma unroll
    for (int u = 0; u < W * (int)sizeof(T) / 16; ++u) d[u] = q[u];
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      if (c0 + e < c) dst[c0 + e] = src[c0 + e];
    }
  }
}

// Row j of x -> x_j / max(||x_j||, 1e-12), computed in f32 and rounded to
// T (the matmul dtype). One warp per row; the sum of squares is one fmaf
// chain per lane and a fixed butterfly, so equal rows get equal results.
template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_rows_kernel(const T* __restrict__ x, T* __restrict__ xn, long long rows, int c) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp
  const T* xr = x + row * c;
  float s = 0.f;
  for (int ch = lane; ch < c; ch += 32) {
    const float v = to_f(xr[ch]);
    s = __fmaf_rn(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  const float nrm = fmaxf(sqrtf(s), kEps);
  for (int ch = lane; ch < c; ch += 32) xn[row * c + ch] = from_f<T>(to_f(xr[ch]) / nrm);
}

// Scratch of the split shapes (make_plan): regions of one workspace the
// caller allocates, nullptr where the plan needs none.
struct Work {
  float* rel;    // (B, N, C): the running max across round groups (row
                 // kernel); dx's partial sums across passes (key kernel)
  float* win;    // (B, N, C): the winning round so far, -1 for none (pass A
                 // across groups)
  int* div;      // (B, N, k): each round's count floored at 1 (pass A)
  float* sums;   // (B, N, KC, C): the rounds' partial sums across key windows
};

// KC: the levels each row keeps in registers, the rounds of one group.
// kBackward = false: the forward, writes out ((B, N, 2C) for kConcat, else
// (B, N, C)).
// kBackward = true: pass A of the backward, reads g (same layouts) and
// writes grs (B, N, k, C) and levels (B, N, k).
// kSplit = false: one group of k <= KC rounds, one bitmap over all N keys
// (k * N <= kMaxKN). kSplit = true: groups of KC rounds, each over windows
// of ``span`` keys (a multiple of kKeys), the state between them in wk.
template <typename T, int KC, bool kBackward, bool kConcat, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2)
mrconv_rows_kernel(const T* __restrict__ x, const T* __restrict__ xn,
                   T* __restrict__ out, const T* __restrict__ g,
                   T* __restrict__ grs, float* __restrict__ levels,
                   Work wk, int n, int c, int k, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lev = reinterpret_cast<float*>(smem + stage_bytes<T>());   // kRows x KC
  int* cnt = reinterpret_cast<int*>(lev + kRows * KC);              // kRows x KC
  int* nact = cnt + kRows * KC;                                     // kRows
  int* key = nact + kRows;                                          // kRows x KC
  int* tied = key + kRows * KC;                                     // kRows
  // kSplit, per row: the level that the next group's levels lie under, and
  // the columns that the rounds so far consumed
  float* thr = reinterpret_cast<float*>(tied + kRows);              // kRows
  int* used = reinterpret_cast<int*>(thr + kRows);                  // kRows
  unsigned* hits = reinterpret_cast<unsigned*>(kSplit ? used + kRows : tied + kRows);
  if (!kSplit) span = n;
  const int words = (span + 31) / 32;
  // kRows x rw; odd: the rows' walks read distinct banks
  const int rw = ((kSplit ? min(k, KC) : k) * words) | 1;

  const int tiles = (n + kRows - 1) / kRows;
  const int b = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) * kRows;
  const T* xb = x + (size_t)b * n * c;
  const T* xnb = xn + (size_t)b * n * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wc = warp / 4, q = lane % 4;
  const int row0 = (warp % 4) * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
  const int key0 = wc * kWarpKeys + 2 * q;       // and keys key0 + 8t + e of a tile
  constexpr int kWidth = kConcat ? 2 : 1;        // out and g row widths, in C
  const float nan = __int_as_float(0x7fc00000);

  if constexpr (!kSplit) {
    for (int e = tid; e < kRows * rw; e += kThreads) hits[e] = 0u;
  } else if (tid < kRows) {
    thr[tid] = INFINITY;
    used[tid] = 0;
  }

  float acc[kNT][4];
  int j0;
  for (int r0 = 0;; r0 += KC) {
  const int kr = kSplit ? min(KC, k - r0) : k;   // this group's rounds
  // 1. levels and counts, from the accumulators. own: this thread's kr-th
  //    level; fl: the quad's best, a bound no level of the row's top kr is
  //    under, so scores below it are skipped; th: the earlier groups' last
  //    level, which scores must lie under
  float lv[2][KC], own[2], fl[2], th[2];
  int ct[2][KC], ix[2][KC];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    own[h] = fl[h] = -INFINITY;
    th[h] = kSplit && r0 > 0 ? thr[row0 + 8 * h] : INFINITY;
#pragma unroll
    for (int r = 0; r < KC; ++r) { lv[h][r] = -INFINITY; ct[h][r] = 0; ix[h][r] = 0; }
  }
  ScorePass<T, true> pass1(xnb, n, c, i0, smem);
  while (pass1.next(acc, j0)) {
    if (j0 + kKeys > n) {   // keys past N never enter
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j0 + key0 + 8 * t + e % 2 >= n) acc[t][e] = -INFINITY;
        }
    }
    if (kSplit && r0 > 0) {   // the earlier groups' levels and all above them
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!(acc[t][e] < th[e / 2])) acc[t][e] = -INFINITY;
        }
    }
    // this tile's distinct levels of each row, largest first, while one
    // can still enter the row's top kr: at most kr + 1 rounds a row, so a
    // warp runs the insert a few times a tile, not once a score
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = row_max(acc, h);
      while (m > -INFINITY && m >= fl[h] && m >= own[h]) {
        int w = 0, jm = 0;
        float below = -INFINITY;
#pragma unroll
        for (int t = 0; t < kNT; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = acc[t][2 * h + e];
            if (s == m) {
              ++w;
              jm = j0 + key0 + 8 * t + e;
            } else if (s < m) {
              below = fmaxf(below, s);
            }
          }
        topk_insert<KC>(lv[h], ct[h], ix[h], own[h], m, w, jm, kr);
        m = below;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float f = own[h];
      f = fmaxf(f, __shfl_xor_sync(kFull, f, 1));
      fl[h] = fmaxf(f, __shfl_xor_sync(kFull, f, 2));
    }
  }
  // merge a row's lists: across the quad (shuffles), then across the two
  // warp columns (shared memory)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float olv[KC];
      int oct[KC], oix[KC];
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        olv[r] = __shfl_xor_sync(kFull, lv[h][r], off);
        oct[r] = __shfl_xor_sync(kFull, ct[h][r], off);
        oix[r] = __shfl_xor_sync(kFull, ix[h][r], off);
      }
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        if (r < kr && oct[r] > 0)
          topk_insert<KC>(lv[h], ct[h], ix[h], own[h], olv[r], oct[r], oix[r], kr);
      }
    }
  }
  if (wc == 1 && q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        lev[(row0 + 8 * h) * KC + r] = lv[h][r];
        cnt[(row0 + 8 * h) * KC + r] = ct[h][r];
        key[(row0 + 8 * h) * KC + r] = ix[h][r];
      }
  }
  __syncthreads();
  int row_tied = 0, row_more = 0;
  if (wc == 0 && q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row0 + 8 * h;
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        const int oc = cnt[rr * KC + r];
        if (r < kr && oc > 0)
          topk_insert<KC>(lv[h], ct[h], ix[h], own[h], lev[rr * KC + r], oc, key[rr * KC + r], kr);
      }
      int consumed = kSplit ? used[rr] : 0, active = 0;
      const int before = consumed;
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        lev[rr * KC + r] = lv[h][r];
        cnt[rr * KC + r] = ct[h][r];
        if (r < kr && consumed < k) {
          active = r + 1;
          // an empty round still consumes one column (count floored at 1)
          consumed += ct[h][r] > 0 ? ct[h][r] : 1;
        }
      }
      nact[rr] = active;
      // a row whose active rounds each hold one key knows its tie groups
      // and marks them here (kSplit: per window); a row with a larger group
      // leaves it to pass 2
      int tie = 0;
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        if (r < active && ct[h][r] > 1) tie = 1;
      }
      tied[rr] = tie;
      row_tied |= tie && i0 + rr < n;
      const int i = i0 + rr;
      if constexpr (!kSplit) {
#pragma unroll
        for (int r = 0; r < KC; ++r) {
          if (!tie && r < active && ct[h][r] == 1)
            atomicOr(&hits[rr * rw + r * words + ix[h][r] / 32], 1u << (ix[h][r] % 32));
        }
      } else {
#pragma unroll
        for (int r = 0; r < KC; ++r) key[rr * KC + r] = ix[h][r];
        used[rr] = consumed;
        thr[rr] = lv[h][KC - 1];
        row_more |= consumed < k && r0 + KC < k && i < n;
        if (kBackward && i < n) {
#pragma unroll
          for (int r = 0; r < KC; ++r) {
            if (r < kr) wk.div[((size_t)b * n + i) * k + r0 + r] = ct[h][r] > 0 ? ct[h][r] : 1;
          }
          // the row's last group: its later rounds match nothing in pass B
          if (before < k && consumed >= k) {
            for (int r = r0 + KC; r < k; ++r) levels[((size_t)b * n + i) * k + r] = nan;
          }
        }
      }
      if constexpr (kBackward) {
        if (i < n) {
          float* lo = levels + ((size_t)b * n + i) * k + r0;
#pragma unroll
          for (int r = 0; r < KC; ++r) {
            if (r < kr) lo[r] = (r < active && ct[h][r] > 0) ? lv[h][r] : nan;
          }
        }
      }
    }
  }
  const bool any_tied = __syncthreads_or(row_tied);
  const bool more = kSplit && __syncthreads_or(row_more);   // another group follows

  float al[2][KC], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = row0 + 8 * h, na = nact[rr];
    lo[h] = INFINITY;
#pragma unroll
    for (int r = 0; r < KC; ++r) {
      al[h][r] = (r < na && cnt[rr * KC + r] > 0) ? lev[rr * KC + r] : nan;
      if (al[h][r] == al[h][r] && i0 + rr < n && tied[rr]) lo[h] = fminf(lo[h], al[h][r]);
    }
  }
  int w0 = 0;   // the window's first key
  do {
  if constexpr (kSplit) {
    // the bitmaps of keys w0 .. w0 + span - 1, with the untied rows' keys
    for (int e = tid; e < kRows * rw; e += kThreads) hits[e] = 0u;
    __syncthreads();
    if (tid < kRows && !tied[tid]) {
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        const int j = key[tid * KC + r] - w0;
        if (r < nact[tid] && cnt[tid * KC + r] == 1 && j >= 0 && j < span)
          hits[tid * rw + r * words + j / 32] |= 1u << (j % 32);
      }
    }
  }

  // 2. for the rows with a tie group of two or more keys, mark the keys of
  //    each active round's tie group
  if (any_tied) {
    ScorePass<T, true> pass2(xnb, n, c, i0, smem, w0, kSplit ? min(w0 + span, n) : -1);
    while (pass2.next(acc, j0)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!(row_max(acc, h) >= lo[h])) continue;
#pragma unroll
        for (int t = 0; t < kNT; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + key0 + 8 * t + e;
            const float s = acc[t][2 * h + e];
            if (j >= n || !(s >= lo[h])) continue;
#pragma unroll
            for (int r = 0; r < KC; ++r) {
              if (al[h][r] == s)
                atomicOr(&hits[(row0 + 8 * h) * rw + r * words + (j - w0) / 32], 1u << (j % 32));
            }
          }
      }
    }
  }
  __syncthreads();

  // 3. per row: the rounds' sums in key order, their means, the running
  //    max over the active rounds, then the output row (forward) or the
  //    winners' cotangents (backward). Four threads a row, W channels each
  //    at a time: every thread walks its row's bitmaps itself and keeps its
  //    own rows' loads in flight. kSplit: the sums carry from window to
  //    window, the running max (and winner) from group to group, in wk.
  constexpr int W = KC <= kSmallK ? 16 : 8;
  const int rr = tid / 4, i = i0 + rr;
  if (i < n) {
  const unsigned* rbits = hits + rr * rw;
  const int na = nact[rr];
  int cr[KC];   // the rounds' counts, 0 past the active ones
#pragma unroll
  for (int r = 0; r < KC; ++r) cr[r] = r < na ? cnt[rr * KC + r] : 0;
  const T* own_row = kBackward ? g + ((size_t)b * n + i) * kWidth * c + (kWidth - 1) * c
                               : xb + (size_t)i * c;
  const bool vec = c % (16 / (int)sizeof(T)) == 0 && aligned16(x) && aligned16(own_row) &&
                   aligned16(kBackward ? (const void*)grs : (const void*)out);
  const size_t row = (size_t)b * n + i;
  for (int c0 = (tid % 4) * W; c0 < c; c0 += 4 * W) {
    const bool full = vec && c0 + W <= c;
    float sum[KC][W], v[W];
#pragma unroll
    for (int r = 0; r < KC; ++r) {
      if (kSplit && w0 > 0) {
        load_lane<W>(wk.sums + (row * KC + r) * c, c0, c, full, sum[r]);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) sum[r][e] = 0.f;
      }
    }
    for (int w = 0; w < words; ++w) {
      unsigned rb[KC], any = 0u;
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        rb[r] = r < kr ? rbits[r * words + w] : 0u;
        any |= rb[r];
      }
      while (any != 0u) {
        const unsigned bit = any & (0u - any);
        any ^= bit;
        const int j = w0 + w * 32 + __ffs(bit) - 1;
        load_lane<W>(xb + (size_t)j * c, c0, c, full, v);
        // a score matches at most one round's level
#pragma unroll
        for (int r = 0; r < KC; ++r) {
          if (rb[r] & bit) {
#pragma unroll
            for (int e = 0; e < W; ++e) sum[r][e] += v[e];
          }
        }
      }
    }
    if (kSplit && w0 + span < n) {   // the next window goes on with these sums
#pragma unroll
      for (int r = 0; r < KC; ++r) store_lane<W>(wk.sums + (row * KC + r) * c, c0, c, full, sum[r]);
      continue;
    }
    // the means (in place; an empty round's is 0: the reference divides a
    // zero sum by a count floored at 1) and their running max. kSplit
    // also keeps the winner as it goes (pass A): the first round whose
    // mean reaches the running max, none once a NaN enters it, as the
    // reference's == test against the final max picks
    float rel[W], wn[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      rel[e] = -INFINITY;
      wn[e] = -1.f;
    }
    if (kSplit && r0 > 0) {
      load_lane<W>(wk.rel + row * c, c0, c, full, rel);
      if (kBackward) load_lane<W>(wk.win + row * c, c0, c, full, wn);
    }
#pragma unroll
    for (int r = 0; r < KC; ++r)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        sum[r][e] = cr[r] > 0 ? sum[r][e] / (float)cr[r] : 0.f;
        if (r < na) {
          if (kSplit && kBackward) {
            if (rel[e] != rel[e] || sum[r][e] != sum[r][e])
              wn[e] = -1.f;
            else if (wn[e] < 0.f || sum[r][e] > rel[e])
              wn[e] = (float)(r0 + r);
          }
          rel[e] = max_nan(rel[e], sum[r][e]);
        }
      }
    if (more) {   // the next group goes on from this max
      store_lane<W>(wk.rel + row * c, c0, c, full, rel);
      if (kBackward) store_lane<W>(wk.win + row * c, c0, c, full, wn);
      continue;
    }
    if constexpr (kBackward || kConcat)
      load_lane<W>(own_row, c0, c, full, v);   // x for the concat, g_rel for the backward
    if constexpr (!kBackward) {
      T* oi = out + ((size_t)b * n + i) * kWidth * c;
      if constexpr (kConcat) {
        copy_lane<W>(own_row, oi, c0, c, full);
#pragma unroll
        for (int e = 0; e < W; ++e) rel[e] = to_f(from_f<T>(rel[e])) - v[e];
        store_lane<W>(oi + c, c0, c, full, rel);
      } else {
        store_lane<W>(oi, c0, c, full, rel);
      }
    } else if constexpr (!kSplit) {
      // the first active round whose mean equals the running max wins (a
      // NaN max has no winner, as in the reference's == test)
      T* gi = grs + ((size_t)b * n + i) * k * c;
      unsigned claimed = 0u;
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        if (r >= k) continue;
        float gr[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          gr[e] = 0.f;
          if (r < na && !(claimed >> e & 1u) && sum[r][e] == rel[e]) {
            claimed |= 1u << e;
            gr[e] = v[e] / (float)(cr[r] > 0 ? cr[r] : 1);
          }
        }
        store_lane<W>(gi + (size_t)r * c, c0, c, full, gr);
      }
    } else {
      // every round's G_r: g_rel / its count where it won, else 0
      T* gi = grs + row * k * c;
      for (int r = 0; r < k; ++r) {
        const float d = (float)wk.div[row * k + r];
        float gr[W];
#pragma unroll
        for (int e = 0; e < W; ++e) gr[e] = wn[e] == (float)r ? v[e] / d : 0.f;
        store_lane<W>(gi + (size_t)r * c, c0, c, full, gr);
      }
    }
  }
  }
  if constexpr (kSplit) __syncthreads();   // the walks are done with the bitmaps
  w0 += span;
  } while (kSplit && w0 < n);
  if (!more) break;
  }
}

// pass B of the backward: dx for one (item, tile of 128 keys j). kSplit:
// the rounds in groups of KC and the rows in windows of ``span`` (a
// multiple of kRows), dx's partial sums between them in wk.rel.
template <typename T, int KC, bool kConcat, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2)
mrconv_keys_kernel(const T* __restrict__ xn, const T* __restrict__ g,
                   const T* __restrict__ grs, const float* __restrict__ levels,
                   T* __restrict__ dx, Work wk, int n, int c, int k, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hits = reinterpret_cast<unsigned*>(smem + stage_bytes<T>());  // kKeys x kw
  if (!kSplit) span = n;
  const int words = (span + 31) / 32;
  // odd: the keys' walks read distinct banks
  const int kw = ((kSplit ? min(k, KC) : k) * words) | 1;

  const int tiles = (n + kKeys - 1) / kKeys;
  const int b = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * kKeys;
  const T* xnb = xn + (size_t)b * n * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = (warp % 4) * 16 + lane / 4;
  const int key0 = (warp / 4) * kWarpKeys + 2 * (lane % 4);

  if constexpr (!kSplit) {
    for (int e = tid; e < kKeys * kw; e += kThreads) hits[e] = 0u;
  }

  const float* levels_b = levels + (size_t)b * n * k;
  // kSplit: the rounds in which any row of the item has a level (active
  // levels are a prefix of a row's k), so the groups after them are skipped
  int rounds = k;
  if constexpr (kSplit) {
    int* top = reinterpret_cast<int*>(hits);
    if (tid == 0) *top = 0;
    __syncthreads();
    int mine = 0;
    for (int i = tid; i < n; i += kThreads) {
      const float* li = levels_b + (size_t)i * k;
      while (mine < k && li[mine] == li[mine]) ++mine;
    }
    atomicMax(top, mine);
    __syncthreads();
    rounds = *top;
  }
  float acc[kNT][4], al[2][KC], lo[2];
  int i0;
  for (int r0 = 0;; r0 += KC) {
  const int kr = kSplit ? min(KC, k - r0) : k;   // this group's rounds
  int w0 = 0;   // the window's first row
  do {
  if constexpr (kSplit) {
    __syncthreads();   // the walks of the window before are done
    for (int e = tid; e < kKeys * kw; e += kThreads) hits[e] = 0u;
    __syncthreads();
  }
  // the row tiles as the A operand, pass A's tiles and k-order: a score
  // equal to an active level of its row marks the row in the key's bitmap
  // (the levels of a row tile are loaded while the tile before it runs)
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row_levels<KC>(levels_b, n, k, w0 + row0 + 8 * h, r0, kr, al[h], lo[h]);
  ScorePass<T, false> pass(xnb, n, c, j0, smem, w0, kSplit ? min(w0 + span, n) : -1);
  while (pass.next(acc, i0)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + row0 + 8 * h;
      if (row_max(acc, h) >= lo[h]) {
#pragma unroll
        for (int t = 0; t < kNT; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = key0 + 8 * t + e;
            const float s = acc[t][2 * h + e];
            if (j0 + jj >= n || !(s >= lo[h])) continue;
#pragma unroll
            for (int r = 0; r < KC; ++r) {
              if (al[h][r] == s)
                atomicOr(&hits[jj * kw + r * words + (i - w0) / 32], 1u << (i % 32));
            }
          }
      }
      row_levels<KC>(levels_b, n, k, i + kRows, r0, kr, al[h], lo[h]);
    }
  }
  __syncthreads();

  // per key: G_r(i) of every marking row i, in row order, summed in f32;
  // then the direct term g_x - g_rel (kConcat) and dx in x's dtype. Two
  // threads a key, kLaneCh channels each at a time: every thread walks its
  // key's bitmaps itself and keeps its own rows' loads in flight. kSplit:
  // group by group, window by window, the sums carried in wk.rel.
  const int jj = tid / 2, j = j0 + jj;
  const bool first = !kSplit || (r0 == 0 && w0 == 0);
  const bool last = !kSplit || (r0 + KC >= rounds && w0 + span >= n);
  if (j < n) {
  const unsigned* kb = hits + jj * kw;
  const T* gb = grs + (size_t)b * n * k * c;
  const T* gj = g + ((size_t)b * n + j) * (kConcat ? 2 : 1) * c;
  T* dj = dx + ((size_t)b * n + j) * c;
  float* pj = wk.rel + ((size_t)b * n + j) * c;
  const bool vec = c % (16 / (int)sizeof(T)) == 0 && aligned16(g) && aligned16(grs) &&
                   aligned16(dx);
  for (int c0 = (tid % 2) * kLaneCh; c0 < c; c0 += 2 * kLaneCh) {
    const bool full = vec && c0 + kLaneCh <= c;
    float sum[kLaneCh], v[kLaneCh];
    if (first) {
#pragma unroll
      for (int e = 0; e < kLaneCh; ++e) sum[e] = 0.f;
    } else {
      load_lane<kLaneCh>(pj, c0, c, full, sum);
    }
    for (int w = 0; w < words; ++w) {
      unsigned rb[KC], any = 0u;
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        rb[r] = r < kr ? kb[r * words + w] : 0u;
        any |= rb[r];
      }
      while (any != 0u) {
        const unsigned bit = any & (0u - any);
        any ^= bit;
        int r = 0;   // a score matches at most one round's level
#pragma unroll
        for (int q = 1; q < KC; ++q) {
          if (rb[q] & bit) r = q;
        }
        const int i = w0 + w * 32 + __ffs(bit) - 1;
        load_lane<kLaneCh>(gb + ((size_t)i * k + r0 + r) * c, c0, c, full, v);
#pragma unroll
        for (int e = 0; e < kLaneCh; ++e) sum[e] += v[e];
      }
    }
    if (!last) {
      store_lane<kLaneCh>(pj, c0, c, full, sum);
      continue;
    }
    if constexpr (kConcat) {
      float gr[kLaneCh];
      load_lane<kLaneCh>(gj, c0, c, full, v);
      load_lane<kLaneCh>(gj + c, c0, c, full, gr);
#pragma unroll
      for (int e = 0; e < kLaneCh; ++e) sum[e] += v[e] - gr[e];
    }
    store_lane<kLaneCh>(dj, c0, c, full, sum);
  }
  }
  w0 += span;
  } while (kSplit && w0 < n);
  if (!kSplit || r0 + KC >= rounds) break;
  }
}

template <typename T>
struct Args {
  const T* x;      // (B, N, C)
  T* xn;           // (B, N, C) normalised rows: scratch, or the caller's keys
  T* out;          // forward: (B, N, 2C) for kConcat, else (B, N, C)
  const T* g;      // backward: cotangent, the layout of out
  T* grs;          // backward scratch: G (B, N, k, C)
  float* levels;   // backward scratch: (B, N, k)
  T* dx;           // backward: (B, N, C)
  int b, n, c, k;
  void* work;      // the workspace of select_workspace's size (nullptr if 0)
};

template <typename T>
cudaError_t normalize(const T* x, T* xn, long long rows, int c, cudaStream_t stream) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  normalize_rows_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, xn, rows, c);
  return cudaGetLastError();
}

// Opt in to ``smem`` bytes of dynamic shared memory and check the grid.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, long long blocks) {
  if (smem > kSmemMax || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the row kernel's shared memory without its bitmaps: staging; levels,
// counts and keys; active rounds and tie flags (kSplit: the carried level
// and consumed count)
template <typename T>
size_t rows_fixed_bytes(int kc, bool split) {
  return stage_bytes<T>() + (size_t)kRows * kc * 12 + (size_t)kRows * (split ? 16 : 8);
}

// bytes of ``per`` bitmaps of kg rounds over ``span`` rows or keys (odd stride)
inline size_t bitmap_bytes(int per, int kg, int span) {
  return (size_t)per * ((kg * ((span + 31) / 32)) | 1) * 4;
}

// The window of a split launch: the most rows or keys (a multiple of
// ``tile``) whose bitmaps fit ``budget`` bytes, then spread evenly over N;
// all N when they fit at once.
inline int window(int n, int kg, int tile, int per, size_t budget) {
  const long long words = ((long long)(budget / (4 * (size_t)per)) - 1) / kg;
  const long long most = words * 32 / tile * tile;
  if (most >= n) return n;
  if (most < tile) return tile;   // larger than the budget: prepare decides
  const long long parts = (n + most - 1) / most, even = (n + parts - 1) / parts;
  return (int)((even + tile - 1) / tile * tile);
}

// What a call runs: the levels per row in registers (kc), whether the
// rounds go in groups or the bitmaps in windows (split), the windows of
// the row and key kernels, and the workspace's regions (byte offsets) and
// size. A split kernel's windows keep two blocks on an SM (kSmemPair).
struct Plan {
  int kc, groups, row_span, key_span;
  bool split;
  size_t rel, win, div, sums, bytes;
};

template <typename T>
Plan make_plan(int b, int n, int c, int k, bool backward) {
  Plan p{};
  p.split = k > kMaxK || (long long)k * n > kMaxKN;
  p.kc = p.split ? kGroup : k <= kSmallK ? kSmallK : kMaxK;
  p.groups = (k + p.kc - 1) / p.kc;
  p.row_span = p.key_span = n;
  if (!p.split) return p;
  const int kg = k < p.kc ? k : p.kc;
  p.row_span = window(n, kg, kKeys, kRows, kSmemPair - rows_fixed_bytes<T>(p.kc, true));
  if (backward) p.key_span = window(n, kg, kRows, kKeys, kSmemPair - stage_bytes<T>());
  const size_t rows = (size_t)b * n;
  auto region = [&](size_t bytes) {
    const size_t at = p.bytes;
    p.bytes += (bytes + 255) / 256 * 256;
    return at;
  };
  if (p.groups > 1 || (backward && p.key_span < n)) p.rel = region(rows * c * 4);
  if (backward && p.groups > 1) p.win = region(rows * c * 4);
  if (backward) p.div = region(rows * k * 4);
  if (p.row_span < n) p.sums = region(rows * p.kc * c * 4);
  return p;
}

inline Work work_of(void* base, const Plan& p) {
  char* w = static_cast<char*>(base);
  return Work{reinterpret_cast<float*>(w + p.rel), reinterpret_cast<float*>(w + p.win),
              reinterpret_cast<int*>(w + p.div), reinterpret_cast<float*>(w + p.sums)};
}

template <typename T, int KC, bool kBackward, bool kConcat, bool kSplit>
cudaError_t launch_rows(const Args<T>& a, const Plan& p, cudaStream_t stream) {
  const size_t smem = rows_fixed_bytes<T>(KC, kSplit) +
                      bitmap_bytes(kRows, kSplit ? p.kc < a.k ? p.kc : a.k : a.k, p.row_span);
  const long long blocks = (long long)a.b * ((a.n + kRows - 1) / kRows);
  auto kernel = mrconv_rows_kernel<T, KC, kBackward, kConcat, kSplit>;
  cudaError_t err = prepare(kernel, smem, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a.x, a.xn, a.out, a.g, a.grs,
                                                      a.levels, work_of(a.work, p), a.n,
                                                      a.c, a.k, p.row_span);
  return cudaGetLastError();
}

template <typename T, int KC, bool kConcat, bool kSplit>
cudaError_t launch_keys(const Args<T>& a, const Plan& p, cudaStream_t stream) {
  // staging, hit bitmaps over the rows (a padded stride per key)
  const size_t smem = stage_bytes<T>() +
                      bitmap_bytes(kKeys, kSplit ? p.kc < a.k ? p.kc : a.k : a.k, p.key_span);
  const long long blocks = (long long)a.b * ((a.n + kKeys - 1) / kKeys);
  auto kernel = mrconv_keys_kernel<T, KC, kConcat, kSplit>;
  cudaError_t err = prepare(kernel, smem, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a.xn, a.g, a.grs, a.levels, a.dx,
                                                      work_of(a.work, p), a.n, a.c, a.k,
                                                      p.key_span);
  return cudaGetLastError();
}

template <typename T, int KC, bool kBackward, bool kConcat, bool kSplit>
cudaError_t select_rows_kc(const Args<T>& a, const Plan& p, cudaStream_t s) {
  cudaError_t err = launch_rows<T, KC, kBackward, kConcat, kSplit>(a, p, s);
  if (!kBackward || err != cudaSuccess) return err;
  return launch_keys<T, KC, kConcat, kSplit>(a, p, s);
}

// The row kernel on keys a.xn that are already in place; for the backward
// (pass A) then pass B. k <= 3 (the models' k) keeps 3 levels per row in
// registers, a larger k kMaxK; k > kMaxK or k * N > kMaxKN runs split, in
// groups of kGroup rounds.
template <typename T, bool kBackward, bool kConcat>
cudaError_t select_rows(const Args<T>& a, cudaStream_t s) {
  const Plan p = make_plan<T>(a.b, a.n, a.c, a.k, kBackward);
  if (p.split) {
    if (p.bytes > 0 && a.work == nullptr) return cudaErrorInvalidValue;
    return select_rows_kc<T, kGroup, kBackward, kConcat, true>(a, p, s);
  }
  if (p.kc == kSmallK) return select_rows_kc<T, kSmallK, kBackward, kConcat, false>(a, p, s);
  return select_rows_kc<T, kMaxK, kBackward, kConcat, false>(a, p, s);
}

template <typename T>
Args<T> make_args(const void* x, void* xn, void* out, const void* g, void* grs,
                  void* levels, void* dx, int b, int n, int c, int k, void* work) {
  return Args<T>{static_cast<const T*>(x), static_cast<T*>(xn), static_cast<T*>(out),
                 static_cast<const T*>(g), static_cast<T*>(grs),
                 static_cast<float*>(levels), static_cast<T*>(dx), b, n, c, k, work};
}

// what the Pallas kernels refuse too (pallas_knn.py asserts N >= k)
bool bad_shape(int b, int n, int c, int k) {
  return b < 1 || n < 1 || c < 1 || k < 1 || n < k;
}

// The workspace of a selection call (0 for the shapes that need none), or
// -1 for a shape or dtype (0 = float32, 1 = bfloat16) it does not take.
long long select_workspace(int b, int n, int c, int k, int dtype, bool backward) {
  if (bad_shape(b, n, c, k)) return -1;
  if (dtype == 0) return (long long)make_plan<float>(b, n, c, k, backward).bytes;
  if (dtype == 1) return (long long)make_plan<__nv_bfloat16>(b, n, c, k, backward).bytes;
  return -1;
}

}  // namespace
