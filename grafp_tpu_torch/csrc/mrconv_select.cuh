// k-NN max-relative selection on Hopper: the row kernel (forward, and pass
// A of the backward) and the key kernel (pass B of the backward) shared by
// csrc/mrconv_concat.cu, csrc/max_neighbors.cu and csrc/grapher_block.cu.
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
// Row kernel: one block per (item, tile of TR rows), 256 threads, no state
// carried between blocks:
//   1. pass 1 over key tiles of KT = 4096/TR keys: score tile (normalised
//      channels staged through shared memory in chunks of 32), then each
//      thread folds its share of a row's scores into a private list of the
//      row's k largest distinct levels and their counts; the lists of one
//      row are merged with warp shuffles;
//   2. pass 2 recomputes the same scores (the same chain of fmaf over the
//      channels, so every score is bit-identical to pass 1) and adds the
//      raw features of every key whose score equals an active round's level
//      into per-(row, round) f32 sums in shared memory, in key order;
//   3. mean per round, running max over active rounds, and the output row
//      (forward) or, for the backward, per (row, channel) the winning round
//      and G_r = g_rel / cnt_r rounded to the matmul dtype, written to
//      scratch G (B, N, k, C), and the levels of the active non-empty rounds
//      to scratch (B, N, k) f32 (NaN for the others, so they never match).
// Tie groups may be as large as N (silent segments give identical rows),
// so no per-row state holds indices: only levels, counts and sums.
//
// Key kernel (pass B): one block per (item, tile of TR keys j); for every
// row tile it recomputes s(j, i) with the same score_tile. A score is one
// fmaf chain over the channels in order and fmaf is symmetric in its
// factors, so s(j, i) == s(i, j) bit for bit and the compare against pass
// A's levels is exact. Each hit adds the row's G_r into per-key f32 sums in
// shared memory, in row order (one warp per key); then the direct term
// (kConcat) and the cast. No float atomics: dx is bit-equal run to run.
//
// A simple design: the scores are computed on the f32 CUDA cores, twice in
// the forward and three times in the backward, not on the tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;          // must match MAX_K in ops/mrconv_concat.py
constexpr int kChunk = 32;        // channels staged per step
constexpr int kTile = 4096;       // scores per (TR x KT) tile
constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kAccBudget = 96 * 1024;   // bytes of per-(row, round) sums
constexpr size_t kSmemMax = 232448;        // 227 KB opt-in per block

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

// Fold level s with count w into a descending list of at most k distinct
// levels. Empty slots hold -inf with count 0. NaN and -inf scores never
// enter (masked keys are written as NaN).
__device__ __forceinline__ void topk_insert(float (&lv)[kMaxK], int (&ct)[kMaxK],
                                            float& floor_lv, float s, int w, int k) {
  if (!(s > -INFINITY) || s < floor_lv) return;
  bool equal = false;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r < k && lv[r] == s) { ct[r] += w; equal = true; }
  }
  if (equal) return;
#pragma unroll
  for (int r = kMaxK - 1; r >= 0; --r) {
    if (r >= k) continue;
    if (r > 0 && lv[r - 1] < s) {
      lv[r] = lv[r - 1];
      ct[r] = ct[r - 1];
    } else if (lv[r] < s) {
      lv[r] = s;
      ct[r] = w;
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r == k - 1) floor_lv = lv[r];
  }
}

template <int TR>
struct Layout {
  static constexpr int KT = kTile / TR;      // keys per tile
  static constexpr int TY = TR / 4;          // thread rows of the 4x4 micro-tiles
  static constexpr int TX = KT / 4;          // thread columns
  static constexpr int S = kThreads / TR;    // selection threads per row
  static_assert(TY * TX == kThreads, "one 4x4 micro-tile per thread");
  static_assert(S >= 1 && S <= 32 && (32 % S) == 0, "a row's threads share a warp");
};

template <int TR>
size_t smem_bytes(int c, int k) {
  using L = Layout<TR>;
  size_t floats = (size_t)kChunk * (TR + 1)       // row chunk, transposed
                  + (size_t)kChunk * (L::KT + 1)  // key chunk, transposed
                  + (size_t)TR * (L::KT + 1)      // score tile
                  + (size_t)TR * k * c            // per-(row, round) sums
                  + (size_t)TR * kMaxK;           // levels
  return 4 * (floats + (size_t)TR * kMaxK + TR);  // + counts, active rounds
}

// Score tile (TR x KT) for rows i0.. and keys j0.. into sc. Every score is
// one fmaf chain over channels 0..C-1 in order, so a score depends only on
// its two normalised vectors: pass 1 and pass 2 agree bit for bit, and
// identical (or power-of-two scaled) rows tie exactly.
template <typename T, int TR>
__device__ __forceinline__ void score_tile(const T* __restrict__ xnb, int n, int c,
                                           int i0, int j0,
                                           float* rows_c, float* keys_c, float* sc) {
  using L = Layout<TR>;
  const int tid = threadIdx.x;
  const int tx = tid % L::TX, ty = tid / L::TX;
  float a[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[m][q] = 0.f;

  for (int c0 = 0; c0 < c; c0 += kChunk) {
    __syncthreads();  // previous readers of the chunk and score buffers are done
    for (int e = tid; e < TR * kChunk; e += kThreads) {
      const int rr = e / kChunk, cc = e % kChunk;
      const int i = i0 + rr, ch = c0 + cc;
      float v = 0.f;
      if (i < n && ch < c) v = to_f(xnb[(size_t)i * c + ch]);
      rows_c[cc * (TR + 1) + rr] = v;
    }
    for (int e = tid; e < L::KT * kChunk; e += kThreads) {
      const int kk = e / kChunk, cc = e % kChunk;
      const int j = j0 + kk, ch = c0 + cc;
      float v = 0.f;
      if (j < n && ch < c) v = to_f(xnb[(size_t)j * c + ch]);
      keys_c[cc * (L::KT + 1) + kk] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < kChunk; ++cc) {
      float ra[4], kb[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) ra[m] = rows_c[cc * (TR + 1) + ty + m * L::TY];
#pragma unroll
      for (int q = 0; q < 4; ++q) kb[q] = keys_c[cc * (L::KT + 1) + tx + q * L::TX];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[m][q] = __fmaf_rn(ra[m], kb[q], a[m][q]);
    }
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rr = ty + m * L::TY, kk = tx + q * L::TX;
      sc[rr * (L::KT + 1) + kk] = (j0 + kk < n) ? a[m][q] : nan;
    }
  __syncthreads();
}

// Mean of round r's tie group at channel ch from the per-(row, round)
// sums; an empty round gives 0 (the reference divides a zero sum by a count
// floored at 1).
__device__ __forceinline__ float round_mean(const float* acc_i, const int* cnt_i, int r,
                                            int c, int ch) {
  const int cr = cnt_i[r];
  return cr > 0 ? acc_i[(size_t)r * c + ch] / (float)cr : 0.f;
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

// kBackward = false: the forward, writes out ((B, N, 2C) for kConcat, else
// (B, N, C)).
// kBackward = true: pass A of the backward, reads g (same layouts) and
// writes grs (B, N, k, C) and levels (B, N, k).
template <typename T, int TR, bool kBackward, bool kConcat>
__global__ void __launch_bounds__(kThreads)
mrconv_rows_kernel(const T* __restrict__ x, const T* __restrict__ xn,
                   T* __restrict__ out, const T* __restrict__ g,
                   T* __restrict__ grs, float* __restrict__ levels,
                   int n, int c, int k) {
  using L = Layout<TR>;
  extern __shared__ float smem[];
  float* rows_c = smem;                                // kChunk x (TR+1)
  float* keys_c = rows_c + kChunk * (TR + 1);          // kChunk x (KT+1)
  float* sc = keys_c + kChunk * (L::KT + 1);           // TR x (KT+1)
  float* acc = sc + TR * (L::KT + 1);                  // TR x k x c
  float* lev = acc + (size_t)TR * k * c;               // TR x kMaxK
  int* cnt = reinterpret_cast<int*>(lev + TR * kMaxK); // TR x kMaxK
  int* nact = cnt + TR * kMaxK;                        // TR

  const int tiles = (n + TR - 1) / TR;
  const int b = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) * TR;
  const T* xb = x + (size_t)b * n * c;
  const T* xnb = xn + (size_t)b * n * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;
  constexpr int kWidth = kConcat ? 2 : 1;              // out and g row widths, in C

  for (int e = tid; e < TR * k * c; e += kThreads) acc[e] = 0.f;

  // 1. levels and counts
  const int row = tid / L::S, sub = tid % L::S;
  float lv[kMaxK];
  int ct[kMaxK];
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) { lv[r] = -INFINITY; ct[r] = 0; }
  float floor_lv = -INFINITY;

  for (int j0 = 0; j0 < n; j0 += L::KT) {
    score_tile<T, TR>(xnb, n, c, i0, j0, rows_c, keys_c, sc);
    for (int kk = sub; kk < L::KT; kk += L::S)
      topk_insert(lv, ct, floor_lv, sc[row * (L::KT + 1) + kk], 1, k);
  }
  // merge the S partial lists of a row (its threads are adjacent lanes)
#pragma unroll
  for (int off = 1; off < L::S; off <<= 1) {
    float olv[kMaxK];
    int oct[kMaxK];
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      olv[r] = __shfl_xor_sync(kFull, lv[r], off);
      oct[r] = __shfl_xor_sync(kFull, ct[r], off);
    }
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r < k && oct[r] > 0) topk_insert(lv, ct, floor_lv, olv[r], oct[r], k);
    }
  }
  if (sub == 0) {
    int consumed = 0, active = 0;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      lev[row * kMaxK + r] = lv[r];
      cnt[row * kMaxK + r] = ct[r];
      if (r < k && consumed < k) {
        active = r + 1;
        // an empty round still consumes one column (count floored at 1)
        consumed += ct[r] > 0 ? ct[r] : 1;
      }
    }
    nact[row] = active;
    if constexpr (kBackward) {
      const int i = i0 + row;
      if (i < n) {
        float* lo = levels + ((size_t)b * n + i) * k;
        const float nan = __int_as_float(0x7fc00000);
#pragma unroll
        for (int r = 0; r < kMaxK; ++r) {
          if (r < k) lo[r] = (r < active && ct[r] > 0) ? lv[r] : nan;
        }
      }
    }
  }
  // (score_tile's first barrier publishes lev/cnt/nact and the zeroed sums)

  // 2. sums of the features of each active round's tie group
  for (int j0 = 0; j0 < n; j0 += L::KT) {
    score_tile<T, TR>(xnb, n, c, i0, j0, rows_c, keys_c, sc);
    for (int rr = warp; rr < TR; rr += kWarps) {
      if (i0 + rr >= n) continue;
      const int na = nact[rr];
      for (int kk0 = 0; kk0 < L::KT; kk0 += 32) {
        const int kk = kk0 + lane;
        int round = -1;
        if (kk < L::KT) {
          const float s = sc[rr * (L::KT + 1) + kk];
          for (int r = 0; r < na; ++r) {
            if (cnt[rr * kMaxK + r] > 0 && s == lev[rr * kMaxK + r]) round = r;
          }
        }
        unsigned hits = __ballot_sync(kFull, round >= 0);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const int r = __shfl_sync(kFull, round, src);
          const T* xj = xb + (size_t)(j0 + kk0 + src) * c;
          float* dst = acc + ((size_t)rr * k + r) * c;
          for (int ch = lane; ch < c; ch += 32) dst[ch] += to_f(xj[ch]);
        }
      }
    }
  }
  __syncthreads();

  // 3. mean per round, running max over the active rounds, then the
  //    output row (forward) or the winners' cotangents (backward)
  for (int rr = warp; rr < TR; rr += kWarps) {
    const int i = i0 + rr;
    if (i >= n) continue;
    const int na = nact[rr];
    const float* acc_i = acc + (size_t)rr * k * c;
    const int* cnt_i = cnt + rr * kMaxK;
    for (int ch = lane; ch < c; ch += 32) {
      float rel = -INFINITY;
      for (int r = 0; r < na; ++r) rel = max_nan(rel, round_mean(acc_i, cnt_i, r, c, ch));
      if constexpr (!kBackward) {
        T* oi = out + ((size_t)b * n + i) * kWidth * c;
        if constexpr (kConcat) {
          const T xv = xb[(size_t)i * c + ch];
          oi[ch] = xv;
          oi[c + ch] = from_f<T>(to_f(from_f<T>(rel)) - to_f(xv));
        } else {
          oi[ch] = from_f<T>(rel);
        }
      } else {
        // the first active round whose mean equals the running max wins
        // (a NaN max has no winner, as in the reference's == test)
        const float gv = to_f(g[((size_t)b * n + i) * kWidth * c + (kWidth - 1) * c + ch]);
        T* gi = grs + ((size_t)b * n + i) * k * c;
        bool claimed = false;
        for (int r = 0; r < k; ++r) {
          float gr = 0.f;
          if (r < na && !claimed && round_mean(acc_i, cnt_i, r, c, ch) == rel) {
            claimed = true;
            gr = gv / (float)(cnt_i[r] > 0 ? cnt_i[r] : 1);
          }
          gi[(size_t)r * c + ch] = from_f<T>(gr);
        }
      }
    }
  }
}

// pass B of the backward: dx for one (item, tile of TR keys j)
template <typename T, int TR, bool kConcat>
__global__ void __launch_bounds__(kThreads)
mrconv_scatter_kernel(const T* __restrict__ xn, const T* __restrict__ g,
                      const T* __restrict__ grs,
                      const float* __restrict__ levels,
                      T* __restrict__ dx, int n, int c, int k) {
  using L = Layout<TR>;
  extern __shared__ float smem[];
  float* rows_c = smem;                                // kChunk x (TR+1)
  float* keys_c = rows_c + kChunk * (TR + 1);          // kChunk x (KT+1)
  float* sc = keys_c + kChunk * (L::KT + 1);           // TR x (KT+1)
  float* acc = sc + TR * (L::KT + 1);                  // TR x c
  float* lvl = acc + (size_t)TR * c;                   // KT x kMaxK

  const int tiles = (n + TR - 1) / TR;
  const int b = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * TR;
  const T* xnb = xn + (size_t)b * n * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;
  const float nan = __int_as_float(0x7fc00000);

  for (int e = tid; e < TR * c; e += kThreads) acc[e] = 0.f;

  for (int i0 = 0; i0 < n; i0 += L::KT) {
    // sc[jj][ii] = s(j0 + jj, i0 + ii), NaN for i >= n
    score_tile<T, TR>(xnb, n, c, j0, i0, rows_c, keys_c, sc);
    for (int e = tid; e < L::KT * kMaxK; e += kThreads) {
      const int ii = e / kMaxK, r = e % kMaxK, i = i0 + ii;
      lvl[e] = (r < k && i < n) ? levels[((size_t)b * n + i) * k + r] : nan;
    }
    __syncthreads();
    for (int jj = warp; jj < TR; jj += kWarps) {
      if (j0 + jj >= n) continue;
      float* dst = acc + (size_t)jj * c;
      for (int kk0 = 0; kk0 < L::KT; kk0 += 32) {
        const int kk = kk0 + lane;
        int round = -1;
        if (kk < L::KT) {
          const float s = sc[jj * (L::KT + 1) + kk];
#pragma unroll
          for (int r = 0; r < kMaxK; ++r) {
            if (s == lvl[kk * kMaxK + r]) round = r;
          }
        }
        unsigned hits = __ballot_sync(kFull, round >= 0);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const int r = __shfl_sync(kFull, round, src);
          const T* gsrc = grs + (((size_t)b * n + i0 + kk0 + src) * k + r) * c;
          for (int ch = lane; ch < c; ch += 32) dst[ch] += to_f(gsrc[ch]);
        }
      }
    }
    // (the next score_tile's first barrier orders these reads before the
    // next tile's writes of sc and lvl)
  }
  __syncthreads();

  // the direct term g_x - g_rel (kConcat), and dx in x's dtype
  for (int jj = warp; jj < TR; jj += kWarps) {
    const int j = j0 + jj;
    if (j >= n) continue;
    T* dj = dx + ((size_t)b * n + j) * c;
    if constexpr (kConcat) {
      const T* gj = g + ((size_t)b * n + j) * 2 * c;
      for (int ch = lane; ch < c; ch += 32)
        dj[ch] = from_f<T>(acc[(size_t)jj * c + ch] + (to_f(gj[ch]) - to_f(gj[c + ch])));
    } else {
      for (int ch = lane; ch < c; ch += 32) dj[ch] = from_f<T>(acc[(size_t)jj * c + ch]);
    }
  }
}

int pick_rows(int c, int k) {
  int tr = 64;
  while (tr > 8 && (size_t)tr * k * c * 4 > kAccBudget) tr /= 2;
  return tr;
}

// pass B: score staging and tile as in smem_bytes, per-key f32 sums of dx,
// and the staged levels of one row tile
template <int TR>
size_t scatter_smem_bytes(int c) {
  using L = Layout<TR>;
  size_t floats = (size_t)kChunk * (TR + 1) + (size_t)kChunk * (L::KT + 1)
                  + (size_t)TR * (L::KT + 1) + (size_t)TR * c
                  + (size_t)L::KT * kMaxK;
  return 4 * floats;
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
};

template <typename T>
cudaError_t normalize(const T* x, T* xn, long long rows, int c, cudaStream_t stream) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  normalize_rows_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, xn, rows, c);
  return cudaGetLastError();
}

template <typename T, int TR, bool kBackward, bool kConcat>
cudaError_t launch_rows(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<TR>(a.c, a.k);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = mrconv_rows_kernel<T, TR, kBackward, kConcat>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.b * ((a.n + TR - 1) / TR);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a.x, a.xn, a.out, a.g, a.grs,
                                                      a.levels, a.n, a.c, a.k);
  return cudaGetLastError();
}

template <typename T, int TR, bool kConcat>
cudaError_t launch_scatter(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = scatter_smem_bytes<TR>(a.c);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = mrconv_scatter_kernel<T, TR, kConcat>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.b * ((a.n + TR - 1) / TR);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a.xn, a.g, a.grs, a.levels, a.dx,
                                                      a.n, a.c, a.k);
  return cudaGetLastError();
}

// The row kernel on keys a.xn that are already in place; for the backward
// (pass A) then pass B.
template <typename T, bool kBackward, bool kConcat>
cudaError_t select_rows(const Args<T>& a, cudaStream_t s) {
  cudaError_t err;
  switch (pick_rows(a.c, a.k)) {
    case 64: err = launch_rows<T, 64, kBackward, kConcat>(a, s); break;
    case 32: err = launch_rows<T, 32, kBackward, kConcat>(a, s); break;
    case 16: err = launch_rows<T, 16, kBackward, kConcat>(a, s); break;
    default: err = launch_rows<T, 8, kBackward, kConcat>(a, s); break;
  }
  if (!kBackward || err != cudaSuccess) return err;
  switch (pick_rows(a.c, 1)) {
    case 64: return launch_scatter<T, 64, kConcat>(a, s);
    case 32: return launch_scatter<T, 32, kConcat>(a, s);
    case 16: return launch_scatter<T, 16, kConcat>(a, s);
    default: return launch_scatter<T, 8, kConcat>(a, s);
  }
}

template <typename T>
Args<T> make_args(const void* x, void* xn, void* out, const void* g, void* grs,
                  void* levels, void* dx, int b, int n, int c, int k) {
  return Args<T>{static_cast<const T*>(x), static_cast<T*>(xn), static_cast<T*>(out),
                 static_cast<const T*>(g), static_cast<T*>(grs),
                 static_cast<float*>(levels), static_cast<T*>(dx), b, n, c, k};
}

bool bad_shape(int b, int n, int c, int k) {
  return b < 1 || n < 1 || c < 1 || k < 1 || k > kMaxK || n < k;
}

}  // namespace
