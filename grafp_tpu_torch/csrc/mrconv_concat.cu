// Fused MRConv frontend for Hopper: x (B, N, C) -> [x || rel(x) - x].
//
// Replaces the TPU kernel grafp_tpu/ops/pallas_knn.py:_concat_forward /
// _concat_kernel (forward of mrconv_concat_pallas). rel(x)_i is the max
// over row i's k most similar nodes of their features, under the Pallas
// kernel's selection rule:
//   * rows and keys are L2-normalised in f32 (eps 1e-12) and rounded to the
//     matmul dtype (bf16 for bf16 x) before a dot accumulated in f32;
//   * k threshold rounds on immutable scores: round r takes the whole tie
//     group at the r-th largest distinct score level and extracts the MEAN
//     of its rows; round r is active only while the counts of rounds
//     0..r-1 sum to less than k;
//   * rel - x is rounded in x's dtype.
//
// Bound on this card (B=128, size t, every stage has N*C = 65,536):
//   bytes:      x read once, out written once = 3*B*N*C*sizeof(x)
//               (50.3 MB in bf16, 15 us at 3.35 TB/s);
//   operations: the score product, 2*B*N^2*C (17.2 GFLOP at stage 1: 17 us
//               at the 989 TFLOP/s bf16 tensor rate, 257 us at 67 TFLOP/s
//               f32), plus a compare and a select per score and round over
//               the B*N^2 scores (12 us at stage 1 on the f32 units).
//   Stage 1 is bound by operations, stages 2-4 (bf16) by bytes.
// What this design does about it: the (N, N) scores never leave the chip
// (the plain version moves 0.5 GB of scores and 3 masks per call at stage
// 1), and selection needs no sort. It is a simple kernel, far from either
// bound: the product runs on the f32 CUDA cores from shared memory with 4x4
// register tiles, not on the tensor cores (wgmma), the scores are computed
// twice, and the normalised rows make one round trip through memory.
//
// Two launches on the caller's stream. normalize_rows_kernel writes the
// normalised rows, rounded to x's dtype, to a scratch array the caller
// allocates (one warp per row), so no block recomputes a norm or divides.
// mrconv_concat_kernel then runs one block per (item, tile of TR rows),
// 256 threads, no state carried between blocks:
//   1. pass 1 over key tiles of KT = 4096/TR keys: score tile (normalised
//      channels staged through shared memory in chunks of 32), then each thread
//      folds its share of a row's scores into a private list of the row's
//      k largest distinct levels and their counts; the lists of one row are
//      merged with warp shuffles;
//   2. pass 2 recomputes the same scores (the same chain of fmaf over the
//      channels, so every score is bit-identical to pass 1) and adds the
//      raw features of every key whose score equals an active round's level
//      into per-(row, round) f32 sums in shared memory, in key order;
//   3. mean per round, running max over active rounds, and the output row.
// Tie groups may be as large as N (silent segments give identical rows),
// so no per-row state holds indices: only levels, counts and sums.

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

template <typename T, int TR>
__global__ void __launch_bounds__(kThreads)
mrconv_concat_kernel(const T* __restrict__ x, const T* __restrict__ xn,
                     T* __restrict__ out, int n, int c, int k) {
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

  // 3. mean per round, running max over the active rounds, output row
  for (int rr = warp; rr < TR; rr += kWarps) {
    const int i = i0 + rr;
    if (i >= n) continue;
    const T* xi = xb + (size_t)i * c;
    T* oi = out + ((size_t)b * n + i) * 2 * c;
    const int na = nact[rr];
    for (int ch = lane; ch < c; ch += 32) {
      float rel = -INFINITY;
      for (int r = 0; r < na; ++r) {
        const int cr = cnt[rr * kMaxK + r];
        const float feat = cr > 0 ? acc[((size_t)rr * k + r) * c + ch] / (float)cr : 0.f;
        rel = max_nan(rel, feat);
      }
      const T xv = xi[ch];
      oi[ch] = xv;
      oi[c + ch] = from_f<T>(to_f(from_f<T>(rel)) - to_f(xv));
    }
  }
}

int pick_rows(int c, int k) {
  int tr = 64;
  while (tr > 8 && (size_t)tr * k * c * 4 > kAccBudget) tr /= 2;
  return tr;
}

template <typename T, int TR>
cudaError_t launch(const T* x, T* xn, T* out, int b, int n, int c, int k,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<TR>(c, k);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mrconv_concat_kernel<T, TR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * ((n + TR - 1) / TR);
  const long long rows = (long long)b * n;
  const long long norm_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL || norm_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  normalize_rows_kernel<T><<<(unsigned)norm_blocks, kThreads, 0, stream>>>(x, xn, rows, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mrconv_concat_kernel<T, TR><<<(unsigned)blocks, kThreads, smem, stream>>>(x, xn, out, n, c, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xv, void* xnv, void* outv, int b, int n, int c, int k,
                     cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* xn = static_cast<T*>(xnv);
  T* out = static_cast<T*>(outv);
  switch (pick_rows(c, k)) {
    case 64: return launch<T, 64>(x, xn, out, b, n, c, k, s);
    case 32: return launch<T, 32>(x, xn, out, b, n, c, k, s);
    case 16: return launch<T, 16>(x, xn, out, b, n, c, k, s);
    default: return launch<T, 8>(x, xn, out, b, n, c, k, s);
  }
}

}  // namespace

extern "C" {

// x, scratch, out: device pointers to contiguous (B, N, C), (B, N, C) and
// (B, N, 2C) arrays of one dtype (0 = float32, 1 = bfloat16); scratch
// receives the normalised rows. Returns the CUDA error of the launches (0
// on success); the caller checks N >= k and 1 <= k <= kMaxK.
int mrconv_concat_forward(const void* x, void* scratch, void* out, int b, int n, int c,
                          int k, int dtype, void* stream) {
  if (b < 1 || n < 1 || c < 1 || k < 1 || k > kMaxK || n < k) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, scratch, out, b, n, c, k, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, scratch, out, b, n, c, k, s);
  return cudaErrorInvalidValue;
}

const char* mrconv_concat_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
