// One eval-mode Grapher block for Hopper: x (B, N, C) -> (B, N, C).
//
// Replaces the TPU kernel grafp_tpu/ops/pallas_knn.py: grapher_block_pallas
// / _grapher_kernel. With every BatchNorm folded into the linear before it
// (w1 (C, C), wg (2C, 2C) dense in the concat layout, w2 (2C, C) in x's
// dtype T; c1 (C), cg (2C), c2 (C) in f32), it computes, rounding to T
// exactly where the Pallas kernel does:
//   x1  = (x . w1 + c1) -> T
//   rel = the max-relative neighbour max of x1, keys normalised in f32 and
//         rounded to T (csrc/mrconv_select.cuh, the selection of
//         mrconv_concat_pallas)
//   cat = [x1 || (rel -> T) - x1], the subtraction in T
//   g   = relu(cat . wg + cg) -> T
//   out = (g . w2 + c2 + x) -> T, the residual added in f32.
// Every product accumulates in f32 inside this file's kernels, as the
// Pallas kernel's body does: no cuBLAS.
//
// Bound on this card: operations = the three products and the score
// product, 2*B*N*C*(7C + N), at the dtype's peak, plus a compare and a
// select per score and round, 2*k*B*N^2, on the f32 units; bytes = x in,
// out written, the weights read once. At B = 128 every stage of size t is
// bound by operations in both dtypes (chip_smoke.py computes it per
// shape).
//
// Design: five launches on the caller's stream, all written here or in
// csrc/mrconv_select.cuh:
//   1. the product kernel with kEpiBias: x1 = (x . w1 + c1) -> T;
//   2. normalize_rows_kernel: the f32-normalised keys of x1 -> T;
//   3. mrconv_rows_kernel<..., kConcat = true>: selection, cat;
//   4. the product kernel with kEpiBiasRelu: g;
//   5. the product kernel with kEpiBiasResidual: out.
// The product kernel is grapher_gemm_wmma_kernel in bf16 and
// grapher_gemm_kernel in f32.
// Selection needs every row of an item's x1 before any row tile can select,
// which is why fc1 and the keys come first, as in the Pallas kernel. The
// products are a plain tiled GEMM with 128 x 128 output tiles: in bf16 on
// the tensor cores (WMMA fragments, f32 accumulators), in f32 on the CUDA
// cores (operands staged through shared memory in steps of 16 along K,
// 8 x 8 fmaf accumulators per thread; f32 operands would lose bits on the
// tensor cores' TF32 path). A simple kernel: x1, the keys, cat and g make a
// round trip through device memory (scratch the caller allocates), the
// tiles are loaded without an asynchronous pipeline; the selection is
// csrc/mrconv_select.cuh's (bf16 scores on the tensor cores).

#include <mma.h>

#include <type_traits>

#include "mrconv_select.cuh"

namespace {

constexpr int kGemmThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 16;   // output tile, K step (f32)
constexpr int kWK = 32, kPad = 8;               // K step and row padding (bf16)
constexpr int kEpiBias = 0, kEpiBiasRelu = 1, kEpiBiasResidual = 2;

template <typename T, int kEpi>
__device__ __forceinline__ void epilogue(float v, const float* __restrict__ bias,
                                         const T* __restrict__ res, T* __restrict__ out,
                                         long long row, int col, int ncols) {
  v += bias[col];
  if constexpr (kEpi == kEpiBiasRelu) v = max_nan(v, 0.f);
  if constexpr (kEpi == kEpiBiasResidual) v = v + to_f(res[row * ncols + col]);
  out[row * ncols + col] = from_f<T>(v);
}

// out[m, o] = epilogue(sum_i a[m, i] * w[i, o] + bias[o]) for a (M, K),
// w (K, N) row-major in T, bias (N) f32, res (M, N) in T, out (M, N) in T.
// One block per 128 x 128 output tile; thread (ty, tx) of a 16 x 16 grid
// owns rows ty + 16 i and columns tx + 16 j, i, j < 8.
template <typename T, int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
grapher_gemm_kernel(const T* __restrict__ a, const T* __restrict__ w,
                    const float* __restrict__ bias, const T* __restrict__ res,
                    T* __restrict__ out, long long m, int kdim, int ncols) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int r = e / kBK, kk = e % kBK;
      const long long row = m0 + r;
      const int col = k0 + kk;
      as[kk][r] = (row < m && col < kdim) ? to_f(a[row * kdim + col]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      const int kk = e / kBN, cc = e % kBN;
      const int row = k0 + kk, col = n0 + cc;
      ws[kk][cc] = (row < kdim && col < ncols) ? to_f(w[(size_t)row * ncols + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < ncols) epilogue<T, kEpi>(acc[i][j], bias, res, out, row, col, ncols);
    }
  }
}

// The same product for bf16 on the tensor cores (WMMA, 16 x 16 x 16 bf16
// fragments, f32 accumulators). 128 x 128 output tile, 8 warps as 2 x 4,
// each warp 64 x 32 (4 x 2 fragments); A (128 x 32) and W (32 x 128) tiles
// staged in shared memory as bf16, 16-byte loads when K and N are
// multiples of 8 and the arrays 16-byte aligned. The epilogue passes each fragment through a per-warp
// 16 x 16 f32 tile in shared memory.
template <int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
grapher_gemm_wmma_kernel(const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ res,
                         __nv_bfloat16* __restrict__ out, long long m, int kdim, int ncols) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  __shared__ __align__(32) bf16 as[kBM][kWK + kPad];
  __shared__ __align__(32) bf16 ws[kWK][kBN + kPad];
  __shared__ __align__(32) float stage[kGemmThreads / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bool vec = kdim % 8 == 0 && ncols % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bf16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < kdim; k0 += kWK) {
    if (vec) {
      for (int e = tid; e < kBM * kWK / 8; e += kGemmThreads) {
        const int r = e / (kWK / 8), cc = e % (kWK / 8) * 8;
        const long long row = m0 + r;
        const int col = k0 + cc;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < m && col < kdim) v = *reinterpret_cast<const uint4*>(a + row * kdim + col);
        *reinterpret_cast<uint4*>(&as[r][cc]) = v;
      }
      for (int e = tid; e < kWK * kBN / 8; e += kGemmThreads) {
        const int r = e / (kBN / 8), cc = e % (kBN / 8) * 8;
        const int row = k0 + r, col = n0 + cc;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < kdim && col < ncols)
          v = *reinterpret_cast<const uint4*>(w + (size_t)row * ncols + col);
        *reinterpret_cast<uint4*>(&ws[r][cc]) = v;
      }
    } else {
      for (int e = tid; e < kBM * kWK; e += kGemmThreads) {
        const int r = e / kWK, cc = e % kWK;
        const long long row = m0 + r;
        const int col = k0 + cc;
        as[r][cc] = (row < m && col < kdim) ? a[row * kdim + col] : zero;
      }
      for (int e = tid; e < kWK * kBN; e += kGemmThreads) {
        const int r = e / kBN, cc = e % kBN;
        const int row = k0 + r, col = n0 + cc;
        ws[r][cc] = (row < kdim && col < ncols) ? w[(size_t)row * ncols + col] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &as[wm * 64 + i * 16][kk], kWK + kPad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &ws[kk][wn * 32 + j * 16], kBN + kPad);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long row = m0 + wm * 64 + i * 16 + e / 16;
        const int col = n0 + wn * 32 + j * 16 + e % 16;
        if (row < m && col < ncols)
          epilogue<bf16, kEpi>(st[e], bias, res, out, row, col, ncols);
      }
      __syncwarp();
    }
}

template <typename T, int kEpi>
cudaError_t gemm(const T* a, const T* w, const float* bias, const T* res, T* out,
                 long long m, int kdim, int ncols, cudaStream_t stream) {
  const long long gx = (m + kBM - 1) / kBM;
  const int gy = (ncols + kBN - 1) / kBN;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    grapher_gemm_wmma_kernel<kEpi><<<dim3((unsigned)gx, gy), kGemmThreads, 0, stream>>>(
        a, w, bias, res, out, m, kdim, ncols);
  else
    grapher_gemm_kernel<T, kEpi><<<dim3((unsigned)gx, gy), kGemmThreads, 0, stream>>>(
        a, w, bias, res, out, m, kdim, ncols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t grapher_block(const T* x, const T* w1, const float* c1, const T* wg,
                          const float* cg, const T* w2, const float* c2, T* x1, T* xn,
                          T* cat, T* gbuf, T* out, int b, int n, int c, int k,
                          cudaStream_t s) {
  const long long m = (long long)b * n;
  cudaError_t err = gemm<T, kEpiBias>(x, w1, c1, nullptr, x1, m, c, c, s);
  if (err != cudaSuccess) return err;
  err = normalize(x1, xn, m, c, s);
  if (err != cudaSuccess) return err;
  Args<T> sel{x1, xn, cat, nullptr, nullptr, nullptr, nullptr, b, n, c, k};
  err = select_rows<T, false, true>(sel, s);
  if (err != cudaSuccess) return err;
  err = gemm<T, kEpiBiasRelu>(cat, wg, cg, nullptr, gbuf, m, 2 * c, 2 * c, s);
  if (err != cudaSuccess) return err;
  return gemm<T, kEpiBiasResidual>(gbuf, w2, c2, x, out, m, 2 * c, c, s);
}

}  // namespace

extern "C" {

// x (B, N, C), w1 (C, C), wg (2C, 2C), w2 (2C, C) in one dtype (0 =
// float32, 1 = bfloat16); c1 (C), cg (2C), c2 (C) float32; scratch of x's
// dtype the caller allocates: x1 and xn (B, N, C), cat and gbuf (B, N, 2C);
// out (B, N, C). Every array contiguous. Returns the CUDA error of the
// launches (0 on success).
int grapher_block_forward(const void* x, const void* w1, const void* c1, const void* wg,
                          const void* cg, const void* w2, const void* c2, void* x1,
                          void* xn, void* cat, void* gbuf, void* out, int b, int n, int c,
                          int k, int dtype, void* stream) {
  if (bad_shape(b, n, c, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(c1);
  const float* fg = static_cast<const float*>(cg);
  const float* f2 = static_cast<const float*>(c2);
  if (dtype == 0) {
    using T = float;
    return grapher_block<T>(static_cast<const T*>(x), static_cast<const T*>(w1), f1,
                            static_cast<const T*>(wg), fg, static_cast<const T*>(w2), f2,
                            static_cast<T*>(x1), static_cast<T*>(xn), static_cast<T*>(cat),
                            static_cast<T*>(gbuf), static_cast<T*>(out), b, n, c, k, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return grapher_block<T>(static_cast<const T*>(x), static_cast<const T*>(w1), f1,
                            static_cast<const T*>(wg), fg, static_cast<const T*>(w2), f2,
                            static_cast<T*>(x1), static_cast<T*>(xn), static_cast<T*>(cat),
                            static_cast<T*>(gbuf), static_cast<T*>(out), b, n, c, k, s);
  }
  return cudaErrorInvalidValue;
}

const char* grapher_block_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
