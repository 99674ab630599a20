// Fused MRConv frontend for Hopper: x (B, N, C) -> [x || rel(x) - x], and
// its gradient.
//
// Forward. Replaces the TPU kernel grafp_tpu/ops/pallas_knn.py:
// _concat_forward / _concat_kernel (forward of mrconv_concat_pallas).
// rel(x)_i is the max over row i's k most similar nodes of their features,
// under the Pallas kernel's selection rule:
//   * rows and keys are L2-normalised in f32 (eps 1e-12) and rounded to the
//     matmul dtype (bf16 for bf16 x) before a dot accumulated in f32;
//   * k threshold rounds on immutable scores: round r takes the whole tie
//     group at the r-th largest distinct score level and extracts the
//     MEAN of its rows; round r is active only while the counts of rounds
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
// 1), selection needs no sort, the bf16 scores run on the tensor cores
// (mma.sync) and are selected from the accumulator registers, and row
// tiles of 64 and key tiles of 128 leave no padded keys at N >= 128
// (csrc/mrconv_select.cuh). Still far from the bound: at N = 1024 the fold
// of the scores into the level lists is bound by instruction throughput,
// a row tile with a tie group of two or more keys computes its scores a
// second time, and the normalised rows make one round trip through memory.
//
// Two launches on the caller's stream. normalize_rows_kernel writes the
// normalised rows, rounded to x's dtype, to a scratch array the caller
// allocates (one warp per row), so no block recomputes a norm or divides.
// mrconv_rows_kernel<..., kConcat = true> then selects and writes the
// concat (csrc/mrconv_select.cuh describes it).
//
// Backward. Replaces the TPU kernel grafp_tpu/ops/pallas_knn.py:
// _concat_backward / _concat_bwd_kernel / _one_backward. For the cotangent
// g = [g_x || g_rel] (B, N, 2C):
//   dx_j = g_x,j - g_rel,j + sum_i sum_r [s(i, j) in round r of row i] G_r(i)
//   G_r(i, ch) = g_rel(i, ch) / cnt_r(i) where round r wins (i, ch): it is
//   active and the first round whose mean equals the running max; else 0;
//   rounded to the matmul dtype. The sum accumulates in f32; dx is cast to
//   x's dtype.
// Bound on this card (B=512 in training): bytes = x and g in, dx out =
// 4*B*N*C*sizeof(x); operations = the score product once, 2*B*N^2*C at the
// dtype's peak, plus one compare per score and round (k*B*N^2 on the f32
// units). At stage 1 it is bound by operations, at stages 2-4 (bf16) by
// bytes.
// Design. The Pallas kernel sums dx across query tiles in an output block
// that the sequential grid revisits; CUDA blocks run in no order, so the
// scatter becomes a gather in a second pass, and no float atomics are used:
// dx is bit-equal from run to run. Three launches: normalize_rows_kernel,
// as in the forward; pass A, mrconv_rows_kernel<..., backward, concat>,
// which writes the winners' cotangents G_r and the active levels to
// scratch; pass B, mrconv_keys_kernel<..., concat>, which gathers them
// per key tile (csrc/mrconv_select.cuh describes both). The scores are
// computed two or three times, in bf16 on the tensor cores; pass B computes
// each (row tile, key tile) as pass A does, so its compares against pass
// A's levels are exact.

#include "mrconv_select.cuh"

namespace {

// forward: normalise, then the row kernel; backward: normalise, pass A
// (the row kernel in its backward form), pass B
template <typename T, bool kBackward>
cudaError_t dispatch(const Args<T>& a, cudaStream_t s) {
  cudaError_t err = normalize(a.x, a.xn, (long long)a.b * a.n, a.c, s);
  if (err != cudaSuccess) return err;
  return select_rows<T, kBackward, true>(a, s);
}

}  // namespace

extern "C" {

// Bytes of the workspace a call needs (0 for most shapes; -1 for a shape
// or dtype the kernels do not take), forward (backward = 0) or backward.
long long mrconv_concat_workspace(int b, int n, int c, int k, int dtype, int backward) {
  return select_workspace(b, n, c, k, dtype, backward != 0);
}

// x, scratch, out: device pointers to contiguous (B, N, C), (B, N, C) and
// (B, N, 2C) arrays of one dtype (0 = float32, 1 = bfloat16); scratch
// receives the normalised rows; work: mrconv_concat_workspace bytes (may
// be null when that is 0). Returns the CUDA error of the launches (0 on
// success); a shape with N < k is refused.
int mrconv_concat_forward(const void* x, void* scratch, void* out, void* work, int b,
                          int n, int c, int k, int dtype, void* stream) {
  if (bad_shape(b, n, c, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, false>(
        make_args<float>(x, scratch, out, nullptr, nullptr, nullptr, nullptr, b, n, c, k,
                         work), s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, false>(
        make_args<__nv_bfloat16>(x, scratch, out, nullptr, nullptr, nullptr, nullptr,
                                 b, n, c, k, work), s);
  return cudaErrorInvalidValue;
}

// x (B, N, C), g (B, N, 2C) in, dx (B, N, C) out, one dtype; scratch the
// caller allocates: xn (B, N, C) and grs (B, N, k, C) of that dtype,
// levels (B, N, k) float32, and the workspace. Returns the CUDA error of
// the launches.
int mrconv_concat_backward(const void* x, const void* g, void* xn, void* grs,
                           void* levels, void* dx, void* work, int b, int n, int c,
                           int k, int dtype, void* stream) {
  if (bad_shape(b, n, c, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, true>(
        make_args<float>(x, xn, nullptr, g, grs, levels, dx, b, n, c, k, work), s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, true>(
        make_args<__nv_bfloat16>(x, xn, nullptr, g, grs, levels, dx, b, n, c, k, work), s);
  return cudaErrorInvalidValue;
}

const char* mrconv_concat_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
