// k-NN neighbour max for Hopper: rel (B, N, C) = max over each row's k most
// similar rows of x, on keys normalised by the caller, and its gradient.
//
// Forward. Replaces the TPU kernel grafp_tpu/ops/pallas_knn.py:
// _pallas_forward / _kernel / _one_forward (forward of max_neighbors_pallas).
// Its inputs are the keys xn = l2_normalize(x) in x's dtype, which XLA
// computes outside the Pallas call and PyTorch computes outside this one
// (ops/max_neighbors.py), and the raw x; it writes rel in x's dtype. The
// selection rule and the kernel are those of csrc/mrconv_select.cuh with
// kConcat = false: no normalisation launch, one launch of
// mrconv_rows_kernel.
//
// Backward. Replaces _pallas_backward / _bwd_kernel / _one_backward: for
// the cotangent g of rel (B, N, C),
//   dx_j = sum_i sum_r [s(i, j) in round r of row i] G_r(i),
//   G_r(i, ch) = g(i, ch) / cnt_r(i) where round r wins (i, ch), else 0,
// rounded to the matmul dtype, summed in f32, cast to x's dtype. No direct
// term. The Pallas kernel sums dx across query tiles in an output block
// the sequential grid revisits; here pass A (per row tile) writes the
// winners' G_r and the active levels to scratch and pass B (per key tile)
// gathers them, with no atomics, so dx is bit-equal run to run.
//
// Bound on this card: bytes = xn and x in, rel out, 3*B*N*C*sizeof(x)
// (backward: g in too, 4*B*N*C*sizeof(x)); operations = the score product
// 2*B*N^2*C at the dtype's peak, plus a compare and a select per score and
// round, 2*k*B*N^2, on the f32 units (backward: plus the scatter's adds,
// 2*k*B*N*C). What the design does about it: the (N, N) scores never leave
// the chip and selection needs no sort; the selection is
// csrc/mrconv_select.cuh's (bf16 scores on the tensor cores, a second time
// only for row tiles with a tie group), not a design of its own.

#include "mrconv_select.cuh"

extern "C" {

// xn, x (B, N, C) in, out (B, N, C) rel, one dtype (0 = float32, 1 =
// bfloat16). Returns the CUDA error of the launch (0 on success).
int max_neighbors_forward(const void* xn, const void* x, void* out, int b, int n, int c,
                          int k, int dtype, void* stream) {
  if (bad_shape(b, n, c, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* keys = const_cast<void*>(xn);
  if (dtype == 0)
    return select_rows<float, false, false>(
        make_args<float>(x, keys, out, nullptr, nullptr, nullptr, nullptr, b, n, c, k), s);
  if (dtype == 1)
    return select_rows<__nv_bfloat16, false, false>(
        make_args<__nv_bfloat16>(x, keys, out, nullptr, nullptr, nullptr, nullptr,
                                 b, n, c, k), s);
  return cudaErrorInvalidValue;
}

// xn, x, g (B, N, C) in, dx (B, N, C) out, one dtype; scratch the caller
// allocates: grs (B, N, k, C) of that dtype and levels (B, N, k) float32.
// Returns the CUDA error of the launches.
int max_neighbors_backward(const void* xn, const void* x, const void* g, void* grs,
                           void* levels, void* dx, int b, int n, int c, int k,
                           int dtype, void* stream) {
  if (bad_shape(b, n, c, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* keys = const_cast<void*>(xn);
  if (dtype == 0)
    return select_rows<float, true, false>(
        make_args<float>(x, keys, nullptr, g, grs, levels, dx, b, n, c, k), s);
  if (dtype == 1)
    return select_rows<__nv_bfloat16, true, false>(
        make_args<__nv_bfloat16>(x, keys, nullptr, g, grs, levels, dx, b, n, c, k), s);
  return cudaErrorInvalidValue;
}

const char* max_neighbors_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
