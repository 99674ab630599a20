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
// Every product accumulates in f32 inside kernels written here, as the
// Pallas kernel's body does: no cuBLAS.
//
// Design: five launches on the caller's stream, all written here, in
// csrc/grapher_gemm.cuh or in csrc/mrconv_select.cuh:
//   1. fc1, the product kernel with kEpiBias: x1 = (x . w1 + c1) -> T;
//   2. normalize_rows_kernel: the f32-normalised keys of x1 -> T;
//   3. mrconv_rows_kernel<..., kConcat = true>: selection, cat;
//   4. the grouped conv, the product kernel with kEpiBiasRelu: g;
//   5. fc2, the product kernel with kEpiBiasResidual: out.
// The product kernel is grapher_gemm_wgmma_kernel in bf16 (wgmma fed by a
// TMA ring, a persistent warp-specialised kernel) and
// grapher_gemm_f32_kernel in f32 (CUDA cores, a cp.async ring, the fmaf
// chain of the kernel before it, bit for bit); csrc/grapher_gemm.cuh says
// how. Selection needs every row of an item's x1 before any row tile can
// select, which is why fc1 and the keys come first, as in the Pallas
// kernel.
//
// Round trips through device memory (scratch the caller allocates): x1 and
// its keys (B, N, C), cat and g (B, N, 2C). At B = 128 in bf16 the products
// move about 168 MB a block, the same at every stage (N C = 65,536).
//
// Bound on this card, per launch, at the model's widths (B = 128): the
// products are bound by bytes in bf16 (x, x1, cat, g and out read or
// written once), except the grouped conv at C = 512, bound by operations
// (8 B N C^2 at 989 TFLOP/s); in f32 they are bound by operations (67
// TFLOP/s). The keys are bound by bytes, the selection as
// csrc/mrconv_select.cuh says. The whole block's bound, as chip_smoke.py
// computes it, counts x in, out written and the weights once, and the
// products and the score product at the dtype's peak.
//
// What the design does about it: the bf16 products keep their operands'
// loads in flight on the TMA unit while the tensor cores work, size the
// column tile from Nout, and hand each output tile to a TMA store that
// overlaps the next tile; on the card they run at or near the bytes bound
// at stages 1-3 (PERF.md). The f32 products keep their loads in flight with
// cp.async and read shared memory as float4. The round trips stay: fusing
// the products with the selection (the Pallas design) is later work.

#include "grapher_gemm.cuh"

namespace {

template <typename T>
cudaError_t grapher_block(const T* x, const T* w1, const float* c1, const T* wg,
                          const float* cg, const T* w2, const float* c2, T* x1, T* xn,
                          T* cat, T* gbuf, T* out, void* work, int b, int n, int c, int k,
                          cudaStream_t s) {
  const long long m = (long long)b * n;
  cudaError_t err = gemm<kEpiBias>(x, w1, c1, nullptr, x1, m, c, c, s);
  if (err != cudaSuccess) return err;
  err = normalize(x1, xn, m, c, s);
  if (err != cudaSuccess) return err;
  Args<T> sel{x1, xn, cat, nullptr, nullptr, nullptr, nullptr, b, n, c, k, work};
  err = select_rows<T, false, true>(sel, s);
  if (err != cudaSuccess) return err;
  err = gemm<kEpiBiasRelu>(cat, wg, cg, nullptr, gbuf, m, 2 * c, 2 * c, s);
  if (err != cudaSuccess) return err;
  return gemm<kEpiBiasResidual>(gbuf, w2, c2, x, out, m, 2 * c, c, s);
}

}  // namespace

extern "C" {

// Bytes of the selection's workspace (0 for most shapes; -1 for a shape or
// dtype the kernels do not take).
long long grapher_block_workspace(int b, int n, int c, int k, int dtype) {
  return select_workspace(b, n, c, k, dtype, false);
}

// x (B, N, C), w1 (C, C), wg (2C, 2C), w2 (2C, C) in one dtype (0 =
// float32, 1 = bfloat16); c1 (C), cg (2C), c2 (C) float32; scratch of x's
// dtype the caller allocates: x1 and xn (B, N, C), cat and gbuf (B, N, 2C);
// work: grapher_block_workspace bytes (may be null when that is 0); out
// (B, N, C). Every array contiguous. Returns the CUDA error of the
// launches (0 on success).
int grapher_block_forward(const void* x, const void* w1, const void* c1, const void* wg,
                          const void* cg, const void* w2, const void* c2, void* x1,
                          void* xn, void* cat, void* gbuf, void* out, void* work, int b,
                          int n, int c, int k, int dtype, void* stream) {
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
                            static_cast<T*>(gbuf), static_cast<T*>(out), work, b, n, c, k, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return grapher_block<T>(static_cast<const T*>(x), static_cast<const T*>(w1), f1,
                            static_cast<const T*>(wg), fg, static_cast<const T*>(w2), f2,
                            static_cast<T*>(x1), static_cast<T*>(xn), static_cast<T*>(cat),
                            static_cast<T*>(gbuf), static_cast<T*>(out), work, b, n, c, k, s);
  }
  return cudaErrorInvalidValue;
}

const char* grapher_block_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
