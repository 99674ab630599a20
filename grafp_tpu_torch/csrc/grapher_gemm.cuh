// The three products of the fused Grapher block (csrc/grapher_block.cu) on
// Hopper: out = epilogue(a . w + bias) for a (M, K) and w (K, Nout), both
// row-major in T, bias (Nout) f32 and, for the residual, res (M, Nout) in
// T. Every product accumulates in f32; the epilogue adds the bias in f32,
// then applies relu (kEpiBiasRelu) or adds the residual in f32
// (kEpiBiasResidual), and rounds to T once.
//
// bf16: grapher_gemm_wgmma_kernel, a persistent warp-specialised kernel.
//   * Tiles: 128 rows (two consumer warpgroups of 64) x up to 256 columns,
//     in chunks of 64. A column tile is the whole Nout where Nout <= 256,
//     else 256-wide tiles and a narrower last one, so Nout = 64 wastes
//     nothing. K goes in steps of 64 (one 128-byte swizzle row).
//   * One producer warpgroup fills a ring of 3 stages (a 128 x 64 tile of
//     a and up to 4 chunks of 64 x 64 of w, 48 KB a stage) while the
//     consumers run wgmma.mma_async m64nNk16 (N = 64 x chunks, bf16 x bf16
//     -> f32 in registers) on the stages that have arrived. Stages are
//     handed over with mbarriers: "full" when the bytes have landed,
//     "empty" when both consumer warpgroups' wgmmas have read them.
//   * Loads: TMA (cp.async.bulk.tensor, 128-byte swizzle, out-of-bounds
//     rows and the K tail filled with zeros) where both arrays' rows are a
//     multiple of 16 bytes; w stays (K, Nout) row-major and is read
//     MN-major by the descriptor (no transposed copy). Other widths (TMA's
//     stride rule refuses them, e.g. C = 20) take a path in the same
//     kernel where the producer warpgroup copies the same swizzled tiles
//     with 4-byte cp.async (2-byte loads where rows are not 4-byte
//     aligned), then fences them for the tensor cores' proxy.
//   * Each block walks its tiles in order (column tiles fastest, so blocks
//     that run together share a's rows in L2): the producer loads the next
//     tile's stages while the consumers run this tile's epilogue.
//   * Epilogue from the accumulator registers, through each consumer
//     warpgroup's 64-row output tile in shared memory (TMA's 128-byte
//     swizzle, so a warp's 4-byte writes hit 32 banks): the residual
//     arrives there by TMA while the products run; each thread adds the
//     bias (staged in shared memory once per block) and the residual in
//     f32, applies relu, rounds, and writes its bf16 pairs back; one thread
//     stores the tile with TMA, which overlaps the next tile's products.
//     On the cp.async path each thread stores its outputs itself.
// f32: grapher_gemm_f32_kernel on the CUDA cores (TF32 tensor cores would
//   change the JAX package's f32 results): 128 x 128 tiles, 256 threads of
//   8 x 8 outputs, K in steps of 16 through a 3-stage cp.async ring: w in
//   16-byte copies (4-byte where Nout is not a multiple of 4), a in 4-byte
//   copies, transposed into rows of 132 floats, so both are read as float4
//   without bank conflicts. Each output is one __fmaf_rn chain over K in
//   index order, the K tail padded with zeros as before, so the outputs are
//   bit for bit those of the kernel before this one (8 x 8 outputs,
//   16-deep K steps, no pipeline).
//
// Bound on this card, per product: bytes = a in, out (and res) written or
// read once, w once; operations = 2 M K Nout at the dtype's peak. At the
// model's widths (B = 128) a bf16 product is bound by bytes, except the
// grouped conv at C = 512 (bound by operations); f32 by operations.

#pragma once

#include <cuda.h>

#include "mrconv_select.cuh"

namespace {

constexpr int kEpiBias = 0, kEpiBiasRelu = 1, kEpiBiasResidual = 2;

template <int kEpi>
__device__ __forceinline__ float finish(float acc, float bias, float res) {
  float v = acc + bias;
  if constexpr (kEpi == kEpiBiasRelu) v = max_nan(v, 0.f);
  if constexpr (kEpi == kEpiBiasResidual) v = v + res;
  return v;
}

bool host_aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

// --- bf16 on wgmma -----------------------------------------------------------

constexpr int kWgRows = 128;             // row tile: two consumer warpgroups of 64
constexpr int kWgChunk = 64;             // columns per chunk: one 128-byte swizzle row of w
constexpr int kWgMaxChunks = 4;          // widest column tile: 256
constexpr int kWgK = 64;                 // K per stage: one 128-byte swizzle row of a
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;          // the producer warpgroup, then two consumer warpgroups
constexpr int kWgConsumerWarps = 8;      // each releases a stage once
constexpr int kAccRegs = kWgMaxChunks * kWgChunk / 2;          // f32 per consumer thread
constexpr uint32_t kATile = kWgRows * kWgK * 2;                // 16 KB
constexpr uint32_t kBChunk = kWgK * kWgChunk * 2;              // 8 KB
constexpr uint32_t kStage = kATile + kWgMaxChunks * kBChunk;   // 48 KB
constexpr uint32_t kOutChunk = 64 * kWgChunk * 2;              // 64 x 64 outputs, 8 KB
constexpr uint32_t kOutTile = kWgMaxChunks * kOutChunk;        // a warpgroup's outputs
// after 1 KB of alignment: the ring, the two warpgroups' output tiles, the
// barriers (full, empty, the residual's), then the bias (Nout f32)
constexpr size_t kWgSmem =
    1024 + (size_t)kWgStages * kStage + 2 * kOutTile + (2 * kWgStages + 2) * 8;

constexpr int kFlagTma = 1, kFlagPairsA = 2, kFlagPairsW = 4;

struct GemmShape {
  long long m, tiles;
  int kdim, ncols, col_tiles, k_steps;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete. A phase that never
// completes (a fault in the hand-over) traps after ~2^26 tries, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// byte offset of element e of row r in rows of 128 bytes, 128-byte swizzle
__device__ __forceinline__ uint32_t swizzle128(int r, int e) {
  return r * 128 + ((((e >> 3) ^ r) & 7) << 4) + (e & 7) * 2;
}

// Elements [0, valid) of src (valid <= 2), zeros after, into 4 bytes at dst:
// cp.async where the pair is 4-byte aligned, else two 2-byte loads.
__device__ __forceinline__ void copy_pair(uint32_t dst, const __nv_bfloat16* src, int valid,
                                          bool pairs) {
  if (pairs) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(2 * valid)
                 : "memory");
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    const uint32_t lo = valid > 0 ? s[0] : 0u, hi = valid > 1 ? s[1] : 0u;
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(lo | hi << 16) : "memory");
  }
}

// The producer warp's copy of one stage where TMA is refused: the same
// swizzled layout TMA writes, zeros past M, K and Nout.
__device__ __forceinline__ void copy_stage(const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ w,
                                           const GemmShape& s, uint32_t a_s, uint32_t b_s,
                                           long long m0, int n0, int nch, int k0, int flags) {
  const int lane = threadIdx.x % 32;
  const bool pa = flags & kFlagPairsA, pw = flags & kFlagPairsW;
  for (int i = lane; i < kWgRows * kWgK / 2; i += 32) {
    const int r = i / (kWgK / 2), e = i % (kWgK / 2) * 2;
    const long long row = m0 + r;
    const int col = k0 + e;
    const int valid = row < s.m ? min(max(s.kdim - col, 0), 2) : 0;
    copy_pair(a_s + swizzle128(r, e), valid ? a + row * s.kdim + col : a, valid, pa);
  }
  for (int i = lane; i < nch * kWgK * (kWgChunk / 2); i += 32) {
    const int c = i / (kWgK * (kWgChunk / 2)), rem = i % (kWgK * (kWgChunk / 2));
    const int kr = rem / (kWgChunk / 2), e = rem % (kWgChunk / 2) * 2;
    const int row = k0 + kr, col = n0 + c * kWgChunk + e;
    const int valid = row < s.kdim ? min(max(s.ncols - col, 0), 2) : 0;
    copy_pair(b_s + c * kBChunk + swizzle128(kr, e),
              valid ? w + (size_t)row * s.ncols + col : w, valid, pw);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keep the compiler from moving accumulator reads across a wgmma wait
template <int kRegs>
__device__ __forceinline__ void fence_acc(float (&d)[kAccRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 NCH, f32) += a (64 x 16, K-major) . w (16 x 64 NCH, MN-major)
template <int NCH>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kAccRegs], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<1>(float (&d)[kAccRegs], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<2>(float (&d)[kAccRegs], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<3>(float (&d)[kAccRegs], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<4>(float (&d)[kAccRegs], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

struct EpiArgs {
  const float* bias;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  long long m;
  int ncols;
};

// 2-D TMA store of the box at (c0 inner, c1 outer) from src
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// this warpgroup's 128 threads (named barriers 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One consumer warpgroup's work on one tile: 64 rows x 64 NCH columns over
// every K stage, then the epilogue. it counts the stages consumed, tiles
// this warpgroup's tiles.
//
// With TMA the epilogue goes through the warpgroup's output tile in shared
// memory, in TMA's 128-byte swizzle: the residual arrives there by TMA
// while the products run, each thread adds the bias (from shared memory)
// and the residual to its accumulators, rounds, writes its bf16 pairs back
// (the swizzle puts the 8 rows of a warp's store on distinct banks), and
// one thread stores the tile with TMA, which overlaps the next tile. Without
// TMA each thread stores its pairs to device memory itself.
template <int NCH, int kEpi>
__device__ __forceinline__ uint32_t consume_tile(
    float (&acc)[kAccRegs], uint32_t base, uint32_t bars, const float* bias_s, uint32_t it,
    uint32_t tiles, int k_steps, long long m0, int n0, bool tma, const CUtensorMap* map_out,
    const CUtensorMap* map_res, const EpiArgs& e) {
  const int cw = threadIdx.x / 128 - 1;    // consumer warpgroup: rows 64 cw ..
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, q = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t out_s = base + kWgStages * kStage + cw * kOutTile;
  const uint32_t res_bar = bars + 8 * (2 * kWgStages + cw);
  constexpr bool kRes = kEpi == kEpiBiasResidual;
  if (tma && leader) {
    // the previous tile's stores have read the output tile
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    if constexpr (kRes) {
      mbar_expect_tx(res_bar, NCH * kOutChunk);
      for (int c = 0; c < NCH; ++c)
        tma_load(out_s + c * kOutChunk, map_res, res_bar, n0 + c * kWgChunk, (int)m0 + 64 * cw);
    }
  }
#pragma unroll
  for (int i = 0; i < NCH * 32; ++i) acc[i] = 0.f;
  uint32_t prev = 0;
  for (int kb = 0; kb < k_steps; ++kb, ++it) {
    const uint32_t st = it % kWgStages, ph = (it / kWgStages) & 1;
    mbar_wait(bars + 8 * st, ph);
    const uint32_t a_s = base + st * kStage + cw * 64 * 128, b_s = base + st * kStage + kATile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk)
      wgmma_bf16<NCH>(acc, smem_desc(a_s + kk * 32, 16, 1024),
                      smem_desc(b_s + kk * 16 * 128, kBChunk, 1024));
    wgmma_commit();
    wgmma_wait<1>();       // the stage before this one has been read
    fence_acc<NCH * 32>(acc);
    if (kb > 0 && lane == 0) mbar_arrive(bars + 8 * (kWgStages + prev));
    prev = st;
  }
  wgmma_wait<0>();
  fence_acc<NCH * 32>(acc);
  if (lane == 0) mbar_arrive(bars + 8 * (kWgStages + prev));

  // accumulator layout: register 4j + 2h + {0, 1} holds row lane / 4 + 8h
  // of the warp's 16, columns 8j + 2 (lane % 4) + {0, 1}
  const int r0 = warp * 16 + lane / 4;     // row in the warpgroup's 64
  if (tma) {
    if constexpr (kRes) {
      mbar_wait(res_bar, tiles & 1);
    } else {
      wg_sync(cw);                           // the leader saw the last store read
    }
#pragma unroll
    for (int j = 0; j < NCH * 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      const float2 b = *reinterpret_cast<const float2*>(bias_s + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const uint32_t addr = out_s + j / 8 * kOutChunk + r * 128 + (((j ^ r) & 7) << 4) + 4 * q;
        float2 rv = make_float2(0.f, 0.f);
        if constexpr (kRes) {
          uint32_t raw;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(raw) : "r"(addr));
          rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        }
        const uint32_t packed = pack_bf16(finish<kEpi>(acc[4 * j + 2 * h], b.x, rv.x),
                                          finish<kEpi>(acc[4 * j + 2 * h + 1], b.y, rv.y));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(packed) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(cw);
    if (leader) {
      for (int c = 0; c < NCH; ++c)
        tma_store(map_out, out_s + c * kOutChunk, n0 + c * kWgChunk, (int)m0 + 64 * cw);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  } else {
#pragma unroll
    for (int j = 0; j < NCH * 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + 64 * cw + r0 + 8 * h;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int col = n0 + 8 * j + 2 * q + x;
          if (row >= e.m || col >= e.ncols) continue;
          const float r = kRes ? to_f(e.res[row * e.ncols + col]) : 0.f;
          e.out[row * e.ncols + col] =
              __float2bfloat16_rn(finish<kEpi>(acc[4 * j + 2 * h + x], bias_s[col], r));
        }
      }
    }
  }
  return it;
}

__device__ __forceinline__ void tile_at(const GemmShape& s, long long t, long long& m0,
                                        int& n0, int& nch) {
  m0 = t / s.col_tiles * kWgRows;
  n0 = (int)(t % s.col_tiles) * kWgMaxChunks * kWgChunk;
  nch = min(kWgMaxChunks, (s.ncols - n0 + kWgChunk - 1) / kWgChunk);
}

// Columns of the bias in shared memory: Nout rounded up to whole tiles, so
// the epilogue of a ragged tile reads inside it.
__host__ __device__ __forceinline__ int bias_cols(int ncols) {
  return (ncols + kWgMaxChunks * kWgChunk - 1) / (kWgMaxChunks * kWgChunk) * kWgMaxChunks *
         kWgChunk;
}

// One producer warpgroup (threads 0..127; one thread issues the TMA loads,
// or the first warp copies) and two consumer warpgroups. The producer
// gives up registers (setmaxnreg 40) so that each consumer thread has 232
// for its 128 accumulators.
template <int kEpi>
__global__ void __launch_bounds__(kWgThreads, 1)
grapher_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_w,
                          const __grid_constant__ CUtensorMap map_out,
                          const __grid_constant__ CUtensorMap map_res,
                          const __nv_bfloat16* __restrict__ a,
                          const __nv_bfloat16* __restrict__ w, const GemmShape s,
                          const EpiArgs e, int flags) {
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;           // 128-byte swizzle wants 1 KB
  const uint32_t bars = base + kWgStages * kStage + 2 * kOutTile;   // full, empty, residual
  float* bias_s = reinterpret_cast<float*>(wg_smem + (bars - raw) + (2 * kWgStages + 2) * 8);
  const bool tma = flags & kFlagTma;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kWgStages + i), kWgConsumerWarps);
    }
    mbar_init(bars + 8 * (2 * kWgStages), 1);
    mbar_init(bars + 8 * (2 * kWgStages + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < bias_cols(s.ncols); i += kWgThreads)
    bias_s[i] = i < s.ncols ? e.bias[i] : 0.f;
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // in TMA mode one thread issues, else the first warp copies
    if (threadIdx.x >= (tma ? 1 : 32)) return;
    uint32_t it = 0;
    for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      long long m0;
      int n0, nch;
      tile_at(s, t, m0, n0, nch);
      for (int kb = 0; kb < s.k_steps; ++kb, ++it) {
        const uint32_t st = it % kWgStages, ph = (it / kWgStages) & 1;
        const uint32_t a_s = base + st * kStage, b_s = a_s + kATile, full = bars + 8 * st;
        mbar_wait(bars + 8 * (kWgStages + st), ph ^ 1);
        if (tma) {
          mbar_expect_tx(full, kATile + nch * kBChunk);
          tma_load(a_s, &map_a, full, kb * kWgK, (int)m0);
          for (int c = 0; c < nch; ++c)
            tma_load(b_s + c * kBChunk, &map_w, full, n0 + c * kWgChunk, kb * kWgK);
        } else {
          copy_stage(a, w, s, a_s, b_s, m0, n0, nch, kb * kWgK, flags);
          __syncwarp();
          if (threadIdx.x == 0) mbar_arrive(full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float acc[kAccRegs];
  uint32_t it = 0, tiles = 0;
  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x, ++tiles) {
    long long m0;
    int n0, nch;
    tile_at(s, t, m0, n0, nch);
#define GRAPHER_CONSUME(N)                                                                \
  it = consume_tile<N, kEpi>(acc, base, bars, bias_s, it, tiles, s.k_steps, m0, n0, tma, \
                             &map_out, &map_res, e)
    switch (nch) {
      case 1: GRAPHER_CONSUME(1); break;
      case 2: GRAPHER_CONSUME(2); break;
      case 3: GRAPHER_CONSUME(3); break;
      default: GRAPHER_CONSUME(4); break;
    }
#undef GRAPHER_CONSUME
  }
  // the output tile must outlive its last TMA store
  if (tma && threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query,
// so the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (outer, inner) row-major bf16 array read in boxes of (box_outer,
// box_inner = 64) with the 128-byte swizzle, zeros out of bounds.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, long long inner, long long outer,
                       int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kEpi>
cudaError_t gemm(const __nv_bfloat16* a, const __nv_bfloat16* w, const float* bias,
                 const __nv_bfloat16* res, __nv_bfloat16* out, long long m, int kdim,
                 int ncols, cudaStream_t stream) {
  GemmShape s;
  s.m = m;
  s.kdim = kdim;
  s.ncols = ncols;
  s.col_tiles = (ncols + kWgMaxChunks * kWgChunk - 1) / (kWgMaxChunks * kWgChunk);
  s.k_steps = (kdim + kWgK - 1) / kWgK;
  s.tiles = (m + kWgRows - 1) / kWgRows * s.col_tiles;
  CUtensorMap map_a{}, map_w{}, map_out{}, map_res{};
  int flags = 0;
  if (kdim % 8 == 0 && ncols % 8 == 0 && host_aligned(a, 16) && host_aligned(w, 16) &&
      host_aligned(out, 16) && (res == nullptr || host_aligned(res, 16))) {
    cudaError_t err = tensor_map(&map_a, a, kdim, m, kWgRows);
    if (err == cudaSuccess) err = tensor_map(&map_w, w, ncols, kdim, kWgK);
    if (err == cudaSuccess) err = tensor_map(&map_out, out, ncols, m, 64);
    if (err == cudaSuccess && res != nullptr) err = tensor_map(&map_res, res, ncols, m, 64);
    if (err != cudaSuccess) return err;
    flags |= kFlagTma;
  }
  if (kdim % 2 == 0 && host_aligned(a, 4)) flags |= kFlagPairsA;
  if (ncols % 2 == 0 && host_aligned(w, 4)) flags |= kFlagPairsW;
  const EpiArgs e{bias, res, out, m, ncols};
  const long long sms = sm_count(), blocks = s.tiles < sms ? s.tiles : sms;
  const size_t smem = kWgSmem + (size_t)bias_cols(ncols) * sizeof(float);
  auto kernel = grapher_gemm_wgmma_kernel<kEpi>;
  cudaError_t err = prepare(kernel, smem, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kWgThreads, smem, stream>>>(map_a, map_w, map_out, map_res, a, w,
                                                         s, e, flags);
  return cudaGetLastError();
}

// --- f32 on the CUDA cores ---------------------------------------------------

constexpr int kF32Rows = 128, kF32Cols = 128, kF32K = 16, kF32Stages = 3;
constexpr int kF32Threads = 256;
constexpr int kF32Pitch = kF32Rows + 4;               // a transposed: K rows of 132 floats
constexpr int kF32AStage = kF32K * kF32Pitch;         // floats
constexpr int kF32BStage = kF32K * kF32Cols;
constexpr size_t kF32Smem = (size_t)kF32Stages * (kF32AStage + kF32BStage) * sizeof(float);

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// a rows m0.. x K columns k0.., transposed (4-byte copies: neighbouring
// lanes read neighbouring k of a row), and w rows k0.. x columns n0..
// (16-byte copies where Nout % 4 == 0 and w is aligned); zeros outside
__device__ __forceinline__ void f32_stage(const float* __restrict__ a,
                                          const float* __restrict__ w, float* as, float* bs,
                                          long long m, int kdim, int ncols, long long m0,
                                          int n0, int k0, bool vec_w) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kF32Rows * kF32K; i += kF32Threads) {
    const int r = i / kF32K, kk = i % kF32K;
    const long long row = m0 + r;
    const bool ok = row < m && k0 + kk < kdim;
    cp_async4(as + kk * kF32Pitch + r, ok ? a + row * kdim + k0 + kk : a, ok);
  }
  if (vec_w) {
    for (int i = tid; i < kF32K * kF32Cols / 4; i += kF32Threads) {
      const int kr = i / (kF32Cols / 4), cq = i % (kF32Cols / 4) * 4;
      const bool ok = k0 + kr < kdim && n0 + cq < ncols;
      cp_async16(bs + kr * kF32Cols + cq, ok ? w + (size_t)(k0 + kr) * ncols + n0 + cq : w, ok);
    }
  } else {
    for (int i = tid; i < kF32K * kF32Cols; i += kF32Threads) {
      const int kr = i / kF32Cols, cc = i % kF32Cols;
      const bool ok = k0 + kr < kdim && n0 + cc < ncols;
      cp_async4(bs + kr * kF32Cols + cc, ok ? w + (size_t)(k0 + kr) * ncols + n0 + cc : w, ok);
    }
  }
}

// Thread (ty, tx) of a 16 x 16 grid owns rows 64 h + 4 ty + i and columns
// 64 h' + 4 tx + j (h, h' < 2; i, j < 4) of a 128 x 128 tile; per k it reads
// 8 values of a and 8 of w as four float4 (two addresses a warp for a,
// 16 consecutive for w: no bank conflicts) for 64 fmaf.
template <int kEpi>
__global__ void __launch_bounds__(kF32Threads, 2)
grapher_gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ res,
                        float* __restrict__ out, long long m, int kdim, int ncols,
                        int col_tiles, int flags) {
  extern __shared__ float4 f32_smem[];
  float* as = reinterpret_cast<float*>(f32_smem);
  float* bs = as + kF32Stages * kF32AStage;
  const long long m0 = (long long)(blockIdx.x / col_tiles) * kF32Rows;
  const int n0 = (int)(blockIdx.x % col_tiles) * kF32Cols;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k_steps = (kdim + kF32K - 1) / kF32K;
  const bool vec_w = flags & 1;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kF32Stages - 1; ++st) {
    if (st < k_steps)
      f32_stage(a, w, as + st * kF32AStage, bs + st * kF32BStage, m, kdim, ncols, m0, n0,
                st * kF32K, vec_w);
    cp_async_commit();
  }
  for (int kb = 0; kb < k_steps; ++kb) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();   // stage kb landed for all; stage kb - 1 read by all
    const int next = kb + kF32Stages - 1;
    if (next < k_steps) {
      const int slot = next % kF32Stages;
      f32_stage(a, w, as + slot * kF32AStage, bs + slot * kF32BStage, m, kdim, ncols, m0,
                n0, next * kF32K, vec_w);
    }
    cp_async_commit();
    const float* ap = as + (kb % kF32Stages) * kF32AStage + ty * 4;
    const float* bp = bs + (kb % kF32Stages) * kF32BStage + tx * 4;
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(ap + kk * kF32Pitch);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + kk * kF32Pitch + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(bp + kk * kF32Cols);
      const float4 b1 = *reinterpret_cast<const float4*>(bp + kk * kF32Cols + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }

  const bool vec = flags & 2;   // Nout % 4 == 0, bias, res, out aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + i / 4 * 64 + ty * 4 + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= ncols) continue;
      float* o = out + row * ncols + col;
      if (vec) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
        float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kEpi == kEpiBiasResidual)
          r = *reinterpret_cast<const float4*>(res + row * ncols + col);
        *reinterpret_cast<float4*>(o) =
            make_float4(finish<kEpi>(acc[i][4 * h], b.x, r.x),
                        finish<kEpi>(acc[i][4 * h + 1], b.y, r.y),
                        finish<kEpi>(acc[i][4 * h + 2], b.z, r.z),
                        finish<kEpi>(acc[i][4 * h + 3], b.w, r.w));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j >= ncols) break;
          const float r = kEpi == kEpiBiasResidual ? res[row * ncols + col + j] : 0.f;
          o[j] = finish<kEpi>(acc[i][4 * h + j], bias[col + j], r);
        }
      }
    }
  }
}

template <int kEpi>
cudaError_t gemm(const float* a, const float* w, const float* bias, const float* res,
                 float* out, long long m, int kdim, int ncols, cudaStream_t stream) {
  const int col_tiles = (ncols + kF32Cols - 1) / kF32Cols;
  const long long blocks = (m + kF32Rows - 1) / kF32Rows * col_tiles;
  int flags = 0;
  if (ncols % 4 == 0 && host_aligned(w, 16)) flags |= 1;
  if (ncols % 4 == 0 && host_aligned(bias, 16) && host_aligned(out, 16) &&
      (res == nullptr || host_aligned(res, 16)))
    flags |= 2;
  auto kernel = grapher_gemm_f32_kernel<kEpi>;
  cudaError_t err = prepare(kernel, kF32Smem, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kF32Threads, kF32Smem, stream>>>(a, w, bias, res, out, m, kdim,
                                                              ncols, col_tiles, flags);
  return cudaGetLastError();
}

}  // namespace
