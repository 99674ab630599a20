// Host emulation of the CUDA surface that the f32 path of
// grafp_tpu_torch/csrc/mrconv_select.cuh uses, for
// tests/test_torch_port_select_emulated.py: every thread of a block is a
// std::thread, __syncthreads a std::barrier over the block, a warp shuffle
// an exchange through per-thread slots between two barriers of the warp,
// atomics the compiler's builtins. Blocks run one after another. The bf16
// path's PTX (cp.async, ldmatrix, mma.sync) has no host counterpart and is
// never instantiated here.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3_ { unsigned x, y, z; };
inline thread_local dim3_ threadIdx, blockIdx;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

struct __nv_bfloat16 { unsigned short x; };
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.x; }
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
inline float __uint_as_float(unsigned i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

struct Block {
  std::barrier<> bar;
  std::unique_ptr<std::barrier<>> warp[8];
  std::vector<unsigned char> smem;
  std::atomic<int> vote{0};
  uint64_t slots[256];
  Block(int threads, size_t bytes) : bar(threads), smem(bytes + 16) {
    for (int w = 0; w < threads / 32; ++w) warp[w] = std::make_unique<std::barrier<>>(32);
  }
};
inline thread_local Block* g_block;

inline void __syncthreads() { g_block->bar.arrive_and_wait(); }

inline int __syncthreads_or(int p) {
  g_block->bar.arrive_and_wait();
  if (p) g_block->vote.fetch_or(1);
  g_block->bar.arrive_and_wait();
  const int r = g_block->vote.load();
  g_block->bar.arrive_and_wait();
  if (threadIdx.x == 0) g_block->vote.store(0);
  return r;
}

template <class T>
T __shfl_xor_sync(unsigned, T v, int off) {
  const int t = threadIdx.x;
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  g_block->slots[t] = u;
  g_block->warp[t / 32]->arrive_and_wait();
  const uint64_t o = g_block->slots[(t & ~31) | ((t & 31) ^ off)];
  g_block->warp[t / 32]->arrive_and_wait();
  T r;
  memcpy(&r, &o, sizeof(T));
  return r;
}

inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}

inline int atomicMax(int* p, int v) {
  int cur = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (cur < v &&
         !__atomic_compare_exchange_n(p, &cur, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return cur;
}

// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// emu_launch(grid, threads, smem, stream, kernel, args...)
template <class K, class... A>
void emu_launch(unsigned grid, int threads, size_t smem, cudaStream_t, K kernel, A... args) {
  for (unsigned bx = 0; bx < grid; ++bx) {
    Block block(threads, smem);
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {bx, 0, 0};
        g_block = &block;
        kernel(args...);
        block.warp[t / 32]->arrive_and_drop();
        block.bar.arrive_and_drop();
      });
    for (auto& th : team) th.join();
  }
}
