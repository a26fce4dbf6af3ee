// The CUDA pieces that csrc/anchor_match.cu and csrc/conv_epilogue.cu use, on
// the host, so that g++ can build the kernels and run them on the CPU
// (tests/test_torch_anchor_match.py, tests/test_torch_conv_epilogue.py).
// Unlike cuda_host_emulation.h, whose kernels never talk across threads,
// a launch here runs each block's threads as real threads at once: shared
// memory is a static local (one block runs at a time), __syncthreads is a
// barrier over the block, and the warp collectives (__ballot_sync,
// __reduce_max_sync) a barrier over the warp's 32 threads and a scratch row.
// Atomics are the compiler's; the _rn float ops go through volatile stores
// so that no FMA contracts them; bf16 is a 16-bit word rounded to nearest
// even, as __float2bfloat16_rn rounds. The device queries report a small card
// (3 SMs, 2 blocks each), so that a grid sized to the card strides. Blocks
// are one-dimensional, a multiple of 32 threads.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 blockIdx, threadIdx;
static dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 3;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, int) {
  *blocks = 2;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  if (n) memset(p, v, n);
  return cudaSuccess;
}

namespace emu {
constexpr int kMaxWarps = 32;
static std::barrier<>* block_barrier;
static std::barrier<>* warp_barrier[kMaxWarps];
static int warp_row[kMaxWarps][32];

// Every lane of the calling warp hands in v; each gets the row of all 32.
inline const int* exchange(int v) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_row[w][lane] = v;
  warp_barrier[w]->arrive_and_wait();
  return warp_row[w];
}

inline void done_reading() { warp_barrier[threadIdx.x / 32]->arrive_and_wait(); }
}  // namespace emu

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

inline unsigned __ballot_sync(unsigned, int pred) {
  const int* row = emu::exchange(pred ? 1 : 0);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= static_cast<unsigned>(row[l] != 0) << l;
  emu::done_reading();
  return r;
}

inline int __reduce_max_sync(unsigned, int v) {
  const int* row = emu::exchange(v);
  int r = row[0];
  for (int l = 1; l < 32; ++l) r = row[l] > r ? row[l] : r;
  emu::done_reading();
  return r;
}

inline int __popc(unsigned v) { return __builtin_popcount(v); }

inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}

inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
template <class T>
T __ldg(const T* p) {
  return *p;
}

struct uint4 {
  unsigned x, y, z, w;
};
struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(v.x) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if (std::isnan(f)) return {0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return {static_cast<uint16_t>(u >> 16)};
}

template <class K, class... A>
void emulate_launch(K kernel, dim3 grid, dim3 block, A... args) {
  gridDim = grid;
  blockDim = block;
  const unsigned threads = block.x;
  const unsigned warps = threads / 32;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(threads);
      std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
      emu::block_barrier = &bar;
      for (unsigned w = 0; w < warps; ++w) {
        warp_bars.push_back(std::make_unique<std::barrier<>>(32));
        emu::warp_barrier[w] = warp_bars.back().get();
      }
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([=] {
          blockIdx = dim3(bx, by);
          threadIdx = dim3(t);
          kernel(args...);
        });
      for (auto& th : pool) th.join();
    }
}
