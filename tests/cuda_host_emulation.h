// The few CUDA pieces that csrc/frozen_bn.cu uses, on the host, so that g++
// can build the kernel and run it on the CPU (tests/test_torch_frozen_bn.py).
// A launch runs every thread of every block in turn; bf16 is a 16-bit word
// rounded to nearest even, as __float2bfloat16_rn rounds; the _rn float ops
// go through volatile stores so that no FMA contracts them. The device
// queries report a small card (3 SMs, 2 blocks each), so the grid strides.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
typedef void* cudaStream_t;
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 3; return cudaSuccess; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, int) {
  *blocks = 2;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

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
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}

struct uint4 {
  unsigned x, y, z, w;
};
template <class T>
T __ldg(const T* p) {
  return *p;
}

template <class K, class... A>
void emulate_launch(K kernel, dim3 grid, dim3 block, A... args) {
  gridDim = grid;
  blockDim = block;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (unsigned ty = 0; ty < block.y; ++ty)
        for (unsigned tx = 0; tx < block.x; ++tx) {
          blockIdx = dim3(bx, by);
          threadIdx = dim3(tx, ty);
          kernel(args...);
        }
}
