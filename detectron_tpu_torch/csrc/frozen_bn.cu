// Frozen BatchNorm, its ReLU and the residual add as one pass, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It takes the place of the affine that XLA fuses
// into the convolutions' epilogues in the JAX package
// (detectron_tpu/models/resnet.py: FrozenBatchNorm's x * scale + bias, the
// ReLU, the bottleneck's residual add), which eager PyTorch runs as a chain
// of broadcast passes: a multiply, an add, the ReLU, and for the last norm of
// a bottleneck the residual add and its ReLU (and the downsample's own
// multiply and add), each a full read and write of the tensor.
//
// Three forms, each y = relu(z) with every op rounded to the tensor's dtype
// as eager PyTorch rounds it (rnd: __float2bfloat16_rn in bf16; in float32
// the _rn intrinsics, so that no FMA contracts across a rounding):
//   affine      z = rnd(rnd(x*s) + b)                  (stem, bn1, bn2)
//   identity    z = rnd(rnd(rnd(x*s) + b) + r)         (bn3, block input r)
//   downsample  z = rnd(rnd(rnd(x*s) + b) + rnd(rnd(d*sd) + bd))
//                                                      (bn3, raw downsample conv output d)
// relu(v) = v < 0 ? 0 : v (NaN passes, as clamp_min's does). The output is
// therefore bit for bit what the eager chain writes. The backward reads the
// incoming gradient g and the saved output y and writes, in one pass,
//   gx = rnd(gz * s), gz = (y <= 0 ? 0 : g)            (threshold_backward, then
//                                                      the multiply's grad * scale)
// and in the residual forms gr = gz (identity) or rnd(gz * sd) (downsample):
// again eager autograd's values exactly.
//
// What bounds it on the H100: bytes. Each element takes a handful of flops
// against 2 bytes (bf16) read or written per tensor touched: far below the
// card's 295 flops a byte. A pass moves 2N elements (affine: read x, write
// y) or 3N (residual forms: also r or d; backward: g, y and gx, plus gr);
// the eager chain moves 6N to 13N. Design:
//   - one pass per norm, nothing between the passes in device memory;
//   - 16-byte loads and stores a thread (8 bf16 or 4 float32 values), the
//     neighbouring threads of a warp on neighbouring vectors;
//   - the tensor is read as a matrix of rows whose channel is fixed along
//     one axis: channels-last [N*H*W, C/V] (a thread's column fixes its V
//     channels, so it reads its scales once, through the read-only cache,
//     before it walks the rows), NCHW [N*C, H*W/V] (a row is one channel:
//     one scalar scale a row). Shapes whose C (channels-last) or H*W (NCHW)
//     is not a multiple of V, or whose pointers are not 16-byte aligned,
//     take the same kernel one element a vector;
//   - a grid of as many blocks as the card holds at once, striding over the
//     rows, each thread with kUnroll rows' loads in flight before it stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

enum Form { kAffine = 0, kIdentity = 1, kDownsample = 2 };

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float t(float v) { return v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 t(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float rnd(float v) { return f(t(v)); }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// A vector of read-only values (the scales and biases) through the
// read-only data cache.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_ro(const T* p) {
  Vec<T, V> out;
  if constexpr (sizeof(out) == 16) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &w, 16);
  } else if constexpr (sizeof(out) == 4) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    memcpy(&out, &w, 4);
  } else {
    static_assert(sizeof(out) == 2, "a vector of 16, 4 or 2 bytes");
    const unsigned short w = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&out, &w, 2);
  }
  return out;
}

// One scalar, repeated over a vector: NCHW's channel of a row.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> splat_ro(const T* p) {
  const Vec<T, 1> one = load_ro<T, 1>(p);
  Vec<T, V> out;
#pragma unroll
  for (int k = 0; k < V; ++k) out.v[k] = one.v[0];
  return out;
}

// rnd(rnd(x*s) + b), as a float holding a value of T
template <typename T>
__device__ __forceinline__ float affine(T x, T s, T b) {
  using N = Num<T>;
  return N::rnd(__fadd_rn(N::rnd(__fmul_rn(N::f(x), N::f(s))), N::f(b)));
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

struct Shape {
  long long rows;  // channels-last: N*H*W; NCHW: N*C
  int cols;        // vectors a row
  int channels;    // C
};

// The affine parameters of one vector: channels-last, the thread's column
// (loaded once); NCHW, the row's channel. The backward reads no bias.
template <typename T, int V, bool kCL, int kForm, bool kBias>
struct Params {
  Vec<T, V> s, b, rs, rb;
  __device__ __forceinline__ void load(const T* s_, const T* b_, const T* rs_, const T* rb_,
                                       long long at) {
    constexpr bool kRes = kForm == kDownsample;
    if constexpr (kCL) {
      s = load_ro<T, V>(s_ + at);
      if constexpr (kBias) b = load_ro<T, V>(b_ + at);
      if constexpr (kRes) rs = load_ro<T, V>(rs_ + at);
      if constexpr (kRes && kBias) rb = load_ro<T, V>(rb_ + at);
    } else {
      s = splat_ro<T, V>(s_ + at);
      if constexpr (kBias) b = splat_ro<T, V>(b_ + at);
      if constexpr (kRes) rs = splat_ro<T, V>(rs_ + at);
      if constexpr (kRes && kBias) rb = splat_ro<T, V>(rb_ + at);
    }
  }
};

template <typename T, int kForm, bool kCL, int V>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                         const T* __restrict__ s, const T* __restrict__ b,
                         const T* __restrict__ rs, const T* __restrict__ rb,
                         T* __restrict__ y, Shape sh) {
  using Vt = Vec<T, V>;
  using N = Num<T>;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.y;
  for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < sh.cols;
       col += gridDim.x * blockDim.x) {
    Params<T, V, kCL, kForm, true> p;
    if constexpr (kCL) p.load(s, b, rs, rb, static_cast<long long>(col) * V);
    for (long long row0 = blockIdx.y * blockDim.y + threadIdx.y; row0 < sh.rows;
         row0 += kUnroll * step) {
      Vt xv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = row0 + u * step;
        if (row < sh.rows) {
          const long long i = row * sh.cols + col;
          xv[u] = reinterpret_cast<const Vt*>(x)[i];
          if constexpr (kForm != kAffine) rv[u] = reinterpret_cast<const Vt*>(r)[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = row0 + u * step;
        if (row >= sh.rows) break;
        if constexpr (!kCL) p.load(s, b, rs, rb, row % sh.channels);
        Vt out;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float z = affine<T>(xv[u].v[k], p.s.v[k], p.b.v[k]);
          if constexpr (kForm == kIdentity) {
            z = N::rnd(__fadd_rn(z, N::f(rv[u].v[k])));
          } else if constexpr (kForm == kDownsample) {
            z = N::rnd(__fadd_rn(z, affine<T>(rv[u].v[k], p.rs.v[k], p.rb.v[k])));
          }
          out.v[k] = N::t(relu(z));
        }
        reinterpret_cast<Vt*>(y)[row * sh.cols + col] = out;
      }
    }
  }
}

template <typename T, int kForm, bool kCL, int V>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                         const T* __restrict__ s, const T* __restrict__ rs,
                         T* __restrict__ gx, T* __restrict__ gr, Shape sh) {
  using Vt = Vec<T, V>;
  using N = Num<T>;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.y;
  for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < sh.cols;
       col += gridDim.x * blockDim.x) {
    Params<T, V, kCL, kForm, false> p;
    if constexpr (kCL) p.load(s, nullptr, rs, nullptr, static_cast<long long>(col) * V);
    for (long long row0 = blockIdx.y * blockDim.y + threadIdx.y; row0 < sh.rows;
         row0 += kUnroll * step) {
      Vt gv[kUnroll], yv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = row0 + u * step;
        if (row < sh.rows) {
          const long long i = row * sh.cols + col;
          gv[u] = reinterpret_cast<const Vt*>(g)[i];
          yv[u] = reinterpret_cast<const Vt*>(y)[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = row0 + u * step;
        if (row >= sh.rows) break;
        if constexpr (!kCL) p.load(s, nullptr, rs, nullptr, row % sh.channels);
        Vt ox, orr;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float gz = N::f(yv[u].v[k]) <= 0.f ? 0.f : N::f(gv[u].v[k]);
          ox.v[k] = N::t(__fmul_rn(gz, N::f(p.s.v[k])));
          if constexpr (kForm == kIdentity) {
            orr.v[k] = N::t(gz);
          } else if constexpr (kForm == kDownsample) {
            orr.v[k] = N::t(__fmul_rn(gz, N::f(p.rs.v[k])));
          }
        }
        const long long i = row * sh.cols + col;
        reinterpret_cast<Vt*>(gx)[i] = ox;
        if constexpr (kForm != kAffine) reinterpret_cast<Vt*>(gr)[i] = orr;
      }
    }
  }
}

struct Args {
  const void* in;   // forward: x; backward: g
  const void* in2;  // forward: the residual r or d; backward: y
  const void* s;
  const void* b;    // forward only
  const void* rs;
  const void* rb;   // forward only
  void* out;        // forward: y; backward: gx
  void* out2;       // backward: gr
  long long n;      // elements
  int channels;
  long long hw;
  cudaStream_t stream;
};

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks of bx x by threads (bx columns side by side, so that a warp reads
// one contiguous span), as many as the card holds at once. per_sm: the
// kernel instance's own cache of its blocks an SM, by device.
template <typename Kernel>
cudaError_t plan(Kernel kernel, int* per_sm, const Shape& sh, dim3* grid, dim3* block) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm[dev] = blocks > 0 ? blocks : 1;
  }
  const int bx = sh.cols < kThreads ? sh.cols : kThreads;
  const int by = kThreads / bx;
  const long long target = static_cast<long long>(per_sm[dev]) * sms[dev];
  const long long gx = (sh.cols + bx - 1) / bx < target ? (sh.cols + bx - 1) / bx : target;
  long long gy = (sh.rows + by - 1) / by;
  const long long room = target / gx > 1 ? target / gx : 1;
  if (gy > room) gy = room;
  if (gy > 65535) gy = 65535;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  *block = dim3(bx, by);
  return cudaSuccess;
}

template <bool kCL>
bool shape_of(const Args& a, int v, Shape* sh) {
  const long long inner = kCL ? a.channels : a.hw;
  if (inner <= 0 || inner % v || a.n % inner || inner / v > 0x7fffffffLL) return false;
  sh->cols = static_cast<int>(inner / v);
  sh->rows = a.n / inner;
  sh->channels = a.channels;
  return true;
}

template <typename T, int kForm, bool kCL, int V>
cudaError_t launch_fwd(const Args& a) {
  Shape sh;
  if (!shape_of<kCL>(a, V, &sh)) return cudaErrorInvalidValue;
  dim3 grid, block;
  static int per_sm[kMaxDevices] = {};
  auto kernel = frozen_bn_fwd_kernel<T, kForm, kCL, V>;
  cudaError_t err = plan(kernel, per_sm, sh, &grid, &block);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<const T*>(a.in2), static_cast<const T*>(a.s),
      static_cast<const T*>(a.b), static_cast<const T*>(a.rs), static_cast<const T*>(a.rb),
      static_cast<T*>(a.out), sh);
  return cudaGetLastError();
}

template <typename T, int kForm, bool kCL, int V>
cudaError_t launch_bwd(const Args& a) {
  Shape sh;
  if (!shape_of<kCL>(a, V, &sh)) return cudaErrorInvalidValue;
  dim3 grid, block;
  static int per_sm[kMaxDevices] = {};
  auto kernel = frozen_bn_bwd_kernel<T, kForm, kCL, V>;
  cudaError_t err = plan(kernel, per_sm, sh, &grid, &block);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<const T*>(a.in2), static_cast<const T*>(a.s),
      static_cast<const T*>(a.rs), static_cast<T*>(a.out), static_cast<T*>(a.out2), sh);
  return cudaGetLastError();
}

// The 16-byte instance where every pointer it reads as vectors is aligned
// and the vectors do not cross a row, else one element a vector.
template <typename T, int kForm, bool kCL, bool kForward>
cudaError_t pick_width(const Args& a) {
  constexpr int V = 16 / sizeof(T);
  bool wide = aligned16(a.in) && aligned16(a.in2) && aligned16(a.out) && aligned16(a.out2) &&
              (kCL ? a.channels % V == 0 : a.hw % V == 0);
  if (kCL) wide = wide && aligned16(a.s) && aligned16(a.b) && aligned16(a.rs) && aligned16(a.rb);
  if constexpr (kForward) {
    return wide ? launch_fwd<T, kForm, kCL, V>(a) : launch_fwd<T, kForm, kCL, 1>(a);
  } else {
    return wide ? launch_bwd<T, kForm, kCL, V>(a) : launch_bwd<T, kForm, kCL, 1>(a);
  }
}

template <typename T, bool kForward>
cudaError_t dispatch(int form, int channels_last, const Args& a) {
  if (a.n == 0) return cudaSuccess;
  switch (form * 2 + (channels_last ? 1 : 0)) {
    case 0: return pick_width<T, kAffine, false, kForward>(a);
    case 1: return pick_width<T, kAffine, true, kForward>(a);
    case 2: return pick_width<T, kIdentity, false, kForward>(a);
    case 3: return pick_width<T, kIdentity, true, kForward>(a);
    case 4: return pick_width<T, kDownsample, false, kForward>(a);
    case 5: return pick_width<T, kDownsample, true, kForward>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kForward>
int run(int bf16, int form, int channels_last, const Args& a) {
  return static_cast<int>(bf16 ? dispatch<__nv_bfloat16, kForward>(form, channels_last, a)
                               : dispatch<float, kForward>(form, channels_last, a));
}

}  // namespace

// y = relu(x*s + b [+ r | + (d*sd + bd)]), each op rounded as eager PyTorch
// rounds it. bf16: 1 for bfloat16 tensors, 0 for float32; form: 0 affine, 1
// identity residual (res = r), 2 downsample residual (res = d, with rs, rb);
// channels_last: 1 if x, res and y are dense channels-last, 0 if dense NCHW.
// x, res, y: n elements of [N, C, H, W]; s, b, rs, rb: C values each; hw =
// H*W. Returns the cudaError_t of the launch.
extern "C" int frozen_bn_forward(int bf16, int form, int channels_last, const void* x,
                                 const void* res, const void* s, const void* b, const void* rs,
                                 const void* rb, void* y, long long n, int channels,
                                 long long hw, void* stream) {
  const Args a{x, res, s, b, rs, rb, y, nullptr, n, channels, hw,
               static_cast<cudaStream_t>(stream)};
  return run<true>(bf16, form, channels_last, a);
}

// The gradients of frozen_bn_forward from the incoming gradient g and its
// output y: gx = rnd((y <= 0 ? 0 : g) * s); form 1 also gr = (y <= 0 ? 0 :
// g), form 2 gr = rnd((y <= 0 ? 0 : g) * rs). g, y, gx, gr in one layout.
extern "C" int frozen_bn_backward(int bf16, int form, int channels_last, const void* g,
                                  const void* y, const void* s, const void* rs, void* gx,
                                  void* gr, long long n, int channels, long long hw,
                                  void* stream) {
  const Args a{g, y, s, nullptr, rs, nullptr, gx, gr, n, channels, hw,
               static_cast<cudaStream_t>(stream)};
  return run<false>(bf16, form, channels_last, a);
}
