// A convolution's epilogue as one pass, in place, at inference, for Hopper
// (sm_90a): the bias, the FPN's 2x nearest top-down add and the ReLU.
//
// Replaces no Pallas kernel. It takes the place of what XLA fuses into the
// convolutions' epilogues in the JAX package (detectron_tpu/models/fpn.py,
// heads.py: the bias, the ReLU after the RPN's and the mask head's convs,
// and the FPN's lateral + upsampled coarser level), which eager PyTorch runs
// as separate passes: aten runs cuDNN without the bias and then
// output.add_(bias), a broadcast that takes the strided elementwise kernel
// on a channels-last tensor; F.relu is one more read and write; the FPN's
// F.interpolate writes the upsampled level, and the add reads it back.
//
// y = relu?(rnd(rnd(x + b) [+ c[h/2, w/2]])), written over x, with every op
// rounded to the tensor's dtype as the eager chain rounds it (rnd:
// __float2bfloat16_rn in bf16; in float32 the _rn intrinsics, so that no
// FMA contracts across a rounding): first x + b, then the coarse add, the
// ReLU last. relu(v) = v < 0 ? 0 : v (NaN passes, as clamp_min's does). The
// result is therefore bit for bit what the eager chain writes. The forms the
// models use: the bias alone (the FPN's smooth convs and its coarsest
// lateral, the RPN's 1x1 siblings, the mask logits), the bias and the ReLU
// (the RPN's 3x3 conv, the mask head's four convs and its deconv), the bias
// and the coarse add (the FPN's other laterals).
//
// What bounds it on the H100: bytes. A pass reads and writes x once (and in
// the coarse form reads c, a quarter of x): 2N elements against the eager
// chain's 4N for the bias (the strided add reads and writes x) plus 2N for a
// ReLU, and for the top-down add 5N more (the upsample reads N/4 and writes
// N; the add reads 2N and writes N). Design:
//   - in place: the pass writes the convolution's own output and allocates
//     nothing;
//   - 16-byte loads and stores a thread (8 bf16 or 4 float32 values), the
//     neighbouring threads of a warp on neighbouring vectors;
//   - the tensor is read as a matrix of rows whose channel is fixed along
//     one axis: channels-last [N*H*W, C/V] (a thread's column fixes its V
//     channels, so it holds their bias in registers while it walks the
//     rows), NCHW [N*C, H*W/V] (a row is one channel: one scalar bias);
//   - the coarse form walks the coarse level instead, and each thread
//     finishes the four fine vectors that read its coarse vector: in
//     channels-last the 2x2 fine pixels of a coarse pixel, in NCHW the two
//     fine rows under a coarse row's V values, each 2V fine values wide. A
//     coarse vector is read from device memory once;
//   - shapes whose C (channels-last), H*W or coarse W (NCHW) is not a
//     multiple of V, or whose pointers are not 16-byte aligned, take the
//     same kernel one element a vector;
//   - a grid of as many blocks as the card holds at once, striding over the
//     rows, each thread with several rows' loads in flight before it stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float t(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 t(float v) { return __float2bfloat16_rn(v); }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// A vector of the bias through the read-only data cache.
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

struct Shape {
  long long rows;  // plain: N*H*W (channels-last) or N*C (NCHW);
                   // coarse: N*Hc*Wc (channels-last) or N*C*Hc (NCHW)
  int cols;        // vectors a row
  int bx;          // columns a block covers side by side
  int channels;    // C
  int hc, wc;      // the coarse level's H and W (the coarse form)
};

// The vectors of x one (row, col) finishes. Plain: one. Coarse: the four
// fine vectors under the coarse vector (row, col), in the order (2i, first),
// (2i, second), (2i+1, first), (2i+1, second).
template <bool kCL, bool kCoarse, int V>
__device__ __forceinline__ void fine_vectors(const Shape& sh, long long row, int col,
                                             long long* at) {
  if constexpr (!kCoarse) {
    at[0] = row * sh.cols + col;
  } else {
    long long base, side, down;
    if constexpr (kCL) {
      const long long q = row / sh.wc;  // n*Hc + i: fine row 2q of the batch's rows
      const long long w = 2LL * sh.wc;
      base = (2 * q * w + 2 * (row - q * sh.wc)) * sh.cols + col;
      side = sh.cols;
      down = w * sh.cols;
    } else {
      down = 2LL * sh.cols;  // vectors a fine row: 2*Wc / V
      base = 2 * row * down + 2 * col;
      side = 1;
    }
    at[0] = base;
    at[1] = base + side;
    at[2] = base + down;
    at[3] = base + down + side;
  }
}

// The lane of the coarse vector that fine vector f's lane k reads.
template <bool kCL, int V>
__device__ __forceinline__ int coarse_lane(int f, int k) {
  if constexpr (kCL) {
    return k;  // the same channel
  } else {
    return (f % 2 ? V + k : k) / 2;  // fine w = 2j and 2j+1 read coarse j
  }
}

template <bool kCL, bool kCoarse>
__device__ __forceinline__ long long channel_of(const Shape& sh, long long row) {
  return (kCoarse ? row / sh.hc : row) % sh.channels;
}

template <typename T, bool kCL, bool kCoarse, bool kRelu, int V>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(T* __restrict__ x, const T* __restrict__ b,
                         const T* __restrict__ c, Shape sh) {
  using Vt = Vec<T, V>;
  using N = Num<T>;
  constexpr int kFine = kCoarse ? 4 : 1;
  constexpr int kUnroll = kCoarse ? 2 : 4;
  const int tx = threadIdx.x % sh.bx;
  const int by = blockDim.x / sh.bx;
  if (static_cast<int>(threadIdx.x) >= by * sh.bx) return;  // past the block's last full row
  const long long step = static_cast<long long>(gridDim.y) * by;
  for (int col = blockIdx.x * sh.bx + tx; col < sh.cols; col += gridDim.x * sh.bx) {
    Vt bv;
    if constexpr (kCL) bv = load_ro<T, V>(b + static_cast<long long>(col) * V);
    for (long long row0 = blockIdx.y * by + threadIdx.x / sh.bx; row0 < sh.rows;
         row0 += kUnroll * step) {
      Vt xv[kUnroll][kFine], cv[kUnroll];
      long long at[kUnroll][kFine];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = row0 + u * step;
        if (row < sh.rows) {
          fine_vectors<kCL, kCoarse, V>(sh, row, col, at[u]);
#pragma unroll
          for (int f = 0; f < kFine; ++f) xv[u][f] = reinterpret_cast<const Vt*>(x)[at[u][f]];
          if constexpr (kCoarse) cv[u] = reinterpret_cast<const Vt*>(c)[row * sh.cols + col];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = row0 + u * step;
        if (row >= sh.rows) break;
        if constexpr (!kCL) bv = splat_ro<T, V>(b + channel_of<kCL, kCoarse>(sh, row));
#pragma unroll
        for (int f = 0; f < kFine; ++f) {
          Vt out;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float z = N::f(N::t(__fadd_rn(N::f(xv[u][f].v[k]), N::f(bv.v[k]))));
            if constexpr (kCoarse) {
              z = N::f(N::t(__fadd_rn(z, N::f(cv[u].v[coarse_lane<kCL, V>(f, k)]))));
            }
            if constexpr (kRelu) z = z < 0.f ? 0.f : z;
            out.v[k] = N::t(z);
          }
          reinterpret_cast<Vt*>(x)[at[u][f]] = out;
        }
      }
    }
  }
}

struct Args {
  void* x;
  const void* b;
  const void* c;  // the coarse level, or null
  long long n;    // N
  int channels;   // C
  int h, w;       // x's H and W (the coarse level's are half)
  cudaStream_t stream;
};

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rows of x and vectors a row, or false if V does not divide a row.
template <bool kCL, bool kCoarse>
bool shape_of(const Args& a, int v, Shape* sh) {
  const long long hw = static_cast<long long>(a.h) * a.w;
  long long inner, rows;
  if constexpr (kCoarse) {
    sh->hc = a.h / 2;
    sh->wc = a.w / 2;
    inner = kCL ? a.channels : sh->wc;
    rows = kCL ? a.n * sh->hc * sh->wc : a.n * a.channels * sh->hc;
  } else {
    sh->hc = sh->wc = 0;
    inner = kCL ? a.channels : hw;
    rows = kCL ? a.n * hw : a.n * a.channels;
  }
  if (inner <= 0 || inner % v || inner / v > 0x7fffffffLL) return false;
  sh->cols = static_cast<int>(inner / v);
  sh->rows = rows;
  sh->channels = a.channels;
  sh->bx = sh->cols < kThreads ? sh->cols : kThreads;
  return true;
}

// A grid of blocks of kThreads threads (bx columns side by side, so that a
// warp reads one contiguous span), as many as the card holds at once.
// per_sm: the kernel instance's own cache of its blocks an SM, by device.
template <typename Kernel>
cudaError_t plan(Kernel kernel, int* per_sm, const Shape& sh, dim3* grid) {
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
  const int by = kThreads / sh.bx;
  const long long target = static_cast<long long>(per_sm[dev]) * sms[dev];
  const long long gx = (sh.cols + sh.bx - 1) / sh.bx < target ? (sh.cols + sh.bx - 1) / sh.bx
                                                              : target;
  long long gy = (sh.rows + by - 1) / by;
  const long long room = target / gx > 1 ? target / gx : 1;
  if (gy > room) gy = room;
  if (gy > 65535) gy = 65535;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return cudaSuccess;
}

template <typename T, bool kCL, bool kCoarse, bool kRelu, int V>
cudaError_t launch(const Args& a) {
  Shape sh;
  if (!shape_of<kCL, kCoarse>(a, V, &sh)) return cudaErrorInvalidValue;
  if (sh.rows == 0) return cudaSuccess;
  static int per_sm[kMaxDevices] = {};
  auto kernel = conv_epilogue_kernel<T, kCL, kCoarse, kRelu, V>;
  dim3 grid;
  cudaError_t err = plan(kernel, per_sm, sh, &grid);
  if (err != cudaSuccess) return err;
  const dim3 block(kThreads);
  kernel<<<grid, block, 0, a.stream>>>(static_cast<T*>(a.x), static_cast<const T*>(a.b),
                                       static_cast<const T*>(a.c), sh);
  return cudaGetLastError();
}

// The 16-byte instance where every pointer read as vectors is aligned and
// the vectors do not cross a row, else one element a vector.
template <typename T, bool kCL, bool kCoarse, bool kRelu>
cudaError_t pick_width(const Args& a) {
  constexpr int V = 16 / sizeof(T);
  const long long inner = kCL ? a.channels
                              : kCoarse ? a.w / 2 : static_cast<long long>(a.h) * a.w;
  const bool wide = aligned16(a.x) && aligned16(a.c) && (!kCL || aligned16(a.b)) &&
                    inner % V == 0;
  return wide ? launch<T, kCL, kCoarse, kRelu, V>(a) : launch<T, kCL, kCoarse, kRelu, 1>(a);
}

template <typename T>
cudaError_t dispatch(int channels_last, int relu, const Args& a) {
  const bool coarse = a.c != nullptr;
  if (coarse && (a.h % 2 || a.w % 2)) return cudaErrorInvalidValue;
  switch ((channels_last ? 4 : 0) + (coarse ? 2 : 0) + (relu ? 1 : 0)) {
    case 0: return pick_width<T, false, false, false>(a);
    case 1: return pick_width<T, false, false, true>(a);
    case 2: return pick_width<T, false, true, false>(a);
    case 3: return pick_width<T, false, true, true>(a);
    case 4: return pick_width<T, true, false, false>(a);
    case 5: return pick_width<T, true, false, true>(a);
    case 6: return pick_width<T, true, true, false>(a);
    default: return pick_width<T, true, true, true>(a);
  }
}

}  // namespace

// x = relu?(x + b [+ c at (h/2, w/2)]) in place, each op rounded as eager
// PyTorch rounds it. flags: bit 0 set for bfloat16 tensors (clear for
// float32), bit 1 if x and c are dense channels-last (clear if dense NCHW),
// bit 2 to end with the ReLU; one word, since the host pays for each
// argument it converts. x: [n, channels, h, w]; b: channels values; coarse:
// null, or [n, channels, h/2, w/2] in x's layout (h and w even). Returns the
// cudaError_t of the launch.
extern "C" int conv_epilogue(int flags, void* x, const void* b, const void* coarse, long long n,
                             int channels, int h, int w, void* stream) {
  const Args a{x, b, coarse, n, channels, h, w, static_cast<cudaStream_t>(stream)};
  const int channels_last = flags & 2, relu = flags & 4;
  return static_cast<int>(flags & 1 ? dispatch<__nv_bfloat16>(channels_last, relu, a)
                                    : dispatch<float>(channels_last, relu, a));
}
