// Multilevel RoIAlign over an FPN, forward (K2) and backward (K3), for
// Hopper (sm_90a).
//
// K2, roi_align_forward, replaces the Pallas TPU kernel
// detectron_tpu/ops/roi_align_pallas.py::multilevel_roi_align_pallas
// (_make_kernel, _interp_matrix): per-level NHWC features [B, Hl, Wl, C]
// and RoIs [B, R, 4] (image coordinates) give [B, R, P, P, C]. aligned=False,
// RoI extent at least one cell, S x S bilinear samples per bin averaged,
// and the Caffe2 border rule: a sample outside [-1, size] contributes 0,
// otherwise it is clamped to [0, size - 1]. The level of every RoI is
// computed by the caller (the port's assign_fpn_levels), so this kernel
// and its plain PyTorch version route identically by construction.
//
// K3, roi_align_backward, replaces the Pallas TPU kernel
// detectron_tpu/ops/roi_align_pallas.py::multilevel_roi_align_pallas_bwd
// (_make_bwd_kernel, _bwd_windows, _precompute_dwin): the gradient of K2
// with respect to each level, given the upstream gradient g [B, R, P, P, C]
// and the routing the forward used, added into zero-filled fp32
// [B, Hl, Wl, C] buffers (the caller's fill). The RoIs get no gradient.
//
// What bounds them on the H100: memory, not arithmetic. K2 must read the
// feature cells its samples touch and write its output. K3 must read g and
// write every level's gradient once (the zero fill, 234 MB for 2 images of
// 1024x1344 at C=256, is most of it); its arithmetic is a few fp32
// operations a sample.
//
// K2 design. The TPU kernel DMA'd a window per RoI into VMEM and
// interpolated it with two matmuls on the MXU. Here one block takes one
// (RoI, output row), threads across channels, straight on the channels-last
// level, so every corner read is one coalesced 4*C-byte row segment; cells
// shared by neighbouring samples come from L1/L2.
//
// K3 design. What the TPU kernel kept out of device memory was the traffic
// of the samples: it built each RoI's window gradient on chip (Wy^T g Wx)
// and added the window into the level once. Adding every sample's four
// corners into device memory with scalar fp32 atomics instead costs
// 4 S^2 P^2 L2 atomics a RoI and channel, mostly onto the same few cells,
// and those, not the bytes, would be the time. So one block takes one
// (RoI, slice of `slice` channels):
//   1. warp 0 computes the RoI's P*S x samples and warp 1 its P*S y samples,
//      with the same arithmetic as K2 (sample_coord, bilinear), so K3 stays
//      K2's exact transpose; each warp folds its axis onto the sorted
//      distinct cells that its nonzero taps touch (at most 2*P*S: samples
//      are monotone and each has two taps; a RoI wider than P*S cells gives
//      sparse cells, a sub-cell RoI one or two), with ballots and a binary-
//      search merge, so shared memory is sized by P and S, never by the
//      RoI's extent. Meanwhile the other six warps stage g / S^2 of the
//      RoI's slice in shared memory, so the fold hides under that load;
//   2. pass 1 contracts x: t[p, xcell, c] = sum over the x taps on xcell of
//      wx * g[p, q, c]; pass 2 contracts y: d[ycell, xcell, c] = sum over
//      the y taps on ycell of wy * t[p, xcell, c]. Each thread owns whole
//      outputs and sums its taps in a fixed order, so there are no
//      shared-memory atomics and a RoI's own sum is deterministic. The
//      passes' index arithmetic divides nothing at run time (the slice
//      width is a template parameter, slots are split by a multiply, each
//      tap stores its output bin): with a few taps a cell, integer
//      division would otherwise be most of the block's instructions;
//   3. each touched cell gets one 16-byte atomicAdd (red.global.add.v4.f32)
//      per 4 channels: a mask RoI of ~14 cells on its level issues ~15x15
//      of them per 4 channels instead of 3136 scalar adds per channel.
// Only the adds of different RoIs onto the same cell remain unordered, so
// K3 is not bitwise deterministic across RoIs: the last bits of a cell that
// overlapping RoIs touch may differ between two runs. Sums are fp32.
// `slice` is the widest of 32, 16, 8, 4 channels whose shared memory lets
// two blocks share an SM (32 at P=7, 16 at P=14 with S=2).

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // P * S along one axis
constexpr int kMaxTaps = 2 * kMaxSamples;
constexpr int kMaxDevices = 64;
constexpr int kBwdThreads = 256;
constexpr int kBwdSmemLimit = 100 * 1024;  // dynamic bytes a K3 block: two fit on an SM

template <typename T>
struct Levels {
  T* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
};

// Sample indices and bilinear weights of one K2 block: the x samples of
// every output column and the y samples of the block's output row.
struct SampleTable {
  int x0[kMaxSamples], x1[kMaxSamples];
  float wx0[kMaxSamples], wx1[kMaxSamples];
  int y0[kMaxSamples], y1[kMaxSamples];
  float wy0[kMaxSamples], wy1[kMaxSamples];
};

// _bilinear_1d of the JAX package, with the border rule folded into the
// weights (an out-of-range sample gets weight 0 on both taps).
__device__ __forceinline__ void bilinear(float coord, int size, int* i0,
                                         int* i1, float* w0, float* w1) {
  const float limit = static_cast<float>(size);
  const bool inb = coord >= -1.0f && coord <= limit;
  const float c = fminf(fmaxf(coord, 0.0f), limit - 1.0f);
  const int hi = size - 1;
  int lo = min(max(static_cast<int>(floorf(c)), 0), hi);
  *i0 = lo;
  *i1 = min(lo + 1, hi);
  const float frac = __fsub_rn(c, static_cast<float>(lo));
  *w0 = inb ? __fsub_rn(1.0f, frac) : 0.0f;
  *w1 = inb ? frac : 0.0f;
}

// A RoI on its level: the corner in cells and the bin size, in cells.
struct RoiFrame {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoiFrame roi_frame(const float4 roi, float stride, int pool) {
  // Sample coordinates reach hundreds of cells, where one rounding step is
  // ~3e-5 of a cell; a fused multiply-add here would move the bilinear
  // weights by that much against the plain version. So every step is
  // rounded as the JAX and PyTorch versions round it (_rn intrinsics are
  // never contracted).
  const float scale = __fdiv_rn(1.0f, stride);
  RoiFrame f;
  f.x1 = __fmul_rn(roi.x, scale);
  f.y1 = __fmul_rn(roi.y, scale);
  f.bin_w = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.z, scale), f.x1), 1.0f),
                      static_cast<float>(pool));
  f.bin_h = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.w, scale), f.y1), 1.0f),
                      static_cast<float>(pool));
  return f;
}

// Coordinate of sample k of pool * ratio along one axis: bin k / ratio, at
// (k % ratio + 0.5) / ratio of the bin.
__device__ __forceinline__ float sample_coord(float lo, float bin, int k, int ratio) {
  const float pos = static_cast<float>(k / ratio) + (k % ratio + 0.5f) / ratio;
  return __fadd_rn(lo, __fmul_rn(pos, bin));
}

// Fills `st` for RoI `roi` on a level of the given size and stride, output
// row p. Threads [0, pool*ratio) take the x samples, the next `ratio`
// threads the y samples; the caller synchronises.
__device__ __forceinline__ void fill_samples(SampleTable& st, const float4 roi,
                                             float stride, int height, int width,
                                             int pool, int ratio, int p) {
  const RoiFrame f = roi_frame(roi, stride, pool);
  const int t = threadIdx.x;
  if (t < pool * ratio) {  // x samples of every output column
    bilinear(sample_coord(f.x1, f.bin_w, t, ratio), width, &st.x0[t], &st.x1[t],
             &st.wx0[t], &st.wx1[t]);
  } else if (t < pool * ratio + ratio) {  // y samples of output row p
    const int j = t - pool * ratio;
    bilinear(sample_coord(f.y1, f.bin_h, p * ratio + j, ratio), height, &st.y0[j],
             &st.y1[j], &st.wy0[j], &st.wy1[j]);
  }
}

__global__ void roi_align_forward_kernel(Levels<const float> lv,
                                         const float4* __restrict__ rois,
                                         const int* __restrict__ levels,
                                         float* __restrict__ out, int rois_per_image,
                                         int channels, int pool, int ratio) {
  __shared__ SampleTable st;
  const int n = blockIdx.x / pool;  // RoI, over the whole batch
  const int p = blockIdx.x % pool;  // output row
  const int b = n / rois_per_image;
  const int l = levels[n];
  const int height = lv.h[l];
  const int width = lv.w[l];
  fill_samples(st, rois[n], lv.stride[l], height, width, pool, ratio, p);
  __syncthreads();

  const float* feat = lv.ptr[l] + static_cast<size_t>(b) * height * width * channels;
  float* dst = out + (static_cast<size_t>(n) * pool + p) * pool * channels;
  const float count = static_cast<float>(ratio * ratio);
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    const float* fc = feat + c;
    for (int q = 0; q < pool; ++q) {
      float acc = 0.0f;
      for (int sy = 0; sy < ratio; ++sy) {
        const float* row0 = fc + static_cast<size_t>(st.y0[sy]) * width * channels;
        const float* row1 = fc + static_cast<size_t>(st.y1[sy]) * width * channels;
        const float wy0 = st.wy0[sy], wy1 = st.wy1[sy];
        for (int sx = 0; sx < ratio; ++sx) {
          const int k = q * ratio + sx;
          const int xa = st.x0[k] * channels, xb = st.x1[k] * channels;
          const float wx0 = st.wx0[k], wx1 = st.wx1[k];
          acc += __ldg(row0 + xa) * (wy0 * wx0) + __ldg(row0 + xb) * (wy0 * wx1) +
                 __ldg(row1 + xa) * (wy1 * wx0) + __ldg(row1 + xb) * (wy1 * wx1);
        }
      }
      dst[q * channels + c] = acc / count;
    }
  }
}

// One axis of a K3 block's RoI, folded onto the distinct cells its nonzero
// taps touch: cell[s] for slot s < count, ascending, and the taps of slot s,
// entries [start[s], start[s + 1]) of (output bin of the tap's sample,
// weight): the i0 taps in sample order, then the i1 taps.
struct AxisTaps {
  int count;
  int cell[kMaxTaps];
  int start[kMaxTaps + 1];
  int bin[kMaxTaps];
  float weight[kMaxTaps];
};

// Working space of one axis's fold: the nonzero i0 taps (cell, sample) and
// i1 taps, compacted, and the merged cells.
struct FoldScratch {
  int cell0[kMaxSamples], sample0[kMaxSamples];
  int cell1[kMaxSamples], sample1[kMaxSamples];
  int merged[kMaxTaps];
};

// The samples of a K3 block's RoI, per axis (0: x, 1: y), and their folds.
struct BwdTable {
  int i0[2][kMaxSamples], i1[2][kMaxSamples];
  float w0[2][kMaxSamples], w1[2][kMaxSamples];
  AxisTaps axis[2];
  FoldScratch scratch[2];
};

// Folds axis `a` with one warp. i0 and i1 are each non-decreasing in the
// sample index (sample coordinates are), so the nonzero taps of each form a
// sorted list; the two lists are merged by binary search (a tap's place is
// its index plus the taps of the other list before it, i0 first on a tie),
// and a slot starts wherever the merged cell changes.
__device__ void fold_axis(BwdTable& tab, int a, int samples, int ratio, int lane) {
  const unsigned full = 0xffffffffu;
  const unsigned before = (1u << lane) - 1;
  AxisTaps& ax = tab.axis[a];
  FoldScratch& fs = tab.scratch[a];
  int n0 = 0, n1 = 0;
  for (int base = 0; base < samples; base += 32) {
    const int k = base + lane;
    const bool nz0 = k < samples && tab.w0[a][k] != 0.0f;
    const bool nz1 = k < samples && tab.w1[a][k] != 0.0f;
    const unsigned m0 = __ballot_sync(full, nz0);
    const unsigned m1 = __ballot_sync(full, nz1);
    if (nz0) {
      const int u = n0 + __popc(m0 & before);
      fs.cell0[u] = tab.i0[a][k];
      fs.sample0[u] = k;
    }
    if (nz1) {
      const int u = n1 + __popc(m1 & before);
      fs.cell1[u] = tab.i1[a][k];
      fs.sample1[u] = k;
    }
    n0 += __popc(m0);
    n1 += __popc(m1);
  }
  __syncwarp();
  for (int u = lane; u < n0; u += 32) {
    const int cell = fs.cell0[u];
    int lo = 0, hi = n1;  // i1 taps on smaller cells
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (fs.cell1[mid] < cell) lo = mid + 1; else hi = mid;
    }
    fs.merged[u + lo] = cell;
    ax.bin[u + lo] = fs.sample0[u] / ratio;
    ax.weight[u + lo] = tab.w0[a][fs.sample0[u]];
  }
  for (int u = lane; u < n1; u += 32) {
    const int cell = fs.cell1[u];
    int lo = 0, hi = n0;  // i0 taps on smaller or equal cells
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (fs.cell0[mid] <= cell) lo = mid + 1; else hi = mid;
    }
    fs.merged[u + lo] = cell;
    ax.bin[u + lo] = fs.sample1[u] / ratio;
    ax.weight[u + lo] = tab.w1[a][fs.sample1[u]];
  }
  __syncwarp();
  const int total = n0 + n1;
  int count = 0;
  for (int base = 0; base < total; base += 32) {
    const int q = base + lane;
    const bool first = q < total && (q == 0 || fs.merged[q] != fs.merged[q - 1]);
    const unsigned m = __ballot_sync(full, first);
    if (first) {
      const int slot = count + __popc(m & before);
      ax.cell[slot] = fs.merged[q];
      ax.start[slot] = q;
    }
    count += __popc(m);
  }
  if (lane == 0) {
    ax.start[count] = total;
    ax.count = count;
  }
}

__device__ __forceinline__ void fma4(float4& acc, const float4 v, float w) {
  acc.x += v.x * w;
  acc.y += v.y * w;
  acc.z += v.z * w;
  acc.w += v.w * w;
}

// Dynamic shared memory of one K3 block: g of the RoI's slice [P*P, slice]
// and the x-contracted t [P, 2*P*S, slice], fp32.
int bwd_smem_bytes(int pool, int ratio, int slice) {
  return (pool * pool + pool * 2 * pool * ratio) * slice * static_cast<int>(sizeof(float));
}

// q / d for q < 2^16 and 1 <= d <= 128, with `magic` = ceil(2^32 / d): one
// multiply instead of an integer division in the passes' index arithmetic.
__device__ __forceinline__ int div_small(int q, unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(q) * magic) >> 32);
}

template <int kSlice>
__global__ void __launch_bounds__(kBwdThreads)
    roi_align_backward_kernel(Levels<float> lv, const float4* __restrict__ rois,
                              const int* __restrict__ levels,
                              const float* __restrict__ grad_out, int rois_per_image,
                              int channels, int pool, int ratio) {
  constexpr int kV4 = kSlice / 4;               // float4 groups of the slice
  constexpr int kCells = kBwdThreads / kV4;     // cells one sweep of the block covers
  extern __shared__ __align__(16) float bwd_smem[];
  __shared__ BwdTable tab;
  const int slices = channels / kSlice;
  const int n = blockIdx.x / slices;  // RoI, over the whole batch
  const int c0 = (blockIdx.x % slices) * kSlice;
  const int b = n / rois_per_image;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int l = levels[n];
  float4 roi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (warp < 2) roi = rois[n];
  const int height = lv.h[l];
  const int width = lv.w[l];
  const int samples = pool * ratio;
  const int span = 2 * samples;  // slots of t along x

  // 1. warps 0 and 1: the RoI's x and y samples, as K2 computes them, each
  //    folded onto its distinct cells; the other warps meanwhile stage
  //    g / S^2 of the RoI's channel slice
  float4* gs = reinterpret_cast<float4*>(bwd_smem);  // [P*P][kV4]
  float4* tx = gs + pool * pool * kV4;               // [P][span][kV4]
  if (warp < 2) {
    const RoiFrame f = roi_frame(roi, lv.stride[l], pool);
    for (int k = lane; k < samples; k += 32) {
      bilinear(sample_coord(warp ? f.y1 : f.x1, warp ? f.bin_h : f.bin_w, k, ratio),
               warp ? height : width, &tab.i0[warp][k], &tab.i1[warp][k], &tab.w0[warp][k],
               &tab.w1[warp][k]);
    }
    __syncwarp();
    fold_axis(tab, warp, samples, ratio, lane);
  } else {
    const float count = static_cast<float>(ratio * ratio);
    const float* src = grad_out + static_cast<size_t>(n) * pool * pool * channels + c0;
    for (int e = t - 64; e < pool * pool * kV4; e += kBwdThreads - 64) {
      const int pq = e / kV4, c4 = e % kV4;
      float4 v = __ldg(
          reinterpret_cast<const float4*>(src + static_cast<size_t>(pq) * channels) + c4);
      v.x = v.x / count;
      v.y = v.y / count;
      v.z = v.z / count;
      v.w = v.w / count;
      gs[e] = v;
    }
  }
  __syncthreads();
  const AxisTaps& ax = tab.axis[0];
  const AxisTaps& ay = tab.axis[1];
  const int nx = ax.count, ny = ay.count;
  if (nx == 0 || ny == 0) return;  // every sample outside the level (block-uniform)
  const unsigned long long by_nx = ((1ull << 32) + nx - 1) / nx;
  const int c4 = t % kV4;

  // 2. pass 1, x: t[p, s, c] = sum over the taps of x slot s of w * g[p, q, c]
  for (int q = t / kV4; q < pool * nx; q += kCells) {
    const int p = div_small(q, by_nx);
    const int s = q - p * nx;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = ax.start[s]; k < ax.start[s + 1]; ++k) {
      fma4(acc, gs[(p * pool + ax.bin[k]) * kV4 + c4], ax.weight[k]);
    }
    tx[(p * span + s) * kV4 + c4] = acc;
  }
  __syncthreads();

  // 3. pass 2, y, and one 16-byte add per touched cell and 4 channels
  float* grad = lv.ptr[l] + static_cast<size_t>(b) * height * width * channels + c0;
  for (int q = t / kV4; q < ny * nx; q += kCells) {
    const int r = div_small(q, by_nx);
    const int s = q - r * nx;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = ay.start[r]; k < ay.start[r + 1]; ++k) {
      fma4(acc, tx[(ay.bin[k] * span + s) * kV4 + c4], ay.weight[k]);
    }
    float* cell = grad + (static_cast<size_t>(ay.cell[r]) * width + ax.cell[s]) * channels;
    atomicAdd(reinterpret_cast<float4*>(cell) + c4, acc);
  }
}

template <typename T, typename Ptr>
void fill_levels(Levels<T>* lv, const Ptr* ptrs, const int* heights, const int* widths,
                 const float* strides, int num_levels) {
  for (int i = 0; i < num_levels; ++i) {
    lv->ptr[i] = static_cast<T*>(ptrs[i]);
    lv->h[i] = heights[i];
    lv->w[i] = widths[i];
    lv->stride[i] = strides[i];
  }
}

bool bad_args(int num_levels, int pool, int ratio) {
  return num_levels < 1 || num_levels > kMaxLevels || pool * ratio > kMaxSamples ||
         pool < 1 || ratio < 1;
}

// threads across channels, at least enough for the sample set-up
int block_threads(int channels, int pool, int ratio) {
  return std::max(std::min(((channels + 31) / 32) * 32, 256),
                  ((pool * ratio + ratio + 31) / 32) * 32);
}

// The widest channel slice of 32, 16, 8 or 4 that divides `channels` and
// keeps a block's dynamic shared memory within kBwdSmemLimit; 0 if none.
int bwd_slice(int channels, int pool, int ratio) {
  for (int slice = 32; slice >= 4; slice /= 2) {
    if (channels % slice == 0 && bwd_smem_bytes(pool, ratio, slice) <= kBwdSmemLimit) {
      return slice;
    }
  }
  return 0;
}

// K3 may take more than the default 48 KB of dynamic shared memory; the
// attribute belongs to the kernel's instance on one device, so it is set
// once per device, for each slice width.
template <int kSlice>
cudaError_t launch_bwd(const Levels<float>& lv, const void* rois, const void* levels,
                       const void* grad_out, int num_rois, int rois_per_image, int channels,
                       int pool, int ratio, cudaStream_t stream) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!done[dev]) {
      err = cudaFuncSetAttribute(roi_align_backward_kernel<kSlice>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemLimit);
      if (err != cudaSuccess) return err;
      done[dev] = true;
    }
  }
  roi_align_backward_kernel<kSlice>
      <<<num_rois * (channels / kSlice), kBwdThreads, bwd_smem_bytes(pool, ratio, kSlice),
         stream>>>(lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
                   static_cast<const float*>(grad_out), rois_per_image, channels, pool, ratio);
  return cudaGetLastError();
}

}  // namespace

// feats/heights/widths/strides: host arrays of num_levels entries (device
// pointers to [B, Hl, Wl, C] float32); rois: [num_rois, 4] float32;
// levels: [num_rois] int32; out: [num_rois, P, P, C] float32. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int roi_align_forward(const void* const* feats, const int* heights,
                                 const int* widths, const float* strides,
                                 int num_levels, const void* rois,
                                 const void* levels, void* out, int num_rois,
                                 int rois_per_image, int channels, int pool,
                                 int ratio, void* stream) {
  if (bad_args(num_levels, pool, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois <= 0 || channels <= 0) return 0;
  Levels<const float> lv = {};
  fill_levels(&lv, feats, heights, widths, strides, num_levels);
  roi_align_forward_kernel<<<num_rois * pool, block_threads(channels, pool, ratio), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
      static_cast<float*>(out), rois_per_image, channels, pool, ratio);
  return static_cast<int>(cudaGetLastError());
}

// grads: host array of num_levels device pointers to zero-filled
// [B, Hl, Wl, C] float32 buffers, 16-byte aligned, which receive the
// gradient; grad_out: [num_rois, P, P, C] float32, 16-byte aligned; C a
// multiple of 4; the other arguments as roi_align_forward, with the routing
// the forward used. Returns the cudaError_t of the launch.
extern "C" int roi_align_backward(void* const* grads, const int* heights,
                                  const int* widths, const float* strides,
                                  int num_levels, const void* rois,
                                  const void* levels, const void* grad_out,
                                  int num_rois, int rois_per_image, int channels,
                                  int pool, int ratio, void* stream) {
  if (bad_args(num_levels, pool, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois <= 0 || channels <= 0) return 0;
  Levels<float> lv = {};
  fill_levels(&lv, grads, heights, widths, strides, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bwd_slice(channels, pool, ratio)) {
    case 32:
      return static_cast<int>(launch_bwd<32>(lv, rois, levels, grad_out, num_rois,
                                             rois_per_image, channels, pool, ratio, s));
    case 16:
      return static_cast<int>(launch_bwd<16>(lv, rois, levels, grad_out, num_rois,
                                             rois_per_image, channels, pool, ratio, s));
    case 8:
      return static_cast<int>(launch_bwd<8>(lv, rois, levels, grad_out, num_rois,
                                            rois_per_image, channels, pool, ratio, s));
    case 4:
      return static_cast<int>(launch_bwd<4>(lv, rois, levels, grad_out, num_rois,
                                            rois_per_image, channels, pool, ratio, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
