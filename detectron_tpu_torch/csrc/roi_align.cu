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
// with respect to each level, given the upstream gradient [B, R, P, P, C]
// and the routing the forward used. Every sample adds g * wy * wx / S^2
// into its four corner cells of a zero-filled fp32 [B, Hl, Wl, C] buffer
// per level. The RoIs get no gradient.
//
// What bounds them on the H100: memory, not arithmetic. Each output value
// costs 4 * S^2 feature reads (K2) or atomic adds (K3) and about 8 * S^2
// fp32 operations, and the samples of one RoI fall on a few feature cells
// that many outputs share, so the bytes that must cross device memory are
// the output (K2) or the upstream gradient (K3) plus the feature cells the
// RoIs touch; K3 also writes every level's gradient once (the zero fill).
//
// Design. The TPU kernels DMA'd a window per RoI into VMEM and interpolated
// it with two matmuls on the MXU; the backward walked the RoIs in a
// sequential grid and read-modified-wrote each window, because a TPU grid
// has no atomics. Neither carries over. Both kernels here work straight on
// the channels-last levels: one block per (RoI, output row), threads across
// channels, so every corner access is one coalesced 4*C-byte row segment.
// The sample coordinates and weights of the block are computed once into
// shared memory by the same code for both directions, so K3 is the exact
// transpose of K2. K2 gathers (cells shared by neighbouring samples come
// from L1/L2); K3 scatters with fp32 atomicAdd into L2, which resolves the
// adds of overlapping RoIs. Sums are fp32.
//
// K3 is not bitwise deterministic: fp32 atomics add in an order that
// changes from run to run, so the last bits of a cell that several samples
// or RoIs touch may differ between two runs.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // P * S along one axis

template <typename T>
struct Levels {
  T* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
};

// Sample indices and bilinear weights of one block: the x samples of every
// output column and the y samples of the block's output row.
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

// Fills `st` for RoI `roi` on a level of the given size and stride, output
// row p. Threads [0, pool*ratio) take the x samples, the next `ratio`
// threads the y samples; the caller synchronises.
__device__ __forceinline__ void fill_samples(SampleTable& st, const float4 roi,
                                             float stride, int height, int width,
                                             int pool, int ratio, int p) {
  // Sample coordinates reach hundreds of cells, where one rounding step is
  // ~3e-5 of a cell; a fused multiply-add here would move the bilinear
  // weights by that much against the plain version. So every step is
  // rounded as the JAX and PyTorch versions round it (_rn intrinsics are
  // never contracted).
  const float scale = __fdiv_rn(1.0f, stride);
  const float x1 = __fmul_rn(roi.x, scale);
  const float y1 = __fmul_rn(roi.y, scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.z, scale), x1), 1.0f),
                                static_cast<float>(pool));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.w, scale), y1), 1.0f),
                                static_cast<float>(pool));
  const int t = threadIdx.x;
  if (t < pool * ratio) {  // x samples of every output column
    const float pos = static_cast<float>(t / ratio) + (t % ratio + 0.5f) / ratio;
    bilinear(__fadd_rn(x1, __fmul_rn(pos, bin_w)), width, &st.x0[t], &st.x1[t],
             &st.wx0[t], &st.wx1[t]);
  } else if (t < pool * ratio + ratio) {  // y samples of output row p
    const int j = t - pool * ratio;
    const float pos = static_cast<float>(p) + (j + 0.5f) / ratio;
    bilinear(__fadd_rn(y1, __fmul_rn(pos, bin_h)), height, &st.y0[j], &st.y1[j],
             &st.wy0[j], &st.wy1[j]);
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

// Adds v * w into *cell unless the weight is zero (an out-of-range sample,
// or the second tap of a sample on a cell centre). The test is uniform
// across the block: the weights come from the shared sample table.
__device__ __forceinline__ void add_weighted(float* cell, float v, float w) {
  if (w != 0.0f) atomicAdd(cell, v * w);
}

__global__ void roi_align_backward_kernel(Levels<float> lv,
                                          const float4* __restrict__ rois,
                                          const int* __restrict__ levels,
                                          const float* __restrict__ grad_out,
                                          int rois_per_image, int channels, int pool,
                                          int ratio) {
  __shared__ SampleTable st;
  const int n = blockIdx.x / pool;
  const int p = blockIdx.x % pool;
  const int b = n / rois_per_image;
  const int l = levels[n];
  const int height = lv.h[l];
  const int width = lv.w[l];
  fill_samples(st, rois[n], lv.stride[l], height, width, pool, ratio, p);
  __syncthreads();

  float* grad = lv.ptr[l] + static_cast<size_t>(b) * height * width * channels;
  const float* src = grad_out + (static_cast<size_t>(n) * pool + p) * pool * channels;
  const float count = static_cast<float>(ratio * ratio);
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    float* gc = grad + c;
    for (int q = 0; q < pool; ++q) {
      const float v = __ldg(src + q * channels + c) / count;
      for (int sy = 0; sy < ratio; ++sy) {
        float* row0 = gc + static_cast<size_t>(st.y0[sy]) * width * channels;
        float* row1 = gc + static_cast<size_t>(st.y1[sy]) * width * channels;
        const float wy0 = st.wy0[sy], wy1 = st.wy1[sy];
        for (int sx = 0; sx < ratio; ++sx) {
          const int k = q * ratio + sx;
          const int xa = st.x0[k] * channels, xb = st.x1[k] * channels;
          const float wx0 = st.wx0[k], wx1 = st.wx1[k];
          add_weighted(row0 + xa, v, wy0 * wx0);
          add_weighted(row0 + xb, v, wy0 * wx1);
          add_weighted(row1 + xa, v, wy1 * wx0);
          add_weighted(row1 + xb, v, wy1 * wx1);
        }
      }
    }
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
// [B, Hl, Wl, C] float32 buffers, which receive the gradient; grad_out:
// [num_rois, P, P, C] float32; the other arguments as roi_align_forward,
// with the routing the forward used. Returns the cudaError_t of the launch.
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
  roi_align_backward_kernel<<<num_rois * pool, block_threads(channels, pool, ratio), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
      static_cast<const float*>(grad_out), rois_per_image, channels, pool, ratio);
  return static_cast<int>(cudaGetLastError());
}
