// Multilevel RoIAlign forward over an FPN, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detectron_tpu/ops/roi_align_pallas.py::multilevel_roi_align_pallas
// (_make_kernel, _interp_matrix): per-level NHWC features [B, Hl, Wl, C]
// and RoIs [B, R, 4] (image coordinates) give [B, R, P, P, C]. aligned=False,
// RoI extent at least one cell, S x S bilinear samples per bin averaged,
// and the Caffe2 border rule: a sample outside [-1, size] contributes 0,
// otherwise it is clamped to [0, size - 1]. The level of every RoI is
// computed by the caller (the port's assign_fpn_levels), so this kernel
// and its plain PyTorch version route identically by construction.
//
// What bounds it on the H100: memory, not arithmetic. Each output value
// costs 4 * S^2 feature reads and about 8 * S^2 fp32 operations, and the
// samples of one RoI fall on a few feature cells that many outputs share,
// so the bytes that must cross device memory are the output plus the
// feature cells the RoIs touch. The TPU kernel DMA'd a window per RoI into
// VMEM and interpolated it with two matmuls on the MXU; a window copy would
// only add traffic here. Instead the kernel gathers straight from the
// channels-last features: one block per (RoI, output row), threads across
// channels, so every corner read is one coalesced 4*C-byte row segment and
// the cells shared by neighbouring samples come from L1/L2. The sample
// coordinates and weights of the block are computed once into shared
// memory. Sums are fp32.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // P * S along one axis

struct Levels {
  const float* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
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

__global__ void roi_align_forward_kernel(Levels lv, const float4* __restrict__ rois,
                                         const int* __restrict__ levels,
                                         float* __restrict__ out, int rois_per_image,
                                         int channels, int pool, int ratio) {
  __shared__ int sx0[kMaxSamples], sx1[kMaxSamples];
  __shared__ float swx0[kMaxSamples], swx1[kMaxSamples];
  __shared__ int sy0[kMaxSamples], sy1[kMaxSamples];
  __shared__ float swy0[kMaxSamples], swy1[kMaxSamples];

  const int n = blockIdx.x / pool;  // RoI, over the whole batch
  const int p = blockIdx.x % pool;  // output row
  const int b = n / rois_per_image;
  const int l = levels[n];
  const int height = lv.h[l];
  const int width = lv.w[l];
  // Sample coordinates reach hundreds of cells, where one rounding step is
  // ~3e-5 of a cell; a fused multiply-add here would move the bilinear
  // weights by that much against the plain version. So every step is
  // rounded as the JAX and PyTorch versions round it (_rn intrinsics are
  // never contracted).
  const float scale = __fdiv_rn(1.0f, lv.stride[l]);
  const float4 roi = rois[n];
  const float x1 = __fmul_rn(roi.x, scale);
  const float y1 = __fmul_rn(roi.y, scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.z, scale), x1), 1.0f),
                                static_cast<float>(pool));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.w, scale), y1), 1.0f),
                                static_cast<float>(pool));

  const int t = threadIdx.x;
  if (t < pool * ratio) {  // x samples of every output column
    const float pos = static_cast<float>(t / ratio) + (t % ratio + 0.5f) / ratio;
    bilinear(__fadd_rn(x1, __fmul_rn(pos, bin_w)), width, &sx0[t], &sx1[t], &swx0[t],
             &swx1[t]);
  } else if (t < pool * ratio + ratio) {  // y samples of output row p
    const int j = t - pool * ratio;
    const float pos = static_cast<float>(p) + (j + 0.5f) / ratio;
    bilinear(__fadd_rn(y1, __fmul_rn(pos, bin_h)), height, &sy0[j], &sy1[j], &swy0[j],
             &swy1[j]);
  }
  __syncthreads();

  const float* feat = lv.feat[l] + static_cast<size_t>(b) * height * width * channels;
  float* dst = out + (static_cast<size_t>(n) * pool + p) * pool * channels;
  const float count = static_cast<float>(ratio * ratio);
  for (int c = t; c < channels; c += blockDim.x) {
    const float* fc = feat + c;
    for (int q = 0; q < pool; ++q) {
      float acc = 0.0f;
      for (int sy = 0; sy < ratio; ++sy) {
        const float* row0 = fc + static_cast<size_t>(sy0[sy]) * width * channels;
        const float* row1 = fc + static_cast<size_t>(sy1[sy]) * width * channels;
        const float wy0 = swy0[sy], wy1 = swy1[sy];
        for (int sx = 0; sx < ratio; ++sx) {
          const int k = q * ratio + sx;
          const int xa = sx0[k] * channels, xb = sx1[k] * channels;
          const float wx0 = swx0[k], wx1 = swx1[k];
          acc += __ldg(row0 + xa) * (wy0 * wx0) + __ldg(row0 + xb) * (wy0 * wx1) +
                 __ldg(row1 + xa) * (wy1 * wx0) + __ldg(row1 + xb) * (wy1 * wx1);
        }
      }
      dst[q * channels + c] = acc / count;
    }
  }
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
  if (num_levels < 1 || num_levels > kMaxLevels || pool * ratio > kMaxSamples ||
      pool < 1 || ratio < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois <= 0 || channels <= 0) return 0;
  Levels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.feat[i] = static_cast<const float*>(feats[i]);
    lv.h[i] = heights[i];
    lv.w[i] = widths[i];
    lv.stride[i] = strides[i];
  }
  // threads across channels, at least enough for the sample set-up
  const int threads = std::max(std::min(((channels + 31) / 32) * 32, 256),
                               ((pool * ratio + ratio + 31) / 32) * 32);
  roi_align_forward_kernel<<<num_rois * pool, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
      static_cast<float*>(out), rois_per_image, channels, pool, ratio);
  return static_cast<int>(cudaGetLastError());
}
