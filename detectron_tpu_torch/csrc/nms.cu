// Greedy NMS keep mask for many problems at once, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel detectron_tpu/ops/nms_pallas.py::nms_pallas
// (_nms_kernel, _iou_block): greedy suppression over score-sorted boxes,
// suppress j by i when i < j, i is kept and valid, and IoU(i, j) > thresh
// (strict), IoU = inter / max(union, 1e-8) with the `offset` width
// convention.
//
// What bounds it on the H100: not bytes (16 bytes a box) and not IoU
// arithmetic (~16 fp32 operations a pair, N^2/2 pairs), but the greedy
// chain itself: box i's fate depends on every kept box before it, so a
// problem is a sequential walk of N steps. The TPU kernel walked 128-box
// tiles in order on one core. Here the work is split in two launches:
//
//   1. nms_mask_kernel, grid (col_blocks, row_blocks, G), 64 threads: every
//      IoU of the upper triangle at once, in parallel over the whole card.
//      Thread t of block (cb, rb) takes sorted box i = 64*rb + t against the
//      64 boxes of column block cb (staged in shared memory) and writes one
//      64-bit word whose bit j says "i suppresses 64*cb + j".
//   2. nms_scan_kernel, one warp per problem: the sequential walk, reduced
//      to one bit test and one OR of a row of words per kept box. Lane l
//      holds the removed-bits words l and l+32 in registers, and the rows
//      come from shared memory, staged 64 at a time; there is no
//      __syncthreads in the chain.
//
// The IoU must be bit-identical to the JAX package's bbox_overlaps and
// _iou_block so that keep sets are equal: the same operation order, IEEE
// division, and the _rn intrinsics, which the compiler never contracts
// into fused multiply-adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ float box_area(const float4 b, float offset) {
  float w = fmaxf(__fadd_rn(__fsub_rn(b.z, b.x), offset), 0.0f);
  float h = fmaxf(__fadd_rn(__fsub_rn(b.w, b.y), offset), 0.0f);
  return __fmul_rn(w, h);
}

// IoU of row box a (the earlier, higher-scored one) and column box b.
__device__ __forceinline__ float iou(const float4 a, float area_a,
                                     const float4 b, float area_b,
                                     float offset) {
  float ix1 = fmaxf(a.x, b.x);
  float iy1 = fmaxf(a.y, b.y);
  float ix2 = fminf(a.z, b.z);
  float iy2 = fminf(a.w, b.w);
  float iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), offset), 0.0f);
  float ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), offset), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-8f));
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes,  // [G, N]
                                unsigned long long* __restrict__ mask,  // [G, N, W]
                                int n, int words, float thresh,
                                float offset) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int g = blockIdx.z;
  const int t = threadIdx.x;
  const int i = rb * kBlock + t;
  const float4* gboxes = boxes + (size_t)g * n;

  if (cb < rb) return;  // columns before the row: never read by the scan

  __shared__ float4 col[kBlock];
  __shared__ float col_area[kBlock];
  const int j0 = cb * kBlock;
  const int ncol = min(kBlock, n - j0);
  if (t < ncol) {
    float4 b = gboxes[j0 + t];
    col[t] = b;
    col_area[t] = box_area(b, offset);
  }
  __syncthreads();
  if (i >= n) return;

  const float4 a = gboxes[i];
  const float area_a = box_area(a, offset);
  unsigned long long bits = 0ull;
  const int start = (cb == rb) ? t + 1 : 0;  // only j > i
  for (int k = start; k < ncol; ++k) {
    if (iou(a, area_a, col[k], col_area[k], offset) > thresh) {
      bits |= 1ull << k;
    }
  }
  mask[((size_t)g * n + i) * words + cb] = bits;
}

constexpr int kMaxWords = 64;  // 2 words a lane: at most 4096 boxes

// One warp walks one problem in chunks of 64 sorted boxes. The chunk's
// mask rows (only the words at or after the chunk's own, the rest cannot
// matter) are first staged in shared memory by coalesced loads that are
// all in flight together, so the sequential walk pays one device-memory
// latency a chunk instead of one a kept box.
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,  // [G, N]
                                uint8_t* __restrict__ keep,  // [G, N]
                                int n, int words) {
  extern __shared__ unsigned long long rows[];  // [64, words]
  const unsigned full = 0xffffffffu;
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* gmask = mask + (size_t)g * n * words;
  const uint8_t* gvalid = valid + (size_t)g * n;
  uint8_t* gkeep = keep + (size_t)g * n;

  // removed-bits words `lane` and `lane + 32`, in registers
  unsigned long long removed0 = 0ull, removed1 = 0ull;

  for (int rb = 0; rb < words; ++rb) {
    const int i0 = rb * kBlock;
    const int nrow = min(kBlock, n - i0);
    const int span = words - rb;
    for (int e = lane; e < nrow * span; e += 32) {
      const int r = e / span;
      const int c = rb + e % span;
      rows[r * words + c] = gmask[(size_t)(i0 + r) * words + c];
    }
    const unsigned v_lo =
        __ballot_sync(full, lane < nrow && gvalid[i0 + lane] != 0);
    const unsigned v_hi =
        __ballot_sync(full, lane + 32 < nrow && gvalid[i0 + 32 + lane] != 0);
    const unsigned long long vbits =
        (static_cast<unsigned long long>(v_hi) << 32) | v_lo;
    __syncwarp();

    // word rb of the removed bits, the same value in every lane
    unsigned long long cur =
        __shfl_sync(full, (rb >> 5) ? removed1 : removed0, rb & 31);
    unsigned long long kept_bits = 0ull;
    for (int r = 0; r < nrow; ++r) {
      if (((vbits & ~cur) >> r) & 1ull) {  // warp-uniform
        kept_bits |= 1ull << r;
        const unsigned long long* row = rows + r * words;
        cur |= row[rb];
        if (lane > rb && lane < words) removed0 |= row[lane];
        if (lane + 32 > rb && lane + 32 < words) removed1 |= row[lane + 32];
      }
    }
    if (lane < nrow) gkeep[i0 + lane] = (kept_bits >> lane) & 1ull;
    if (lane + 32 < nrow) gkeep[i0 + 32 + lane] = (kept_bits >> (lane + 32)) & 1ull;
    __syncwarp();  // the next chunk overwrites `rows`
  }
}

}  // namespace

extern "C" int nms_max_boxes() { return kMaxWords * kBlock; }

// boxes: [G, N, 4] float32, score-sorted per problem; valid: [G, N] uint8;
// mask: [G, N, ceil(N/64)] uint64 workspace; keep: [G, N] uint8 output.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int nms_keep(const void* boxes, const void* valid, void* mask,
                        void* keep, int g, int n, float thresh, float offset,
                        void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int words = (n + kBlock - 1) / kBlock;
  if (words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(words, words, g);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(
      static_cast<const float4*>(boxes),
      static_cast<unsigned long long*>(mask), n, words, thresh, offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<g, 32, kBlock * words * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n,
      words);
  return static_cast<int>(cudaGetLastError());
}
