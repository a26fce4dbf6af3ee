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
// 1024x1344 at C=256, is most of it); their arithmetic is a few fp32
// operations a sample.
//
// Both kernels share a block's set-up: warp 0 computes the block's RoI's
// P*S x samples and warp 1 its P*S y samples (roi_frame, sample_coord,
// bilinear), so K3 stays K2's exact transpose; each warp folds its axis
// onto the sorted distinct cells that its nonzero taps touch (at most
// 2*P*S: samples are monotone and each has two taps; a RoI wider than P*S
// cells gives sparse cells, a sub-cell RoI one or two), with ballots and a
// binary-search merge (roi_axis, fold_axis), so shared memory is sized by P
// and S, never by the RoI's extent. The passes' index arithmetic divides
// nothing at run time (the slice width is a template parameter, other
// indices are split by a multiply, div_small): with a few taps an output,
// integer division would otherwise be most of a block's instructions.
//
// K2 design. The TPU kernel DMA'd each RoI's window into VMEM once and
// interpolated it with two matmuls on the MXU, Wy @ window @ Wx^T. A
// direct gather instead (the port's first K2: one block per (RoI, output
// row), each output reading the 4 corners of its S^2 samples) requests a
// RoI's cells again and again, for neighbouring samples and bins: 6.5x
// (P=7) to 24x (P=14) the bytes of the cells a RoI touches, as scalar
// loads through L1 and L2. Here one block takes a RoI and a group of its
// channel slices (`slice` channels each: all of them, or fewer where a
// RoI a block would leave too few blocks to fill the card), and reads each
// cell its samples touch from device memory once per slice:
//   1. the set-up above, once for the group; then, per axis, each output
//      bin's taps (the slot of the tap's cell among the distinct cells, its
//      weight), and for every output row the last y slot its taps read. The
//      set-up's working tables use the block's dynamic shared memory until
//      the ring and the staging buffers take it over;
//   2. items (slice, chunk of y rows) in order: the chunk's cells of the
//      slice are copied into shared memory by 16-byte cp.async (a cell's
//      slice is one contiguous run of 4*slice bytes in NHWC), and the next
//      item's copies are in flight while the current one is contracted;
//   3. pass x contracts the chunk's rows into a ring of rows in shared
//      memory, t[y, q, c] = sum over the x taps of bin q of wx * F[y, x, c]
//      (a thread takes one column q, its taps in registers, down the rows);
//      pass y then finishes every output row whose taps have all arrived,
//      out[p, q, c] = sum over the y taps of bin p of wy * t[y, q, c] / S^2,
//      and writes it with 16-byte stores. A bin's taps read at most 2*S
//      distinct rows, so the ring holds a chunk plus 2*S - 1 rows, and a RoI
//      taller than a chunk streams through it;
//   4. each thread owns whole outputs and sums its taps in a fixed order:
//      no atomics, so the output is bitwise deterministic. fp32 FMAs on the
//      CUDA cores: tensor cores would need TF32, and there are tens of FMAs
//      an output value.
// What limits it on the H100 is not the bytes (PERF.md; scripts/
// k2_ablation.py times the parts): a block's set-up, copies and passes run
// one after another, separated by barriers, and the few blocks an SM holds
// (registers, shared memory) do not hide that chain. A RoI's slices are
// split over blocks until there are kFwdBlocksPerSm an SM: one block for
// all of them shares the set-up, but the set-up is a small part of a
// block's time and too few blocks are left.

// K3 design. What the TPU kernel kept out of device memory was the traffic
// of the samples: it built each RoI's window gradient on chip (Wy^T g Wx)
// and added the window into the level once. Adding every sample's four
// corners into device memory with scalar fp32 atomics instead costs
// 4 S^2 P^2 L2 atomics a RoI and channel, mostly onto the same few cells,
// and those, not the bytes, would be the time. So, after the shared set-up
// (during which the other six warps stage g / S^2 of the RoI's slice in
// shared memory, so the fold hides under that load):
//   1. pass 1 contracts x: t[p, xcell, c] = sum over the x taps on xcell of
//      wx * g[p, q, c]; pass 2 contracts y: d[ycell, xcell, c] = sum over
//      the y taps on ycell of wy * t[p, xcell, c]. Each thread owns whole
//      outputs and sums its taps in a fixed order, so there are no
//      shared-memory atomics and a RoI's own sum is deterministic;
//   2. each touched cell gets one 16-byte atomicAdd (red.global.add.v4.f32)
//      per 4 channels: a mask RoI of ~14 cells on its level issues ~15x15
//      of them per 4 channels instead of 3136 scalar adds per channel.
// Only the adds of different RoIs onto the same cell remain unordered, so
// K3 is not bitwise deterministic across RoIs: the last bits of a cell that
// overlapping RoIs touch may differ between two runs. Sums are fp32.
//
// `slice` is, for each kernel, the first of its widths that divides C and
// whose shared memory lets blocks share an SM: K2 64, 32 or 4 (64 at C=256,
// P=7 and 14; 32 at the small configs' C=32; 4 divides any C the wrapper
// takes), K3 32, 16, 8 or 4 (32 at P=7, 16 at P=14, with S=2).

#include <cuda_runtime.h>

#include <algorithm>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // P * S along one axis
constexpr int kMaxTaps = 2 * kMaxSamples;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;  // a block of either kernel
constexpr int kBwdSmemLimit = 100 * 1024;  // dynamic bytes a K3 block: two fit on an SM
constexpr int kFwdSmemLimit = 64 * 1024;   // dynamic bytes a K2 block: three fit on an SM
constexpr int kFwdStageBytes = 16 * 1024;  // one of K2's two staging buffers, at least
constexpr int kFwdRingBytes = 16 * 1024;   // K2's ring, at most, where 4*S rows fit
constexpr int kFwdBlocksPerSm = 8;         // K2 splits a RoI's slices until it has this many

template <typename T>
struct Levels {
  T* ptr[kMaxLevels];
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

// One axis of a block's RoI, folded onto the distinct cells its nonzero
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

// The samples of a block's RoI, per axis (0: x, 1: y), and their folds.
struct RoiTable {
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
__device__ void fold_axis(RoiTable& tab, int a, int samples, int ratio, int lane) {
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

// The set-up both kernels share, run by warp `a` of the block: the RoI's
// pool * ratio samples along axis a (0: x over `size` = the level's width,
// 1: y over its height), folded onto their distinct cells.
__device__ void roi_axis(RoiTable& tab, const float4 roi, float stride, int size, int pool,
                         int ratio, int a, int lane) {
  const RoiFrame f = roi_frame(roi, stride, pool);
  const int samples = pool * ratio;
  for (int k = lane; k < samples; k += 32) {
    bilinear(sample_coord(a ? f.y1 : f.x1, a ? f.bin_h : f.bin_w, k, ratio), size,
             &tab.i0[a][k], &tab.i1[a][k], &tab.w0[a][k], &tab.w1[a][k]);
  }
  __syncwarp();
  fold_axis(tab, a, samples, ratio, lane);
  __syncwarp();
}

__device__ __forceinline__ void fma4(float4& acc, const float4 v, float w) {
  acc.x += v.x * w;
  acc.y += v.y * w;
  acc.z += v.z * w;
  acc.w += v.w * w;
}

// q / d for q < 2^16 and 1 <= d <= 128, with `magic` = ceil(2^32 / d): one
// multiply instead of an integer division in the passes' index arithmetic.
__device__ __forceinline__ int div_small(int q, unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(q) * magic) >> 32);
}

__device__ __forceinline__ unsigned long long div_magic(int d) {
  return ((1ull << 32) + d - 1) / d;
}

// ------------------------------------------------------------------- K2

// A tap of one output bin along one axis: the slot of its cell among the
// axis's distinct cells, and its weight.
struct __align__(8) Tap {
  int slot;
  float weight;
};

// What a K2 block keeps of its RoI's fold, by output bin: the nonzero taps
// of bin p of axis a are tap[a][p * 2S + e] for e < count[a][p], in sample
// order, i0 before i1; last_row[p] is the last y slot the taps of output
// row p read (-1 if none); cell[a][s] for s < cells[a] are the axis's
// distinct cells. Samples are monotone, so last_row does not decrease over
// the rows that read any, the rows that read none come first or last, and
// a row's taps read at most 2*S distinct slots, all above last_row - 2*S.
struct FwdTaps {
  int cells[2];
  int cell[2][kMaxTaps];
  int count[2][kMaxSamples];
  Tap tap[2][kMaxTaps];
  int last_row[kMaxSamples];
};

// The set-up's working tables, which live in the block's dynamic shared
// memory until the ring and the staging buffers take it over: the samples
// and their fold, and each sample's two slots (-1 for a zero weight).
struct FwdSetup {
  RoiTable tab;
  int slot0[2][kMaxSamples], slot1[2][kMaxSamples];
};

// The slot of `cell` among the axis's distinct cells (which hold it).
__device__ __forceinline__ int slot_of(const AxisTaps& ax, int cell) {
  int lo = 0, hi = ax.count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ax.cell[mid] < cell) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Warp `a` of a K2 block, after roi_axis: its axis's taps by bin and its
// distinct cells, into `ft`.
__device__ void bin_taps(FwdSetup& su, FwdTaps& ft, int a, int pool, int ratio, int lane) {
  const RoiTable& tab = su.tab;
  const AxisTaps& axis = tab.axis[a];
  for (int k = lane; k < pool * ratio; k += 32) {
    su.slot0[a][k] = tab.w0[a][k] != 0.0f ? slot_of(axis, tab.i0[a][k]) : -1;
    su.slot1[a][k] = tab.w1[a][k] != 0.0f ? slot_of(axis, tab.i1[a][k]) : -1;
  }
  for (int s = lane; s < axis.count; s += 32) ft.cell[a][s] = axis.cell[s];
  if (lane == 0) ft.cells[a] = axis.count;
  __syncwarp();
  for (int p = lane; p < pool; p += 32) {
    Tap* taps = &ft.tap[a][p * 2 * ratio];
    int count = 0, last = -1;
    for (int k = p * ratio; k < (p + 1) * ratio; ++k) {
      if (su.slot0[a][k] >= 0) taps[count++] = Tap{su.slot0[a][k], tab.w0[a][k]};
      if (su.slot1[a][k] >= 0) taps[count++] = Tap{su.slot1[a][k], tab.w1[a][k]};
      last = max(last, max(su.slot0[a][k], su.slot1[a][k]));
    }
    ft.count[a][p] = count;
    if (a == 1) ft.last_row[p] = last;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A bin's taps along one axis, in registers where the instance knows S
// (kTaps = 2*S > 0; taps past `count` weigh 0 and are skipped), else read
// from shared memory.
template <int kTaps>
struct BinTaps {
  Tap tap[kTaps > 0 ? kTaps : 1];
  const Tap* shared;
  int count;

  __device__ __forceinline__ BinTaps(const Tap* taps, int n) : shared(taps), count(n) {
#pragma unroll
    for (int e = 0; e < kTaps; ++e) tap[e] = e < n ? taps[e] : Tap{0, 0.0f};
  }

  // sum over the taps of w * v[(slot & mask) * stride], in tap order
  __device__ __forceinline__ float4 contract(const float4* v, int stride, int mask) const {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kTaps > 0) {
#pragma unroll
      for (int e = 0; e < kTaps; ++e) {
        if (e < count) fma4(acc, v[(tap[e].slot & mask) * stride], tap[e].weight);
      }
    } else {
      for (int e = 0; e < count; ++e) {
        fma4(acc, v[(shared[e].slot & mask) * stride], shared[e].weight);
      }
    }
    return acc;
  }
};

// Rows of K2's ring of x-contracted rows: the largest power of two whose
// ring stays within kFwdRingBytes, and at least 4*S (so that a chunk of at
// least 2*S + 1 rows plus the 2*S - 1 rows an unfinished bin may still read
// fit).
int fwd_ring_rows(int pool, int ratio, int slice) {
  int rows = 1;
  while (rows < 4 * ratio) rows *= 2;
  while (2 * rows * pool * slice * static_cast<int>(sizeof(float)) <= kFwdRingBytes) rows *= 2;
  return rows;
}

// Cells one of K2's two staging buffers holds: kFwdStageBytes, and at
// least one row of the widest fold (2 * P * S cells).
int fwd_stage_cells(int pool, int ratio, int slice) {
  return std::max(2 * pool * ratio, kFwdStageBytes / (slice * static_cast<int>(sizeof(float))));
}

// Dynamic shared memory of one K2 block: the ring [rows][P][slice] and the
// two staging buffers [cells][slice], fp32, which the set-up's tables use
// first.
int fwd_smem_bytes(int pool, int ratio, int slice) {
  const int bytes = (fwd_ring_rows(pool, ratio, slice) * pool +
                     2 * fwd_stage_cells(pool, ratio, slice)) *
                    slice * static_cast<int>(sizeof(float));
  return std::max(bytes, static_cast<int>(sizeof(FwdSetup)));
}

// One block per (RoI, group of `per_block` consecutive channel slices).
// kRatio is S where the instance is specialised for it, else 0 (S at run
// time).
template <int kSlice, int kRatio>
__global__ void __launch_bounds__(kThreads)
    roi_align_forward_kernel(Levels<const float> lv, const float4* __restrict__ rois,
                             const int* __restrict__ levels, float* __restrict__ out,
                             int rois_per_image, int channels, int pool, int ratio_arg,
                             int per_block, int ring_rows, int stage_cells) {
  constexpr int kV4 = kSlice / 4;             // float4 groups of a slice
  constexpr int kLanes = kThreads / kV4;      // threads on one float4 group
  constexpr int kTaps = 2 * kRatio;
  const int ratio = kRatio > 0 ? kRatio : ratio_arg;
  extern __shared__ __align__(16) float fwd_smem[];
  __shared__ FwdTaps ft;
  const int groups = channels / (kSlice * per_block);
  const int n = blockIdx.x / groups;  // RoI, over the whole batch
  const int first = (blockIdx.x % groups) * per_block;  // first slice of the block
  const int b = n / rois_per_image;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int l = levels[n];
  const int height = lv.h[l];
  const int width = lv.w[l];

  // 1. warps 0 and 1: the RoI's x and y samples folded onto their distinct
  //    cells, then their taps by output bin
  if (warp < 2) {
    FwdSetup& su = *reinterpret_cast<FwdSetup*>(fwd_smem);
    roi_axis(su.tab, rois[n], lv.stride[l], warp ? height : width, pool, ratio, warp, lane);
    bin_taps(su, ft, warp, pool, ratio, lane);
  }
  __syncthreads();
  const int nx = ft.cells[0], ny = ft.cells[1];
  const int row4 = channels / 4;  // float4s from one output to the next
  const int c4 = t % kV4;
  const int u = t / kV4;  // this thread's place among the kLanes on its float4 group
  float4* dst = reinterpret_cast<float4*>(out) + static_cast<size_t>(n) * pool * pool * row4 +
                first * kV4 + c4;
  if (nx == 0 || ny == 0) {  // every sample outside the level (block-uniform)
    for (int j = u; j < pool * pool * per_block; j += kLanes) {
      const int pq = j / per_block;
      dst[pq * row4 + (j - pq * per_block) * kV4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }

  // 2. items (slice, chunk of y rows), in order: the distinct cells of the
  //    item staged by 16-byte asynchronous copies, the next item's copies in
  //    flight while the current one is contracted
  const float* feat = lv.ptr[l] + static_cast<size_t>(b) * height * width * channels +
                      first * kSlice + c4 * 4;
  float4* ring = reinterpret_cast<float4*>(fwd_smem);  // [ring_rows][pool][kV4]
  float4* stage = ring + ring_rows * pool * kV4;        // [2][stage_cells][kV4]
  const int mask = ring_rows - 1;
  const int chunk = min(stage_cells / nx, ring_rows - 2 * ratio + 1);  // rows an item
  const int chunks = (ny + chunk - 1) / chunk;
  const int items = chunks * per_block;
  const unsigned long long by_nx = div_magic(nx);
  const unsigned long long by_pool = div_magic(pool);
  // the passes give a thread one output column q (and, where the lanes of a
  // float4 group outnumber the columns, every `spread`-th row of it)
  const int spread = max(1, kLanes / pool);
  const float count = static_cast<float>(ratio * ratio);
  auto load = [&](int item) {
    const int j = item / chunks;
    const int r0 = (item - j * chunks) * chunk;
    const int cells = min(chunk, ny - r0) * nx;
    const float* src = feat + j * kSlice;
    float4* buf = stage + (item & 1) * stage_cells * kV4 + c4;
    for (int e = u; e < cells; e += kLanes) {
      const int r = div_small(e, by_nx);
      const int s = e - r * nx;
      cp_async16(buf + e * kV4,
                 src + (static_cast<size_t>(ft.cell[1][r0 + r]) * width + ft.cell[0][s]) *
                           channels);
    }
    cp_async_commit();
  };
  load(0);  // the set-up's tables are dead after the barrier above
  int p_done = 0;  // output rows of the current slice written
  for (int item = 0; item < items; ++item) {
    if (item + 1 < items) {
      load(item + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the item has landed; the last pass y no longer reads the ring
    const int j = item / chunks;
    const int r0 = (item - j * chunks) * chunk;
    const int rows = min(chunk, ny - r0);
    if (r0 == 0) p_done = 0;

    // 3. pass x: the item's rows into the ring
    const float4* buf = stage + (item & 1) * stage_cells * kV4 + c4;
    for (int e = u; e < pool * spread; e += kLanes) {
      const int g = div_small(e, by_pool);
      const int q = e - g * pool;
      const BinTaps<kTaps> taps(&ft.tap[0][q * 2 * ratio], ft.count[0][q]);
      for (int r = g; r < rows; r += spread) {
        ring[(((r0 + r) & mask) * pool + q) * kV4 + c4] =
            taps.contract(buf + r * nx * kV4, kV4, -1);
      }
    }
    __syncthreads();  // the ring holds the item's rows; its staging buffer is free

    //    pass y: every output row whose taps all lie in rows already contracted
    int p_end = p_done;
    while (p_end < pool && ft.last_row[p_end] < r0 + rows) ++p_end;
    float4* dj = dst + j * kV4;
    for (int e = u; e < pool * spread; e += kLanes) {
      const int g = div_small(e, by_pool);
      const int q = e - g * pool;
      for (int p = p_done + g; p < p_end; p += spread) {
        const BinTaps<kTaps> taps(&ft.tap[1][p * 2 * ratio], ft.count[1][p]);
        float4 acc = taps.contract(ring + q * kV4 + c4, pool * kV4, mask);
        acc.x = acc.x / count;
        acc.y = acc.y / count;
        acc.z = acc.z / count;
        acc.w = acc.w / count;
        dj[(p * pool + q) * row4] = acc;
      }
    }
    p_done = p_end;
  }
}

// ------------------------------------------------------------------- K3

// Dynamic shared memory of one K3 block: g of the RoI's slice [P*P, slice]
// and the x-contracted t [P, 2*P*S, slice], fp32.
int bwd_smem_bytes(int pool, int ratio, int slice) {
  return (pool * pool + pool * 2 * pool * ratio) * slice * static_cast<int>(sizeof(float));
}

template <int kSlice>
__global__ void __launch_bounds__(kThreads)
    roi_align_backward_kernel(Levels<float> lv, const float4* __restrict__ rois,
                              const int* __restrict__ levels,
                              const float* __restrict__ grad_out, int rois_per_image,
                              int channels, int pool, int ratio) {
  constexpr int kV4 = kSlice / 4;             // float4 groups of the slice
  constexpr int kCells = kThreads / kV4;      // cells one sweep of the block covers
  extern __shared__ __align__(16) float bwd_smem[];
  __shared__ RoiTable tab;
  const int slices = channels / kSlice;
  const int n = blockIdx.x / slices;  // RoI, over the whole batch
  const int c0 = (blockIdx.x % slices) * kSlice;
  const int b = n / rois_per_image;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int l = levels[n];
  const int height = lv.h[l];
  const int width = lv.w[l];
  const int span = 2 * pool * ratio;  // slots of t along x

  // 1. warps 0 and 1: the RoI's x and y samples, as K2 computes them, each
  //    folded onto its distinct cells; the other warps meanwhile stage
  //    g / S^2 of the RoI's channel slice
  float4* gs = reinterpret_cast<float4*>(bwd_smem);  // [P*P][kV4]
  float4* tx = gs + pool * pool * kV4;               // [P][span][kV4]
  if (warp < 2) {
    roi_axis(tab, rois[n], lv.stride[l], warp ? height : width, pool, ratio, warp, lane);
  } else {
    const float count = static_cast<float>(ratio * ratio);
    const float* src = grad_out + static_cast<size_t>(n) * pool * pool * channels + c0;
    for (int e = t - 64; e < pool * pool * kV4; e += kThreads - 64) {
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
  const unsigned long long by_nx = div_magic(nx);
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

// ------------------------------------------------------------ launching

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

// The first channel slice of `widths` that divides `channels` and keeps a
// block's dynamic shared memory within `limit`; 0 if none.
template <typename Bytes>
int pick_slice(std::initializer_list<int> widths, int channels, int pool, int ratio, int limit,
               Bytes bytes) {
  for (const int slice : widths) {
    if (channels % slice == 0 && bytes(pool, ratio, slice) <= limit) return slice;
  }
  return 0;
}

// A kernel may take more than the default 48 KB of dynamic shared memory;
// the attribute belongs to the kernel's instance on one device, so it is
// set once per device, for each instance.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::mutex* mu, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(*mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// The slices one K2 block walks: all of its RoI's, halved (while they
// divide) until there are kFwdBlocksPerSm blocks an SM, so that a RoI's
// set-up is shared by as many slices as the card's parallelism allows.
int fwd_per_block(int num_rois, int slices, int sms) {
  int per_block = slices;
  while (per_block % 2 == 0 &&
         static_cast<long long>(num_rois) * (slices / per_block) < kFwdBlocksPerSm * sms) {
    per_block /= 2;
  }
  return per_block;
}

template <int kSlice, int kRatio>
cudaError_t launch_fwd(const Levels<const float>& lv, const void* rois, const void* levels,
                       void* out, int num_rois, int rois_per_image, int channels, int pool,
                       int ratio, cudaStream_t stream) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(roi_align_forward_kernel<kSlice, kRatio>, kFwdSmemLimit, &mu, done);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int slices = channels / kSlice;
  const int per_block = fwd_per_block(num_rois, slices, sms[dev]);
  roi_align_forward_kernel<kSlice, kRatio>
      <<<num_rois * (slices / per_block), kThreads, fwd_smem_bytes(pool, ratio, kSlice),
         stream>>>(lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
                   static_cast<float*>(out), rois_per_image, channels, pool, ratio, per_block,
                   fwd_ring_rows(pool, ratio, kSlice), fwd_stage_cells(pool, ratio, kSlice));
  return cudaGetLastError();
}

// K2 at slice width kSlice, with the instance specialised for S = 2 (the
// model's sampling ratio) where it applies.
template <int kSlice>
cudaError_t launch_fwd_slice(const Levels<const float>& lv, const void* rois,
                             const void* levels, void* out, int num_rois, int rois_per_image,
                             int channels, int pool, int ratio, cudaStream_t stream) {
  return ratio == 2 ? launch_fwd<kSlice, 2>(lv, rois, levels, out, num_rois, rois_per_image,
                                            channels, pool, ratio, stream)
                    : launch_fwd<kSlice, 0>(lv, rois, levels, out, num_rois, rois_per_image,
                                            channels, pool, ratio, stream);
}

template <int kSlice>
cudaError_t launch_bwd(const Levels<float>& lv, const void* rois, const void* levels,
                       const void* grad_out, int num_rois, int rois_per_image, int channels,
                       int pool, int ratio, cudaStream_t stream) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  cudaError_t err = allow_smem(roi_align_backward_kernel<kSlice>, kBwdSmemLimit, &mu, done);
  if (err != cudaSuccess) return err;
  roi_align_backward_kernel<kSlice>
      <<<num_rois * (channels / kSlice), kThreads, bwd_smem_bytes(pool, ratio, kSlice),
         stream>>>(lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
                   static_cast<const float*>(grad_out), rois_per_image, channels, pool, ratio);
  return cudaGetLastError();
}

}  // namespace

// feats/heights/widths/strides: host arrays of num_levels entries (device
// pointers to [B, Hl, Wl, C] float32, 16-byte aligned); rois: [num_rois, 4]
// float32; levels: [num_rois] int32; out: [num_rois, P, P, C] float32,
// 16-byte aligned; C a multiple of 4. Returns the cudaError_t of the launch
// (0 = success).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_slice({64, 32, 4}, channels, pool, ratio, kFwdSmemLimit, fwd_smem_bytes)) {
    case 64:
      return static_cast<int>(launch_fwd_slice<64>(lv, rois, levels, out, num_rois, rois_per_image,
                                             channels, pool, ratio, s));
    case 32:
      return static_cast<int>(launch_fwd_slice<32>(lv, rois, levels, out, num_rois, rois_per_image,
                                             channels, pool, ratio, s));
    case 4:
      return static_cast<int>(launch_fwd_slice<4>(lv, rois, levels, out, num_rois, rois_per_image,
                                            channels, pool, ratio, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  switch (pick_slice({32, 16, 8, 4}, channels, pool, ratio, kBwdSmemLimit, bwd_smem_bytes)) {
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
