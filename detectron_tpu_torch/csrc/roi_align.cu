// Multilevel RoIAlign over an FPN, forward (K2) and backward (K3), for
// Hopper (sm_90a).
//
// K2, roi_align_forward, replaces the Pallas TPU kernel
// detectron_tpu/ops/roi_align_pallas.py::multilevel_roi_align_pallas
// (_make_kernel, _interp_matrix): per-level NHWC features [B, Hl, Wl, C]
// and RoIs [B, R, 4] (image coordinates) give [B, R, P, P, C]. S x S bilinear
// samples per bin averaged, and the Caffe2 border rule: a sample outside
// [-1, size] contributes 0, otherwise it is clamped to [0, size - 1]. With
// aligned=False (every model's), a RoI's extent is at least one cell; with
// aligned=True it moves by half a cell and its extent may be 0 (roi_frame).
// aligned is a template parameter of every kernel, so that the aligned=False
// instances are the same code as before it existed. The level of every RoI is
// computed by the caller (the port's assign_fpn_levels), so this kernel
// and its plain PyTorch version route identically by construction.
//
// K3 replaces the Pallas TPU kernel
// detectron_tpu/ops/roi_align_pallas.py::multilevel_roi_align_pallas_bwd
// (_make_bwd_kernel, _bwd_windows, _precompute_dwin): the gradient of K2
// with respect to each level, given the upstream gradient g [B, R, P, P, C]
// and the routing the forward used. The RoIs get no gradient. It has two
// routes: roi_align_backward (fp32 g) adds into zero-filled fp32
// [B, Hl, Wl, C] buffers (the caller's fill); for a bf16 g, roi_tap_bounds
// (a pre-pass) and roi_align_backward_tiles_bf16 write every bf16 level
// gradient once, whole, with no fill.
//
// What bounds them on the H100: memory, not arithmetic. K2 must read the
// feature cells its samples touch and write its output. K3 must read g and
// write every level's gradient once (234 MB in fp32 for 2 images of
// 1024x1344 at C=256, 117 MB in bf16: most of it); their arithmetic is a
// few fp32 operations a sample.
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

// K3 design, fp32 g. What the TPU kernel kept out of device memory was the
// traffic of the samples: it built each RoI's window gradient on chip
// (Wy^T g Wx) and added the window into the level once. Adding every
// sample's four corners into device memory with scalar fp32 atomics instead
// costs 4 S^2 P^2 L2 atomics a RoI and channel, mostly onto the same few
// cells, and those, not the bytes, would be the time. So one block takes a
// RoI and a channel slice and, after the shared set-up (during which the
// other six warps stage g / S^2 of the RoI's slice in shared memory, so the
// fold hides under that load):
//   1. pass 1 contracts x: t[p, xcell, c] = sum over the x taps on xcell of
//      wx * g[p, q, c]; pass 2 contracts y: d[ycell, xcell, c] = sum over
//      the y taps on ycell of wy * t[p, xcell, c]. Each thread owns whole
//      outputs and sums its taps in a fixed order, so there are no
//      shared-memory atomics and a RoI's own sum is deterministic;
//   2. each touched cell gets one 16-byte atomicAdd (red.global.add.v4.f32)
//      per 4 channels: a mask RoI of ~14 cells on its level issues ~15x15
//      of them per 4 channels instead of 3136 scalar adds per channel.
// Only the adds of different RoIs onto the same cell remain unordered, so
// the fp32 route is not bitwise deterministic across RoIs: the last bits of
// a cell that overlapping RoIs touch may differ between two runs. Sums are
// fp32.
//
// K3 design, bf16 g. Here the level gradients are bf16, each rounded once
// after every RoI's window is summed in fp32 (the TPU kernel rounds the
// level gradient to the features' dtype after every RoI's window: the
// port's single rounding is the more accurate of the two). Adding into fp32
// buffers, as the fp32 route does, would need a fill of 234 MB and a cast
// pass that reads it and writes 117 MB: 4x the bytes the function moves.
// So ownership is inverted, and each output cell is written once:
//   1. a pre-pass (roi_tap_bounds, one warp a RoI) runs the shared set-up
//      (roi_axis) and writes, per RoI and axis, the first and last of the
//      folded cells: the inclusive cell range of its nonzero taps (empty if
//      none). The range comes from the taps, not the box: the border rule
//      clamps a sample in [-1, 0) to cell 0 and one in (size - 1, size] to
//      cell size - 1, outside a box-based range;
//   2. one block takes a square tile of one level of one image and one
//      channel slice (8 x 8 cells and 256 channels, or 16 x 16 cells and 32
//      where a wide block's shared memory would not hold a RoI: P=14), and
//      holds the tile's gradient in fp32 registers, one row and kCols cells
//      of 8 channels a thread. It walks the RoIs of its image in ascending
//      index and lists (ballots into shared memory, in chunks) those routed
//      to its level whose ranges meet the tile, with each one's frame on
//      the level (roi_frame). It redoes the set-up of the listed RoIs for
//      the tile's columns and rows (sample_coord, bilinear: K2's own
//      arithmetic, so K3 stays K2's exact transpose), a group of RoIs side
//      by side, one warp an axis, into lists of the taps on each column or
//      row in the fold's order (i0 taps, then i1 taps, by sample). g of
//      each RoI's slice is copied in as it is by cp.async,
//      the next RoI's copy in flight while this one is contracted: pass x
//      over the tile's columns (bf16 converted as read; the x weights carry
//      the exact 1 / S^2 where S^2 is a power of two), pass y over the
//      tile's rows into the RoI's window at each owned cell, which is then
//      added to the cell's sum. Two barriers a RoI;
//   3. the tile is rounded to bf16 (nearest even) once and written with
//      16-byte stores; a tile that no RoI touches writes zeros.
// No fill, no atomics, no cast pass; each cell is summed in a fixed order,
// so the result is bitwise deterministic. A cell's window from one RoI is
// the fp32 route's, bit for bit; only the order in which RoIs add differs.
// The grid takes the coarsest level first: its few tiles gather the most
// RoIs (P5's RoIs span most of the level), and they start before the rest.
// What limits it on the H100 is not the bytes (PERF.md): a RoI on a tile is
// a chain of set-up, copy, two passes and two barriers, each a few hundred
// cycles of latency, with 16 warps an SM (128 registers a thread), and a
// RoI is taken once for every tile it meets and every channel slice; a
// block also lists its tile's RoIs before any of them, and a tile that no
// RoI meets still costs that listing.
//
// `slice` is, for each kernel, the first of its widths that divides C and
// whose shared memory lets blocks share an SM: K2 64, 32 or 4 (64 at C=256,
// P=7 and 14; 32 at the small configs' C=32; 4 divides any C the wrapper
// takes; bf16 64, 32 or 8), K3 fp32 32, 16, 8 or 4 (32 at P=7, 16 at
// P=14, with S=2), K3 bf16 narrow 32, 16 or 8 (32 at P=14).
//
// bf16 K2. K2 reads fp32 or bf16 features and computes in fp32, as the
// TPU kernel does (roi_align_pallas.py: the window's .astype(float32), the
// fp32 matmuls, the output's .astype(out_dtype)). bf16 features go through
// their own kernel, roi_align_forward_bf16_kernel: the fp32 kernel's
// set-up, taps and passes, in the same order, so a bf16 output is the fp32
// kernel's on the upcast inputs, rounded to nearest even once; a thread
// still takes 4 channels at a time (4 bf16 in 8 bytes) and converts them to
// fp32 where pass x reads them. The cells are staged as they are (a 16-byte
// cp.async carries 8 channels; cp.async cannot convert), so its slices are
// 64, 32 or 8 channels and the kernels take a bf16 C a multiple of 8 (K3
// bf16 likewise: 16-byte copies of g, 16-byte stores of 8 channels; the
// wrappers pad any other C with zero channels). Its
// design differs from the fp32 kernel's: halving the bytes left the time of
// the fp32 kernel's chain almost where it was (PERF.md), so the bf16 kernel
// is persistent and warp-specialised, the set-up and the copies of the next
// chunks running beside the passes of this one (see the kernel).

#include <cuda_bf16.h>
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

// Four channels of T, what a thread reads, contracts and writes at a time:
// a float4, or four bf16 in a uint2 (channel 0 in the low half of .x).
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 to_float4(const float4 v) { return v; }

// bf16 -> fp32 is exact: the bf16 bits are the top half of the float's.
__device__ __forceinline__ float4 to_float4(const uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float4* dst, const float4 v) { *dst = v; }

// fp32 -> bf16 rounded to nearest even, as PyTorch's .to(torch.bfloat16).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store4(uint2* dst, const float4 v) {
  *dst = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

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

// kAligned is RoIAlign's aligned: the corners x * scale - 0.5 and an extent
// of at least 0 cells, else x * scale and at least 1 cell.
template <bool kAligned>
__device__ __forceinline__ RoiFrame roi_frame(const float4 roi, float stride, int pool) {
  // Sample coordinates reach hundreds of cells, where one rounding step is
  // ~3e-5 of a cell; a fused multiply-add here would move the bilinear
  // weights by that much against the plain version. So every step is
  // rounded as the JAX and PyTorch versions round it (_rn intrinsics are
  // never contracted): the extent is (x2 * scale - 0.5) - x1 with x1 already
  // shifted, not (x2 - x1) * scale.
  const float scale = __fdiv_rn(1.0f, stride);
  RoiFrame f;
  f.x1 = __fmul_rn(roi.x, scale);
  f.y1 = __fmul_rn(roi.y, scale);
  if constexpr (kAligned) {
    f.x1 = __fsub_rn(f.x1, 0.5f);
    f.y1 = __fsub_rn(f.y1, 0.5f);
    f.bin_w = __fdiv_rn(fmaxf(__fsub_rn(__fsub_rn(__fmul_rn(roi.z, scale), 0.5f), f.x1), 0.0f),
                        static_cast<float>(pool));
    f.bin_h = __fdiv_rn(fmaxf(__fsub_rn(__fsub_rn(__fmul_rn(roi.w, scale), 0.5f), f.y1), 0.0f),
                        static_cast<float>(pool));
  } else {
    f.bin_w = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.z, scale), f.x1), 1.0f),
                        static_cast<float>(pool));
    f.bin_h = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(roi.w, scale), f.y1), 1.0f),
                        static_cast<float>(pool));
  }
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
// 1: y over its height), folded onto their distinct cells. A zero-extent
// RoI (kAligned) puts every sample on one coordinate: the fold merges their
// taps onto one or two cells.
template <bool kAligned>
__device__ void roi_axis(RoiTable& tab, const float4 roi, float stride, int size, int pool,
                         int ratio, int a, int lane) {
  const RoiFrame f = roi_frame<kAligned>(roi, stride, pool);
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

  // sum over the taps of w * v[(slot & mask) * stride] (as fp32), in tap order
  template <typename V>
  __device__ __forceinline__ float4 contract(const V* v, int stride, int mask) const {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kTaps > 0) {
#pragma unroll
      for (int e = 0; e < kTaps; ++e) {
        if (e < count) fma4(acc, to_float4(v[(tap[e].slot & mask) * stride]), tap[e].weight);
      }
    } else {
      for (int e = 0; e < count; ++e) {
        fma4(acc, to_float4(v[(shared[e].slot & mask) * stride]), shared[e].weight);
      }
    }
    return acc;
  }

  // contract, with every tap's load issued before the first sum where the
  // instance knows S: a tap past `count` loads slot 0 (a cell the stage or
  // the ring holds) and is then skipped, so the sums are contract's, in its
  // order. contract's loads sit each in its own branch, each waiting for
  // the sum before it.
  template <typename V>
  __device__ __forceinline__ float4 contract_all(const V* v, int stride, int mask) const {
    if constexpr (kTaps == 0) {
      return contract(v, stride, mask);
    } else {
      V x[kTaps];
#pragma unroll
      for (int e = 0; e < kTaps; ++e) x[e] = v[(tap[e].slot & mask) * stride];
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int e = 0; e < kTaps; ++e) {
        if (e < count) fma4(acc, to_float4(x[e]), tap[e].weight);
      }
      return acc;
    }
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

// Cells one of K2's two staging buffers holds: kFwdStageBytes of cells of
// `elem` bytes a channel, and at least one row of the widest fold (2 * P * S
// cells).
int fwd_stage_cells(int pool, int ratio, int slice, int elem) {
  return std::max(2 * pool * ratio, kFwdStageBytes / (slice * elem));
}

// Dynamic shared memory of one K2 block: the fp32 ring [rows][P][slice] and
// the two staging buffers [cells][slice] of the features' type, which the
// set-up's tables use first.
int fwd_smem_bytes(int pool, int ratio, int slice, int elem) {
  const int bytes = fwd_ring_rows(pool, ratio, slice) * pool * slice *
                        static_cast<int>(sizeof(float)) +
                    2 * fwd_stage_cells(pool, ratio, slice, elem) * slice * elem;
  return std::max(bytes, static_cast<int>(sizeof(FwdSetup)));
}

// One block per (RoI, group of `per_block` consecutive channel slices).
// T is the features' and the output's element type; kRatio is S where the
// instance is specialised for it, else 0 (S at run time); kAligned is
// roi_frame's.
template <typename T, int kSlice, int kRatio, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    roi_align_forward_kernel(Levels<const T> lv, const float4* __restrict__ rois,
                             const int* __restrict__ levels, T* __restrict__ out,
                             int rois_per_image, int channels, int pool, int ratio_arg,
                             int per_block, int ring_rows, int stage_cells) {
  using V4 = typename Vec4<T>::type;          // 4 channels of T
  constexpr int kV4 = kSlice / 4;             // 4-channel groups of a slice
  constexpr int kLanes = kThreads / kV4;      // threads on one 4-channel group
  constexpr int kCopies = kSlice * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a cell
  constexpr int kCopyLanes = kThreads / kCopies;  // threads on one copy of a cell
  constexpr int kTaps = 2 * kRatio;
  static_assert(kCopies * 16 == kSlice * static_cast<int>(sizeof(T)),
                "a slice of a cell is whole 16-byte copies");
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
    roi_axis<kAligned>(su.tab, rois[n], lv.stride[l], warp ? height : width, pool, ratio,
                       warp, lane);
    bin_taps(su, ft, warp, pool, ratio, lane);
  }
  __syncthreads();
  const int nx = ft.cells[0], ny = ft.cells[1];
  const int row4 = channels / 4;  // 4-channel groups from one output to the next
  const int c4 = t % kV4;
  const int u = t / kV4;  // this thread's place among the kLanes on its group
  V4* dst = reinterpret_cast<V4*>(out) + static_cast<size_t>(n) * pool * pool * row4 +
            first * kV4 + c4;
  if (nx == 0 || ny == 0) {  // every sample outside the level (block-uniform)
    for (int j = u; j < pool * pool * per_block; j += kLanes) {
      const int pq = j / per_block;
      store4(&dst[pq * row4 + (j - pq * per_block) * kV4], make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    return;
  }

  // 2. items (slice, chunk of y rows), in order: the distinct cells of the
  //    item staged, as they are, by 16-byte asynchronous copies, the next
  //    item's copies in flight while the current one is contracted
  const T* feat = lv.ptr[l] + static_cast<size_t>(b) * height * width * channels +
                  first * kSlice;
  float4* ring = reinterpret_cast<float4*>(fwd_smem);  // [ring_rows][pool][kV4], fp32
  // [2][stage_cells][kV4] of V4: each cell's slice is kCopies 16-byte units
  uint4* stage = reinterpret_cast<uint4*>(ring + ring_rows * pool * kV4);
  const int mask = ring_rows - 1;
  const int chunk = min(stage_cells / nx, ring_rows - 2 * ratio + 1);  // rows an item
  const int chunks = (ny + chunk - 1) / chunk;
  const int items = chunks * per_block;
  const unsigned long long by_nx = div_magic(nx);
  const unsigned long long by_pool = div_magic(pool);
  // the passes give a thread one output column q (and, where the lanes of a
  // 4-channel group outnumber the columns, every `spread`-th row of it)
  const int spread = max(1, kLanes / pool);
  const float count = static_cast<float>(ratio * ratio);
  const int cc = t % kCopies;  // this thread's 16-byte unit of a cell's slice
  const int cu = t / kCopies;
  auto load = [&](int item) {
    const int j = item / chunks;
    const int r0 = (item - j * chunks) * chunk;
    const int cells = min(chunk, ny - r0) * nx;
    const T* src = feat + j * kSlice + cc * (16 / static_cast<int>(sizeof(T)));
    uint4* buf = stage + (item & 1) * stage_cells * kCopies + cc;
    for (int e = cu; e < cells; e += kCopyLanes) {
      const int r = div_small(e, by_nx);
      const int s = e - r * nx;
      cp_async16(buf + e * kCopies,
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

    // 3. pass x: the item's rows into the ring, converted to fp32 as read
    const V4* buf = reinterpret_cast<const V4*>(stage + (item & 1) * stage_cells * kCopies) + c4;
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
    V4* dj = dst + j * kV4;
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
        store4(&dj[(p * pool + q) * row4], acc);
      }
    }
    p_done = p_end;
  }
}

// -------------------------------------------------------- K2, bf16 features

typedef unsigned long long u64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of `bar` with the given parity has completed (the
// phase before the first completes at once: parity 1 on a fresh barrier).
// The waiting thread is suspended until then, up to kWaitHintNs at a time
// (the warps that wait long are the producers, a stage or a unit ahead;
// the card's default suspend time measured the same,
// scripts/k2_ablation.py).
constexpr unsigned kWaitHintNs = 1000000;
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity), "n"(kWaitHintNs)
        : "memory");
  }
}

// An arrival on `bar` once every cp.async this thread has issued has landed
// (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(u64* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

constexpr int kBf16Consumers = 256;  // warps 0-7: the passes
constexpr int kBf16CopyWarps = 4;
constexpr int kBf16SetupWarps = 2;  // one an axis
constexpr int kBf16CopyWarp0 = kBf16Consumers / 32;  // warps 8-11
constexpr int kBf16SetupWarp0 = kBf16CopyWarp0 + kBf16CopyWarps;  // warps 12, 13
constexpr int kBf16Threads = kBf16Consumers + 32 * (kBf16CopyWarps + kBf16SetupWarps);
constexpr int kBf16Stages = 4;
constexpr int kBf16StageBytes = 16 * 1024;  // one stage, at least
constexpr int kBf16RingBytes = 32 * 1024;   // the ring, at most, where 4*S rows fit
constexpr int kBf16BlocksPerSm = 2;
constexpr int kBf16UnitsPerBlock = 4;  // a RoI's slices are split until there are this many
// dynamic bytes a block: two blocks an SM, with their static tables and the
// 1 KB each the card reserves, in the SM's 228 KB
constexpr int kBf16SmemLimit = 95 * 1024;

// What one bf16 K2 block keeps in static shared memory: the tables of the
// unit being contracted and of the next (by the parity of the unit's place
// in the block's walk), the set-up warps' working tables, and the barriers.
struct Bf16Shared {
  FwdTaps tab[2];
  FwdSetup setup;
  u64 full[kBf16Stages];   // a stage's copies landed (each copy thread's, once)
  u64 empty[kBf16Stages];  // the consumers are done with a stage
  u64 tab_full[2];         // a table is set up (each set-up thread, once)
  u64 tab_empty[2];        // the consumers and each copy warp are done with a table
};

// Rows of the bf16 kernel's ring: the largest power of two whose ring stays
// within kBf16RingBytes, and at least 4*S.
int bf16_ring_rows(int pool, int ratio, int slice) {
  int rows = 1;
  while (rows < 4 * ratio) rows *= 2;
  while (2 * rows * pool * slice * static_cast<int>(sizeof(float)) <= kBf16RingBytes) rows *= 2;
  return rows;
}

// Cells one stage holds: kBf16StageBytes of bf16 cell slices, and at least
// one row of the widest fold (2 * P * S cells).
int bf16_stage_cells(int pool, int ratio, int slice) {
  return std::max(2 * pool * ratio, kBf16StageBytes / (slice * 2));
}

// Dynamic shared memory of one bf16 block: the fp32 ring [rows][P][slice],
// then kBf16Stages stages [cells][slice] of bf16.
int bf16_smem_bytes(int pool, int ratio, int slice) {
  return bf16_ring_rows(pool, ratio, slice) * pool * slice * static_cast<int>(sizeof(float)) +
         kBf16Stages * bf16_stage_cells(pool, ratio, slice) * slice * 2;
}

// K2 for bf16 features: persistent and warp-specialised. The fp32 kernel's
// chain (set-up, copies, pass x, pass y, each behind a __syncthreads) left
// each part waiting for the one before; here the parts are roles that run
// side by side, on the same arithmetic.
//
// A unit is a RoI and `per` of its channel slices (bf16_unit_slices). The
// grid is kBf16BlocksPerSm blocks an SM (fewer if
// there are fewer units); block b walks units b, b + grid, b + 2 grid, ...
// in that fixed order: strided, so that neighbouring RoIs, which cost alike
// (a batch's proposals come sorted, the sampled RoIs grouped), spread over
// the blocks. The slices of a unit share its set-up. Roles, each a fixed
// set of warps:
//   - set-up, warps 12 and 13 (axis x, axis y): for each unit of the walk,
//     roi_axis and bin_taps into the table of the unit's parity, as soon as
//     the consumer and copy warps have released it (all of them: consumers
//     pass a RoI none of whose samples fall inside its level without
//     waiting for the copies): one unit ahead of the consumers;
//   - copies, warps 8-11: for each slice, its chunks of y rows (the chunk's
//     cells of the slice, by 16-byte cp.async, as each cell's slice is one
//     contiguous run of 2 * slice bytes in NHWC) into a ring of kBf16Stages
//     stages, each copy thread completing its arrival on the stage's full
//     mbarrier when its copies land (cp.async.mbarrier.arrive), as soon as
//     every consumer warp has released the stage. Four warps: the copies'
//     address arithmetic (two table loads a 16-byte copy) keeps fewer from
//     staying ahead of the consumers; one bulk copy a cell (cp.async.bulk)
//     was slower still (scripts/k2_ablation.py);
//   - consumers, warps 0-7: pass x of each chunk into the fp32 ring of x
//     contracted rows, then pass y of every output row whose taps have all
//     arrived, written with 8-byte stores of 4 bf16. A warp owns whole
//     output columns (all their rows), so its pass y reads only ring rows
//     its own pass x wrote: the consumer warps share no barrier, not even a
//     named one, and each releases a stage, and a table, by its own
//     arrival. A bin's loads are all issued before its sums
//     (BinTaps::contract_all).
// Every output value is summed and written by one consumer thread, in the
// fold's tap order and divided by S^2 last, in fp32 (the fp32 kernel's
// contract and BinTaps); no atomics, so the result does not depend on the
// schedule, and it is the fp32 kernel's output on the upcast features,
// rounded once.
template <int kSlice, int kRatio, bool kAligned>
__global__ void __launch_bounds__(kBf16Threads, kBf16BlocksPerSm)
    roi_align_forward_bf16_kernel(Levels<const __nv_bfloat16> lv, const float4* __restrict__ rois,
                                  const int* __restrict__ levels,
                                  __nv_bfloat16* __restrict__ out, int num_rois,
                                  int rois_per_image, int channels, int pool, int ratio_arg,
                                  int per, int ring_rows, int stage_cells) {
  using V4 = Vec4<__nv_bfloat16>::type;  // 4 bf16 channels
  constexpr int kV4 = kSlice / 4;         // 4-channel groups of a slice
  constexpr int kLanes = kBf16Consumers / kV4;  // consumers on one 4-channel group
  constexpr int kCopies = kSlice * 2 / 16;  // 16-byte copies a cell's slice
  constexpr int kTaps = 2 * kRatio;
  static_assert(kCopies * 16 == kSlice * 2, "a slice of a cell is whole 16-byte copies");
  const int ratio = kRatio > 0 ? kRatio : ratio_arg;
  extern __shared__ __align__(16) float fwd_smem[];
  __shared__ Bf16Shared sh;
  const int groups = channels / (kSlice * per);  // units a RoI
  const int units = num_rois * groups;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  float4* ring = reinterpret_cast<float4*>(fwd_smem);  // [ring_rows][pool][kV4], fp32
  // [kBf16Stages][stage_cells][kCopies] 16-byte units
  uint4* stage = reinterpret_cast<uint4*>(ring + ring_rows * pool * kV4);
  const int mask = ring_rows - 1;
  // rows a chunk takes, for a fold of nx x cells
  auto chunk_rows = [&](int nx) { return min(stage_cells / nx, ring_rows - 2 * ratio + 1); };

  if (t == 0) {
    for (int s = 0; s < kBf16Stages; ++s) {
      mbar_init(&sh.full[s], 32 * kBf16CopyWarps);
      mbar_init(&sh.empty[s], kBf16Consumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sh.tab_full[i], 32 * kBf16SetupWarps);
      mbar_init(&sh.tab_empty[i], kBf16Consumers / 32 + kBf16CopyWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the block's only __syncthreads: the barriers exist

  if (warp >= kBf16SetupWarp0) {
    // set-up: warp 12 the x axis, warp 13 the y axis, unit by unit
    const int a = warp - kBf16SetupWarp0;
    for (int unit = blockIdx.x, k = 0; unit < units; unit += gridDim.x, ++k) {
      const int n = unit / groups;
      mbar_wait(&sh.tab_empty[k & 1], ((k >> 1) & 1) ^ 1);
      const int l = levels[n];
      roi_axis<kAligned>(sh.setup.tab, rois[n], lv.stride[l], a ? lv.h[l] : lv.w[l], pool,
                         ratio, a, lane);
      bin_taps(sh.setup, sh.tab[k & 1], a, pool, ratio, lane);
      __syncwarp();
      mbar_arrive(&sh.tab_full[k & 1]);
    }
    return;
  }

  if (warp >= kBf16CopyWarp0) {
    // copies: every slice's chunks, stage after stage
    const int ct = t - kBf16Consumers;  // this thread's place among the copy threads
    int seq = 0;
    for (int unit = blockIdx.x, k = 0; unit < units; unit += gridDim.x, ++k) {
      const int n = unit / groups;
      mbar_wait(&sh.tab_full[k & 1], (k >> 1) & 1);
      const FwdTaps& ft = sh.tab[k & 1];
      const int nx = ft.cells[0], ny = ft.cells[1];
      if (nx > 0 && ny > 0) {  // else every sample is outside the level: no copies
        const int chunk = chunk_rows(nx);
        const int l = levels[n];
        const int width = lv.w[l];
        const unsigned long long by_nx = div_magic(nx);
        const __nv_bfloat16* feat =
            lv.ptr[l] + static_cast<size_t>(n / rois_per_image) * lv.h[l] * width * channels +
            (unit - n * groups) * per * kSlice;
        for (int j = 0; j < per; ++j) {
          for (int r0 = 0; r0 < ny; r0 += chunk, ++seq) {
            const int s = seq % kBf16Stages;
            mbar_wait(&sh.empty[s], ((seq / kBf16Stages) & 1) ^ 1);
            uint4* buf = stage + s * stage_cells * kCopies;
            const int copies = min(chunk, ny - r0) * nx * kCopies;
#pragma unroll 4
            for (int e = ct; e < copies; e += 32 * kBf16CopyWarps) {
              const int cell = e / kCopies;
              const int r = div_small(cell, by_nx);
              const int x = cell - r * nx;
              cp_async16(buf + e, feat + (static_cast<size_t>(ft.cell[1][r0 + r]) * width +
                                          ft.cell[0][x]) * channels +
                                      j * kSlice + (e - cell * kCopies) * 8);
            }
            cp_async_arrive(&sh.full[s]);
          }
        }
      }
      __syncwarp();  // the warp is done with the unit's table
      if (lane == 0) mbar_arrive(&sh.tab_empty[k & 1]);
    }
    return;  // the consumers wait for every copy before the block ends
  }

  // consumers: the passes, slice by slice. Thread (u, c4) takes 4 channels
  // of output column q and every `spread`-th row from g, for (q, g) = (e /
  // spread, e % spread), e = u, u + kLanes, ...: spread is a power of two
  // that divides the kWarpLanes values of u a warp holds, so each column's
  // rows lie in one warp, and a warp's pass y reads only the ring rows its
  // own pass x wrote. The warps then need no barrier among themselves: each
  // releases a stage, and a table, by its own arrival.
  constexpr int kWarpLanes = 32 / kV4;
  const int row4 = channels / 4;  // 4-channel groups from one output to the next
  const int c4 = t % kV4;
  const int u = t / kV4;  // this thread's place among the kLanes on its group
  int shift = 0;  // log2(spread)
  while (2 << shift <= kWarpLanes && (2 << shift) * pool <= kLanes) ++shift;
  const int spread = 1 << shift;
  const float count = static_cast<float>(ratio * ratio);
  int seq = 0;
  for (int unit = blockIdx.x, k = 0; unit < units; unit += gridDim.x, ++k) {
    const int n = unit / groups;
    mbar_wait(&sh.tab_full[k & 1], (k >> 1) & 1);
    const FwdTaps& ft = sh.tab[k & 1];
    const int nx = ft.cells[0], ny = ft.cells[1];
    for (int j = 0; j < per; ++j) {
      V4* dst = reinterpret_cast<V4*>(out) + static_cast<size_t>(n) * pool * pool * row4 +
                ((unit - n * groups) * per + j) * kV4 + c4;
      if (nx == 0 || ny == 0) {  // every sample outside the level
        for (int pq = u; pq < pool * pool; pq += kLanes) {
          store4(&dst[pq * row4], make_float4(0.0f, 0.0f, 0.0f, 0.0f));
        }
        continue;
      }
      const int chunk = chunk_rows(nx);
      int p_done = 0;  // output rows of the slice written
      for (int r0 = 0; r0 < ny; r0 += chunk, ++seq) {
        const int s = seq % kBf16Stages;
        const int rows = min(chunk, ny - r0);
        mbar_wait(&sh.full[s], (seq / kBf16Stages) & 1);
        // pass x: the chunk's rows into the ring, converted to fp32 as read
        const V4* buf = reinterpret_cast<const V4*>(stage + s * stage_cells * kCopies) + c4;
        for (int e = u; e < pool * spread; e += kLanes) {
          const int q = e >> shift;
          const BinTaps<kTaps> taps(&ft.tap[0][q * 2 * ratio], ft.count[0][q]);
          for (int r = e & (spread - 1); r < rows; r += spread) {
            ring[(((r0 + r) & mask) * pool + q) * kV4 + c4] =
                taps.contract_all(buf + r * nx * kV4, kV4, -1);
          }
        }
        __syncwarp();  // the warp's ring rows are written; it is done with the stage
        if (lane == 0) mbar_arrive(&sh.empty[s]);
        // pass y: every output row whose taps all lie in rows already contracted
        int p_end = p_done;
        while (p_end < pool && ft.last_row[p_end] < r0 + rows) ++p_end;
        for (int e = u; e < pool * spread; e += kLanes) {
          const int q = e >> shift;
          for (int p = p_done + (e & (spread - 1)); p < p_end; p += spread) {
            const BinTaps<kTaps> taps(&ft.tap[1][p * 2 * ratio], ft.count[1][p]);
            const float4 a = taps.contract_all(ring + q * kV4 + c4, pool * kV4, mask);
            store4(&dst[(p * pool + q) * row4],
                   make_float4(a.x / count, a.y / count, a.z / count, a.w / count));
          }
        }
        p_done = p_end;
        __syncwarp();  // pass y no longer reads the warp's ring rows
      }
    }
    __syncwarp();  // the warp is done with the unit's table
    if (lane == 0) mbar_arrive(&sh.tab_empty[k & 1]);
  }
}

// ------------------------------------------------------------------- K3

// Dynamic shared memory of one K3 block: g of the RoI's slice [P*P, slice]
// and the x-contracted t [P, 2*P*S, slice], fp32.
int bwd_smem_bytes(int pool, int ratio, int slice) {
  return (pool * pool + pool * 2 * pool * ratio) * slice * static_cast<int>(sizeof(float));
}

// The fp32 route: the upstream gradient and the level gradients are fp32.
template <int kSlice, bool kAligned>
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
    roi_axis<kAligned>(tab, rois[n], lv.stride[l], warp ? height : width, pool, ratio, warp,
                       lane);
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

// ------------------------------------------------------------ K3, bf16 g

constexpr int kListCap = 512;    // RoIs a tile block lists at a time
constexpr int kBoundsWarps = 4;  // RoIs a pre-pass block takes, one a warp
// The tile blocks' two shapes. A wide block takes kWideTile x kWideTile
// cells and kWideSlice channels with 512 threads, one block an SM; a narrow
// one kTile x kTile cells and a 32-, 16- or 8-channel slice with kThreads,
// two blocks an SM. The wide shape meets a RoI on fewer (tile, slice) pairs
// (each pair is a set-up, a copy, two passes and two barriers), but holds
// all of a RoI's g and its x-contraction: it is taken where they fit (C a
// multiple of 256, P=7 at S=2), else the narrow one (P=14).
constexpr int kTile = 16;
constexpr int kWideTile = 8;
constexpr int kWideSlice = 256;
constexpr int kWideSmemLimit = 192 * 1024;  // dynamic bytes a wide block
constexpr int kTileSmemLimit = 100 * 1024;  // dynamic bytes a narrow block: two fit on an SM

// The pre-pass, one warp a RoI: the set-up of roi_axis along x, then y, and
// the first and last folded cell of each axis, (x first, x last, y first,
// y last), where an axis with no nonzero tap gives (0, -1). The range comes
// from the fold of the samples, so that with kAligned it holds the shifted
// ones (a sample in [-1, 0) still touches cell 0).
template <bool kAligned>
__global__ void __launch_bounds__(32 * kBoundsWarps)
    roi_tap_bounds_kernel(Levels<__nv_bfloat16> lv, const float4* __restrict__ rois,
                          const int* __restrict__ levels, int4* __restrict__ bounds,
                          int num_rois, int pool, int ratio) {
  __shared__ RoiTable tabs[kBoundsWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kBoundsWarps + warp;
  if (n >= num_rois) return;  // warp-uniform; the warps share no barrier
  RoiTable& tab = tabs[warp];
  const int l = levels[n];
  int first[2], last[2];
  for (int a = 0; a < 2; ++a) {
    roi_axis<kAligned>(tab, rois[n], lv.stride[l], a ? lv.h[l] : lv.w[l], pool, ratio, a,
                       lane);
    const AxisTaps& ax = tab.axis[a];
    first[a] = ax.count ? ax.cell[0] : 0;
    last[a] = ax.count ? ax.cell[ax.count - 1] : -1;
  }
  if (lane == 0) bounds[n] = make_int4(first[0], last[0], first[1], last[1]);
}

// A tap of one sample on a cell of the tile: the sample's output bin and
// its weight.
struct __align__(8) BinTap {
  int bin;
  float weight;
};

// One RoI's taps on a tile, per axis a (0: the tile's columns, 1: its
// rows), as lists by cell: the taps on the tile's cell j are
// tap[a][start[a][j]..start[a][j + 1] - 1], in the fold's order (the i0 taps
// by sample, then the i1 taps); cells lo[a]..hi[a] are those with taps
// (none: hi < lo). mask[a][e][j] has bit k set where tap e (0: i0, 1: i1) of
// sample k lands on cell j, the lists' ranks.
template <int kTileN>
struct TileTaps {
  unsigned long long mask[2][2][kTileN];
  int start[2][kTileN + 1];
  BinTap tap[2][2 * kMaxSamples];
  int lo[2], hi[2];
};

// Warp `a` of a tile block: the P*S samples along axis a of a RoI whose
// frame on the level is `f` (K2's arithmetic), and the lists of their
// nonzero taps on the tile's cells origin..origin + kTileN - 1, the weights
// times `scale`. A sample's taps are found on their cells with one match a
// tap and sweep of 32 samples, counted into the lists' starts by a scan
// over the cells, and put into place by their rank among their cell's
// taps.
template <int kTileN>
__device__ void tile_axis(TileTaps<kTileN>& tt, const RoiFrame f, int size, int pool, int ratio,
                          int a, int origin, float scale, int lane) {
  const unsigned full = 0xffffffffu;
  const int samples = pool * ratio;
  if (lane < kTileN) {
    tt.mask[a][0][lane] = 0ull;
    tt.mask[a][1][lane] = 0ull;
  }
  __syncwarp();
  int cell[2][2];  // [sweep][tap]: the tile's cell of each tap of the lane's samples, or -1
  float w[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = h * 32 + lane;
    cell[h][0] = cell[h][1] = -1;
    w[h][0] = w[h][1] = 0.0f;
    if (k < samples) {
      int i[2];
      bilinear(sample_coord(a ? f.y1 : f.x1, a ? f.bin_h : f.bin_w, k, ratio), size, &i[0],
               &i[1], &w[h][0], &w[h][1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (w[h][e] != 0.0f && i[e] >= origin && i[e] < origin + kTileN) {
          cell[h][e] = i[e] - origin;
        }
      }
    }
    if (h * 32 < samples) {  // warp-uniform
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned same = __match_any_sync(full, cell[h][e]);
        if (cell[h][e] >= 0 && lane == __ffs(same) - 1) {
          tt.mask[a][e][cell[h][e]] |= static_cast<unsigned long long>(same) << (h * 32);
        }
      }
      __syncwarp();
    }
  }
  const int count =
      lane < kTileN ? __popcll(tt.mask[a][0][lane]) + __popcll(tt.mask[a][1][lane]) : 0;
  int end = count;  // inclusive scan over the cells
#pragma unroll
  for (int d = 1; d < kTileN; d <<= 1) {
    const int v = __shfl_up_sync(full, end, d);
    if (lane >= d) end += v;
  }
  if (lane < kTileN) tt.start[a][lane + 1] = end;
  if (lane == 0) tt.start[a][0] = 0;
  const unsigned hit = __ballot_sync(full, count > 0);
  if (lane == 0) {
    tt.lo[a] = hit ? __ffs(hit) - 1 : 0;
    tt.hi[a] = hit ? 31 - __clz(hit) : -1;
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = h * 32 + lane;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = cell[h][e];
      if (j >= 0) {
        const int at = tt.start[a][j] + (e ? __popcll(tt.mask[a][0][j]) : 0) +
                       __popcll(tt.mask[a][e][j] & ((1ull << k) - 1));
        tt.tap[a][at] = BinTap{k / ratio, w[h][e] * scale};
      }
    }
  }
}

// The tile blocks' grid, coarsest level first: entry i of the launch order
// is level level[i], its blocks first[i]..first[i + 1] - 1, laid out as
// (image, tile row, tile column, slice), the slice fastest.
struct TileGrid {
  int first[kMaxLevels + 1];
  int level[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tiles_y[kMaxLevels];
};

// The float4s of t a bin p: the tile's columns, 8 channels of the slice
// as two float4s [2][tile][slice / 8], and 4 more, so that the threads of
// pass x, which differ in p, store into different banks.
__host__ __device__ constexpr int tile_t_stride(int tile, int slice) {
  return 2 * tile * (slice / 8) + 4;
}

// Dynamic shared memory of one tile block: g of a RoI's slice as it is,
// double-buffered [2][P*P][slice] bf16, and the x-contracted t
// [P][tile_t_stride] float4.
int tile_smem_bytes(int tile, int pool, int slice) {
  return 2 * pool * pool * slice * static_cast<int>(sizeof(__nv_bfloat16)) +
         pool * tile_t_stride(tile, slice) * static_cast<int>(sizeof(float4));
}

// 8 bf16 channels of g in fp32, divided by `count` (S^2) unless the x taps'
// weights carry 1 / S^2 already.
__device__ __forceinline__ void unpack8(const uint4 v, float count, bool divide, float4* lo,
                                        float4* hi) {
  *lo = to_float4(make_uint2(v.x, v.y));
  *hi = to_float4(make_uint2(v.z, v.w));
  if (divide) {
    float* x = reinterpret_cast<float*>(lo);
    float* y = reinterpret_cast<float*>(hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = __fdiv_rn(x[e], count);
      y[e] = __fdiv_rn(y[e], count);
    }
  }
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// One block per (level, image, kTileN x kTileN tile, slice of kSlice
// channels), of kBlock threads: the tile's bf16 gradient, summed over the
// RoIs of its image routed to its level whose bounds meet it, in ascending
// order.
template <int kTileN, int kSlice, int kBlock, int kMinBlocks, bool kAligned>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    roi_align_backward_tiles_kernel(Levels<__nv_bfloat16> lv, TileGrid grid,
                                    const float4* __restrict__ rois,
                                    const int* __restrict__ levels,
                                    const int4* __restrict__ bounds,
                                    const __nv_bfloat16* __restrict__ grad_out,
                                    int rois_per_image, int channels, int pool, int ratio) {
  constexpr int kSweep = kListCap / kBlock;    // RoIs a thread tests a sweep
  constexpr int kV8 = kSlice / 8;              // 8-channel groups of the slice
  constexpr int kLanes = kBlock / kV8;         // threads on one 8-channel group
  constexpr int kColLanes = kLanes / kTileN;   // threads on one row of the tile
  constexpr int kCols = kTileN / kColLanes;    // cells a thread owns along its row
  constexpr int kStride = tile_t_stride(kTileN, kSlice);
  constexpr int kWarps = kBlock / 32;
  constexpr int kGroup = kWarps / 2;           // RoIs set up side by side, one warp an axis
  static_assert(kLanes % kTileN == 0 && kColLanes <= kTileN, "a thread owns cells of one row");
  extern __shared__ __align__(16) float tile_smem[];
  __shared__ TileTaps<kTileN> taps[kGroup];  // the taps of a group of listed RoIs
  __shared__ int list[kListCap];
  __shared__ RoiFrame frames[kListCap];  // each listed RoI's frame on the level
  __shared__ int warp_hits[kSweep][kWarps];

  // the block's level, image, tile and slice
  int i = 0;
  while (static_cast<int>(blockIdx.x) >= grid.first[i + 1]) ++i;
  const int l = grid.level[i];
  int rest = blockIdx.x - grid.first[i];
  const int c0 = rest % (channels / kSlice) * kSlice;
  rest /= channels / kSlice;
  const int tx0 = rest % grid.tiles_x[i] * kTileN;
  rest /= grid.tiles_x[i];
  const int ty0 = rest % grid.tiles_y[i] * kTileN;
  const int b = rest / grid.tiles_y[i];
  const int height = lv.h[l], width = lv.w[l];
  const float stride = lv.stride[l];

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int c8 = t % kV8;               // this thread's 8 channels of the slice
  const int row = t / kV8 / kColLanes;  // its row of the tile
  const int col = t / kV8 % kColLanes;  // its first column; then every kColLanes-th

  const int span = pool * pool * kV8;  // 16-byte units of one RoI's slice of g
  uint4* raw = reinterpret_cast<uint4*>(tile_smem);        // [2][P*P][kV8], bf16
  float4* tx = reinterpret_cast<float4*>(raw + 2 * span);  // [P][kStride], fp32
  const unsigned long long by_pool = div_magic(pool);
  // g / S^2 as the fp32 route stages it: where S^2 is a power of two, the
  // x weights carry the exact 1 / S^2 instead (the same products); else
  // pass x divides g
  const float count = static_cast<float>(ratio * ratio);
  const bool divide = (ratio & (ratio - 1)) != 0;
  const float scale = divide ? 1.0f : 1.0f / count;
  const size_t image = static_cast<size_t>(b) * rois_per_image;

  // the copies of RoI r's slice of g into buffer `buf`, one group
  auto load = [&](int r, int buf) {
    const __nv_bfloat16* src = grad_out + (image + r) * pool * pool * channels + c0;
    uint4* dst = raw + buf * span;
    for (int e = t; e < span; e += kBlock) {
      cp_async16(dst + e, src + static_cast<size_t>(e / kV8) * channels + e % kV8 * 8);
    }
    cp_async_commit();
  };

  float4 acc[kCols][2];  // the owned cells' sums: channels 0-3 and 4-7 of c8
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    acc[k][0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    acc[k][1] = acc[k][0];
  }

  for (int next = 0;;) {
    // 1. list the next RoIs routed here whose bounds meet the tile, in
    //    ascending order, kSweep * kBlock a sweep (RoI next + s * kBlock
    //    + t is thread t's s-th)
    int listed = 0;
    while (next < rois_per_image && listed <= kListCap - kSweep * kBlock) {
      int lvl[kSweep];
      int4 v[kSweep];
#pragma unroll
      for (int s = 0; s < kSweep; ++s) {
        const int r = next + s * kBlock + t;
        lvl[s] = r < rois_per_image ? levels[image + r] : -1;
        if (r < rois_per_image) v[s] = bounds[image + r];
      }
      bool hit[kSweep];
      unsigned m[kSweep];
#pragma unroll
      for (int s = 0; s < kSweep; ++s) {
        hit[s] = lvl[s] == l && v[s].x <= tx0 + kTileN - 1 && v[s].y >= tx0 &&
                 v[s].z <= ty0 + kTileN - 1 && v[s].w >= ty0;
        m[s] = __ballot_sync(0xffffffffu, hit[s]);
        if (lane == 0) warp_hits[s][warp] = __popc(m[s]);
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSweep; ++s) {
        int at = listed;
        for (int w = 0; w < kWarps; ++w) {
          const int h = warp_hits[s][w];
          at += w < warp ? h : 0;
          listed += h;
        }
        if (hit[s]) {
          const int r = next + s * kBlock + t;
          at += __popc(m[s] & ((1u << lane) - 1));
          list[at] = r;
          frames[at] = roi_frame<kAligned>(rois[image + r], stride, pool);
        }
      }
      next += kSweep * kBlock;
      __syncthreads();  // the list is written; warp_hits is free again
    }

    // 2. the listed RoIs in groups of kGroup: the group's set-ups side by
    //    side, warp w on axis w % 2 of the group's RoI w / 2; then each RoI
    //    in turn, its copies one RoI ahead
    if (listed > 0) load(list[0], 0);
    for (int j = 0; j < listed; ++j) {
      const int cur = j & 1;
      const int in_group = j % kGroup;
      if (in_group == 0) {
        __syncthreads();  // the last group's pass y no longer reads its taps
        if (warp < 2 * min(kGroup, listed - j)) {
          const int a = warp % 2;
          tile_axis(taps[warp / 2], frames[j + warp / 2], a ? height : width, pool, ratio, a,
                    a ? ty0 : tx0, a ? 1.0f : scale, lane);
        }
      }
      if (j + 1 < listed) {
        load(list[j + 1], cur ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // RoI j's g has landed and its taps are set; pass y of j - 1 is done
      const TileTaps<kTileN>& tt = taps[in_group];
      const uint4* gj = raw + cur * span;

      //    pass x: t[p, x, c] = sum over the x taps on the tile's column x of
      //    w * g[p, q, c] / S^2, for the columns with taps
      const int x_lo = tt.lo[0], x_hi = tt.hi[0];
      for (int e = t; e < (x_hi - x_lo + 1) * pool * kV8; e += kBlock) {
        const int q = e / kV8;
        const int jj = div_small(q, by_pool);
        const int p = q - jj * pool;
        const int x = x_lo + jj;
        const int c = e % kV8;
        float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
        for (int i = tt.start[0][x]; i < tt.start[0][x + 1]; ++i) {
          const BinTap tap = tt.tap[0][i];
          float4 a, a2;
          unpack8(gj[(p * pool + tap.bin) * kV8 + c], count, divide, &a, &a2);
          fma4(lo, a, tap.weight);
          fma4(hi, a2, tap.weight);
        }
        tx[p * kStride + x * kV8 + c] = lo;
        tx[p * kStride + (kTileN + x) * kV8 + c] = hi;
      }
      __syncthreads();  // t is complete


      //    pass y: the RoI's window at each owned cell, sum over the y taps
      //    on the thread's row of w * t[p, x, c], added to the cell's sum
      if (row >= tt.lo[1] && row <= tt.hi[1]) {
        float4 d[kCols][2];
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          d[k][0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          d[k][1] = d[k][0];
        }
        for (int i = tt.start[1][row]; i < tt.start[1][row + 1]; ++i) {
          const BinTap tap = tt.tap[1][i];
          const float4* src = tx + tap.bin * kStride + col * kV8 + c8;
#pragma unroll
          for (int kk = 0; kk < kCols; ++kk) {
            fma4(d[kk][0], src[kk * kColLanes * kV8], tap.weight);
            fma4(d[kk][1], src[(kTileN + kk * kColLanes) * kV8], tap.weight);
          }
        }
#pragma unroll
        for (int kk = 0; kk < kCols; ++kk) {
          const int x = col + kk * kColLanes;
          if (x >= x_lo && x <= x_hi) {
            add4(acc[kk][0], d[kk][0]);
            add4(acc[kk][1], d[kk][1]);
          }
        }
      }
    }
    if (next >= rois_per_image) break;
  }

  // 3. the tile, rounded to bf16 once, 8 channels a 16-byte store
  const int y = ty0 + row;
  if (y >= height) return;
  __nv_bfloat16* out = lv.ptr[l] + (static_cast<size_t>(b) * height + y) * width * channels +
                       c0 + c8 * 8;
#pragma unroll
  for (int kk = 0; kk < kCols; ++kk) {
    const int x = tx0 + col + kk * kColLanes;
    if (x < width) {
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(x) * channels) = make_uint4(
          pack_bf16x2(acc[kk][0].x, acc[kk][0].y), pack_bf16x2(acc[kk][0].z, acc[kk][0].w),
          pack_bf16x2(acc[kk][1].x, acc[kk][1].y), pack_bf16x2(acc[kk][1].z, acc[kk][1].w));
    }
  }
}

// ------------------------------------------------------------ wide route
//
// The instances above hold a RoI's per-axis tables (samples, folds, taps)
// in static shared memory sized by kMaxSamples, its levels in a by-value
// table of kMaxLevels, and K3 stages a RoI's whole g (P*P cells) in shared
// memory: they take P*S <= 64, at most 8 levels, and what their shared
// memory holds (K3 fp32 at P=56, S=2 would need 250 KB). Every other input
// the JAX function takes goes through these kernels, which keep no table
// at all: a thread owns one output value's 4 channels (K2) or one upstream
// gradient value's 4 channels (K3), computes its bin's samples where it
// needs them (roi_frame, sample_coord, bilinear: the same arithmetic), and
// finds its level in a table in device memory of any length. K2's sums
// are the narrow kernels' in their order (per y tap, the x taps of the bin
// in sample order, i0 before i1, zero weights skipped; then / S^2), so a
// value equals theirs bit for bit; K3 adds each sample's four corner
// contributions, g / S^2 * (wy * wx) as the plain version forms them, into
// fp32 level gradients with 16-byte atomics. What bounds them is neither
// bytes nor operations but the gather (K2 reads (2S)^2 cells an output,
// from L1 and L2) and the atomics (K3); no configuration in configs/ takes
// this route.

// The level table: [4][num_levels] int64, rows pointer, height, width and
// the stride's float bits.
struct WideLevel {
  const void* ptr;
  int h, w;
  float stride;
};

__device__ __forceinline__ WideLevel wide_level(const long long* __restrict__ table,
                                                int num_levels, int l) {
  WideLevel lv;
  lv.ptr = reinterpret_cast<const void*>(table[l]);
  lv.h = static_cast<int>(table[num_levels + l]);
  lv.w = static_cast<int>(table[2 * num_levels + l]);
  lv.stride = __int_as_float(static_cast<int>(table[3 * num_levels + l]));
  return lv;
}

// Output value (n, p, q, c4) of every thread, over the whole batch.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    roi_align_forward_wide_kernel(const long long* __restrict__ table, int num_levels,
                                  const float4* __restrict__ rois,
                                  const int* __restrict__ levels, T* __restrict__ out,
                                  long long total, int rois_per_image, int channels, int pool,
                                  int ratio) {
  using V4 = typename Vec4<T>::type;
  const int row4 = channels / 4;
  const float count = static_cast<float>(ratio * ratio);
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c4 = static_cast<int>(e % row4);
    const long long pq = e / row4;
    const int q = static_cast<int>(pq % pool);
    const int p = static_cast<int>(pq / pool % pool);
    const long long n = pq / pool / pool;
    const WideLevel lv = wide_level(table, num_levels, levels[n]);
    const RoiFrame f = roi_frame<kAligned>(rois[n], lv.stride, pool);
    const V4* feat = reinterpret_cast<const V4*>(static_cast<const T*>(lv.ptr) +
                                                 static_cast<size_t>(n / rois_per_image) * lv.h *
                                                     lv.w * channels) +
                     c4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int ky = p * ratio; ky < (p + 1) * ratio; ++ky) {
      int y[2];
      float wy[2];
      bilinear(sample_coord(f.y1, f.bin_h, ky, ratio), lv.h, &y[0], &y[1], &wy[0], &wy[1]);
      for (int ey = 0; ey < 2; ++ey) {
        if (wy[ey] == 0.0f) continue;
        const V4* line = feat + static_cast<size_t>(y[ey]) * lv.w * row4;
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int kx = q * ratio; kx < (q + 1) * ratio; ++kx) {
          int x0, x1;
          float wx0, wx1;
          bilinear(sample_coord(f.x1, f.bin_w, kx, ratio), lv.w, &x0, &x1, &wx0, &wx1);
          if (wx0 != 0.0f) fma4(t, to_float4(line[static_cast<size_t>(x0) * row4]), wx0);
          if (wx1 != 0.0f) fma4(t, to_float4(line[static_cast<size_t>(x1) * row4]), wx1);
        }
        fma4(acc, t, wy[ey]);
      }
    }
    store4(reinterpret_cast<V4*>(out) + e,
           make_float4(acc.x / count, acc.y / count, acc.z / count, acc.w / count));
  }
}

// Upstream gradient value (n, p, q, c4) of every thread: its S x S samples'
// corner contributions added into the fp32 level gradients of `table`.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    roi_align_backward_wide_kernel(const long long* __restrict__ table, int num_levels,
                                   const float4* __restrict__ rois,
                                   const int* __restrict__ levels,
                                   const T* __restrict__ grad_out, long long total,
                                   int rois_per_image, int channels, int pool, int ratio) {
  using V4 = typename Vec4<T>::type;
  const int row4 = channels / 4;
  const float count = static_cast<float>(ratio * ratio);
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c4 = static_cast<int>(e % row4);
    const long long pq = e / row4;
    const int q = static_cast<int>(pq % pool);
    const int p = static_cast<int>(pq / pool % pool);
    const long long n = pq / pool / pool;
    const WideLevel lv = wide_level(table, num_levels, levels[n]);
    const RoiFrame f = roi_frame<kAligned>(rois[n], lv.stride, pool);
    float4 g = to_float4(reinterpret_cast<const V4*>(grad_out)[e]);
    g = make_float4(g.x / count, g.y / count, g.z / count, g.w / count);
    float4* grad = reinterpret_cast<float4*>(
                       static_cast<float*>(const_cast<void*>(lv.ptr)) +
                       static_cast<size_t>(n / rois_per_image) * lv.h * lv.w * channels) +
                   c4;
    for (int ky = p * ratio; ky < (p + 1) * ratio; ++ky) {
      int y[2];
      float wy[2];
      bilinear(sample_coord(f.y1, f.bin_h, ky, ratio), lv.h, &y[0], &y[1], &wy[0], &wy[1]);
      for (int kx = q * ratio; kx < (q + 1) * ratio; ++kx) {
        int x[2];
        float wx[2];
        bilinear(sample_coord(f.x1, f.bin_w, kx, ratio), lv.w, &x[0], &x[1], &wx[0], &wx[1]);
        for (int ey = 0; ey < 2; ++ey) {
          for (int ex = 0; ex < 2; ++ex) {
            const float w = __fmul_rn(wy[ey], wx[ex]);
            if (w == 0.0f) continue;
            atomicAdd(grad + (static_cast<size_t>(y[ey]) * lv.w + x[ex]) * row4,
                      make_float4(__fmul_rn(g.x, w), __fmul_rn(g.y, w), __fmul_rn(g.z, w),
                                  __fmul_rn(g.w, w)));
          }
        }
      }
    }
  }
}

// K3 bf16's pre-pass for the wide route, one warp a RoI: the first and last
// cell of each axis's nonzero taps, as roi_tap_bounds_kernel gives them,
// from a min and a max over the warp.
template <bool kAligned>
__global__ void __launch_bounds__(32 * kBoundsWarps)
    roi_tap_bounds_wide_kernel(const long long* __restrict__ table, int num_levels,
                               const float4* __restrict__ rois,
                               const int* __restrict__ levels, int4* __restrict__ bounds,
                               int num_rois, int pool, int ratio) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kBoundsWarps + threadIdx.x / 32;
  if (n >= num_rois) return;  // warp-uniform
  const WideLevel lv = wide_level(table, num_levels, levels[n]);
  const RoiFrame f = roi_frame<kAligned>(rois[n], lv.stride, pool);
  const int samples = pool * ratio;
  int first[2], last[2];
  for (int a = 0; a < 2; ++a) {
    int lo = 0x7fffffff, hi = -1;
    for (int k = lane; k < samples; k += 32) {
      int i0, i1;
      float w0, w1;
      bilinear(sample_coord(a ? f.y1 : f.x1, a ? f.bin_h : f.bin_w, k, ratio),
               a ? lv.h : lv.w, &i0, &i1, &w0, &w1);
      if (w0 != 0.0f) {
        lo = min(lo, i0);
        hi = max(hi, i0);
      }
      if (w1 != 0.0f) {
        lo = min(lo, i1);
        hi = max(hi, i1);
      }
    }
    hi = __reduce_max_sync(full, hi);
    lo = __reduce_min_sync(full, lo);
    first[a] = hi < 0 ? 0 : lo;
    last[a] = hi;
  }
  if (lane == 0) bounds[n] = make_int4(first[0], last[0], first[1], last[1]);
}

// fp32 -> bf16, nearest even, 4 values a thread.
__global__ void __launch_bounds__(kThreads)
    cast_bf16_kernel(const float4* __restrict__ src, uint2* __restrict__ dst, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    store4(dst + i, src[i]);
  }
}

// Blocks of a grid-stride launch over `total` items: enough to fill the
// card several times over, within gridDim.x.
unsigned wide_blocks(long long total) {
  return static_cast<unsigned>(std::max(1ll, std::min((total + kThreads - 1) / kThreads,
                                                      static_cast<long long>(1) << 20)));
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

template <typename T, int kSlice, int kRatio, bool kAligned>
cudaError_t launch_fwd(const Levels<const T>& lv, const void* rois, const void* levels,
                       void* out, int num_rois, int rois_per_image, int channels, int pool,
                       int ratio, cudaStream_t stream) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  constexpr int kElem = static_cast<int>(sizeof(T));
  cudaError_t err =
      allow_smem(roi_align_forward_kernel<T, kSlice, kRatio, kAligned>, kFwdSmemLimit, &mu, done);
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
  roi_align_forward_kernel<T, kSlice, kRatio, kAligned>
      <<<num_rois * (slices / per_block), kThreads, fwd_smem_bytes(pool, ratio, kSlice, kElem),
         stream>>>(lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
                   static_cast<T*>(out), rois_per_image, channels, pool, ratio, per_block,
                   fwd_ring_rows(pool, ratio, kSlice),
                   fwd_stage_cells(pool, ratio, kSlice, kElem));
  return cudaGetLastError();
}

// K2 at slice width kSlice, with the instance specialised for S = 2 (the
// model's sampling ratio) where it applies.
template <typename T, int kSlice, bool kAligned>
cudaError_t launch_fwd_slice(const Levels<const T>& lv, const void* rois, const void* levels,
                             void* out, int num_rois, int rois_per_image, int channels,
                             int pool, int ratio, cudaStream_t stream) {
  return ratio == 2 ? launch_fwd<T, kSlice, 2, kAligned>(lv, rois, levels, out, num_rois,
                                                         rois_per_image, channels, pool, ratio,
                                                         stream)
                    : launch_fwd<T, kSlice, 0, kAligned>(lv, rois, levels, out, num_rois,
                                                         rois_per_image, channels, pool, ratio,
                                                         stream);
}

// K2 for features of type T at the first slice width of kWidths (64, 32,
// then 4 for fp32 or 8 for bf16: whole 16-byte copies) that divides C and
// fits kFwdSmemLimit.
template <typename T, int kNarrow, bool kAligned>
int forward_entry(const void* const* feats, const int* heights, const int* widths,
                  const float* strides, int num_levels, const void* rois, const void* levels,
                  void* out, int num_rois, int rois_per_image, int channels, int pool,
                  int ratio, void* stream) {
  if (bad_args(num_levels, pool, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois <= 0 || channels <= 0) return 0;
  Levels<const T> lv = {};
  fill_levels(&lv, feats, heights, widths, strides, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto bytes = [](int p, int r, int slice) {
    return fwd_smem_bytes(p, r, slice, static_cast<int>(sizeof(T)));
  };
  switch (pick_slice({64, 32, kNarrow}, channels, pool, ratio, kFwdSmemLimit, bytes)) {
    case 64:
      return static_cast<int>(launch_fwd_slice<T, 64, kAligned>(
          lv, rois, levels, out, num_rois, rois_per_image, channels, pool, ratio, s));
    case 32:
      return static_cast<int>(launch_fwd_slice<T, 32, kAligned>(
          lv, rois, levels, out, num_rois, rois_per_image, channels, pool, ratio, s));
    case kNarrow:
      return static_cast<int>(launch_fwd_slice<T, kNarrow, kAligned>(
          lv, rois, levels, out, num_rois, rois_per_image, channels, pool, ratio, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The slices of a bf16 unit: all of a RoI's, halved (while they divide)
// until there are kBf16UnitsPerBlock units a block. Smaller units share a
// RoI's set-up less but even out the walks: RoIs differ in cost, a walk
// takes whole units, and the kernel lasts as long as its longest walk.
int bf16_unit_slices(int num_rois, int slices, int blocks) {
  int per = slices;
  while (per % 2 == 0 &&
         static_cast<long long>(num_rois) * (slices / per) < kBf16UnitsPerBlock * blocks) {
    per /= 2;
  }
  return per;
}

template <int kSlice, int kRatio, bool kAligned>
cudaError_t launch_fwd_bf16(const Levels<const __nv_bfloat16>& lv, const void* rois,
                            const void* levels, void* out, int num_rois, int rois_per_image,
                            int channels, int pool, int ratio, cudaStream_t stream) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  const auto kernel = roi_align_forward_bf16_kernel<kSlice, kRatio, kAligned>;
  cudaError_t err = allow_smem(kernel, kBf16SmemLimit, &mu, done);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (sms[dev] == 0) {
    // the largest shared-memory carveout, so that two blocks share an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int blocks = kBf16BlocksPerSm * sms[dev];
  const int slices = channels / kSlice;
  const int per = bf16_unit_slices(num_rois, slices, blocks);
  const long long units = static_cast<long long>(num_rois) * (slices / per);
  if (units > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(std::min<long long>(units, blocks)), kBf16Threads,
           bf16_smem_bytes(pool, ratio, kSlice), stream>>>(
      lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
      static_cast<__nv_bfloat16*>(out), num_rois, rois_per_image, channels, pool, ratio, per,
      bf16_ring_rows(pool, ratio, kSlice), bf16_stage_cells(pool, ratio, kSlice));
  return cudaGetLastError();
}

// The bf16 kernel's slice width: the first of 64, 32 and 8 (whole 16-byte
// copies) that divides C and fits kBf16SmemLimit; 0 if none.
int bf16_slice(int channels, int pool, int ratio) {
  return pick_slice({64, 32, 8}, channels, pool, ratio, kBf16SmemLimit, bf16_smem_bytes);
}

template <int kSlice, bool kAligned>
cudaError_t launch_fwd_bf16_slice(const Levels<const __nv_bfloat16>& lv, const void* rois,
                                  const void* levels, void* out, int num_rois,
                                  int rois_per_image, int channels, int pool, int ratio,
                                  cudaStream_t stream) {
  return ratio == 2 ? launch_fwd_bf16<kSlice, 2, kAligned>(lv, rois, levels, out, num_rois,
                                                           rois_per_image, channels, pool,
                                                           ratio, stream)
                    : launch_fwd_bf16<kSlice, 0, kAligned>(lv, rois, levels, out, num_rois,
                                                           rois_per_image, channels, pool,
                                                           ratio, stream);
}

template <int kSlice, bool kAligned>
cudaError_t launch_bwd(const Levels<float>& lv, const void* rois, const void* levels,
                       const void* grad_out, int num_rois, int rois_per_image, int channels,
                       int pool, int ratio, cudaStream_t stream) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(roi_align_backward_kernel<kSlice, kAligned>, kBwdSmemLimit, &mu, done);
  if (err != cudaSuccess) return err;
  roi_align_backward_kernel<kSlice, kAligned>
      <<<num_rois * (channels / kSlice), kThreads, bwd_smem_bytes(pool, ratio, kSlice),
         stream>>>(lv, static_cast<const float4*>(rois), static_cast<const int*>(levels),
                   static_cast<const float*>(grad_out), rois_per_image, channels, pool, ratio);
  return cudaGetLastError();
}

template <int kTileN, int kSlice, int kBlock, int kMinBlocks, bool kAligned>
cudaError_t launch_tiles(const Levels<__nv_bfloat16>& lv, int num_levels, const void* rois,
                         const void* levels, const void* bounds, const void* grad_out,
                         int num_images, int rois_per_image, int channels, int pool, int ratio,
                         int smem_limit, cudaStream_t stream) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  const auto kernel =
      roi_align_backward_tiles_kernel<kTileN, kSlice, kBlock, kMinBlocks, kAligned>;
  cudaError_t err = allow_smem(kernel, smem_limit, &mu, done);
  if (err != cudaSuccess) return err;
  TileGrid grid = {};
  long long blocks = 0;
  for (int i = 0; i < num_levels; ++i) {
    const int l = num_levels - 1 - i;  // the coarsest level first
    grid.level[i] = l;
    grid.first[i] = static_cast<int>(blocks);
    grid.tiles_x[i] = (lv.w[l] + kTileN - 1) / kTileN;
    grid.tiles_y[i] = (lv.h[l] + kTileN - 1) / kTileN;
    blocks += static_cast<long long>(num_images) * grid.tiles_y[i] * grid.tiles_x[i] *
              (channels / kSlice);
  }
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  grid.first[num_levels] = static_cast<int>(blocks);
  if (blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(blocks), kBlock, tile_smem_bytes(kTileN, pool, kSlice),
           stream>>>(lv, grid, static_cast<const float4*>(rois),
                     static_cast<const int*>(levels), static_cast<const int4*>(bounds),
                     static_cast<const __nv_bfloat16*>(grad_out), rois_per_image, channels,
                     pool, ratio);
  return cudaGetLastError();
}

// The bodies of the C entries below, one instance for each value of
// aligned.
template <bool kAligned>
int forward_bf16_entry(const void* const* feats, const int* heights, const int* widths,
                       const float* strides, int num_levels, const void* rois,
                       const void* levels, void* out, int num_rois, int rois_per_image,
                       int channels, int pool, int ratio, void* stream) {
  if (bad_args(num_levels, pool, ratio) || channels % 8 || rois_per_image <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois <= 0 || channels <= 0) return 0;
  Levels<const __nv_bfloat16> lv = {};
  fill_levels(&lv, feats, heights, widths, strides, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bf16_slice(channels, pool, ratio)) {
    case 64:
      return static_cast<int>(launch_fwd_bf16_slice<64, kAligned>(
          lv, rois, levels, out, num_rois, rois_per_image, channels, pool, ratio, s));
    case 32:
      return static_cast<int>(launch_fwd_bf16_slice<32, kAligned>(
          lv, rois, levels, out, num_rois, rois_per_image, channels, pool, ratio, s));
    case 8:
      return static_cast<int>(launch_fwd_bf16_slice<8, kAligned>(
          lv, rois, levels, out, num_rois, rois_per_image, channels, pool, ratio, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kAligned>
int backward_entry(void* const* grads, const int* heights, const int* widths,
                   const float* strides, int num_levels, const void* rois, const void* levels,
                   const void* grad_out, int num_rois, int rois_per_image, int channels,
                   int pool, int ratio, void* stream) {
  if (bad_args(num_levels, pool, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois <= 0 || channels <= 0) return 0;
  Levels<float> lv = {};
  fill_levels(&lv, grads, heights, widths, strides, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_slice({32, 16, 8, 4}, channels, pool, ratio, kBwdSmemLimit, bwd_smem_bytes)) {
    case 32:
      return static_cast<int>(launch_bwd<32, kAligned>(lv, rois, levels, grad_out, num_rois,
                                                       rois_per_image, channels, pool, ratio, s));
    case 16:
      return static_cast<int>(launch_bwd<16, kAligned>(lv, rois, levels, grad_out, num_rois,
                                                       rois_per_image, channels, pool, ratio, s));
    case 8:
      return static_cast<int>(launch_bwd<8, kAligned>(lv, rois, levels, grad_out, num_rois,
                                                      rois_per_image, channels, pool, ratio, s));
    case 4:
      return static_cast<int>(launch_bwd<4, kAligned>(lv, rois, levels, grad_out, num_rois,
                                                      rois_per_image, channels, pool, ratio, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kAligned>
int tap_bounds_entry(const int* heights, const int* widths, const float* strides,
                     int num_levels, const void* rois, const void* levels, void* bounds,
                     int num_rois, int pool, int ratio, void* stream) {
  if (bad_args(num_levels, pool, ratio)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois <= 0) return 0;
  Levels<__nv_bfloat16> lv = {};
  void* const none[kMaxLevels] = {};
  fill_levels(&lv, none, heights, widths, strides, num_levels);
  roi_tap_bounds_kernel<kAligned>
      <<<(num_rois + kBoundsWarps - 1) / kBoundsWarps, 32 * kBoundsWarps, 0,
         static_cast<cudaStream_t>(stream)>>>(lv, static_cast<const float4*>(rois),
                                              static_cast<const int*>(levels),
                                              static_cast<int4*>(bounds), num_rois, pool, ratio);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAligned>
int tiles_entry(void* const* grads, const int* heights, const int* widths,
                const float* strides, int num_levels, const void* rois, const void* levels,
                const void* bounds, const void* grad_out, int num_images, int rois_per_image,
                int channels, int pool, int ratio, void* stream) {
  if (bad_args(num_levels, pool, ratio) || channels % 8 || rois_per_image < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_images <= 0 || channels <= 0) return 0;
  Levels<__nv_bfloat16> lv = {};
  fill_levels(&lv, grads, heights, widths, strides, num_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % kWideSlice == 0 &&
      tile_smem_bytes(kWideTile, pool, kWideSlice) <= kWideSmemLimit) {
    return static_cast<int>(launch_tiles<kWideTile, kWideSlice, 512, 1, kAligned>(
        lv, num_levels, rois, levels, bounds, grad_out, num_images, rois_per_image, channels,
        pool, ratio, kWideSmemLimit, s));
  }
  const auto bytes = [](int p, int /*r*/, int slice) { return tile_smem_bytes(kTile, p, slice); };
  switch (pick_slice({32, 16, 8}, channels, pool, ratio, kTileSmemLimit, bytes)) {
    case 32:
      return static_cast<int>(launch_tiles<kTile, 32, kThreads, 2, kAligned>(
          lv, num_levels, rois, levels, bounds, grad_out, num_images, rois_per_image, channels,
          pool, ratio, kTileSmemLimit, s));
    case 16:
      return static_cast<int>(launch_tiles<kTile, 16, kThreads, 2, kAligned>(
          lv, num_levels, rois, levels, bounds, grad_out, num_images, rois_per_image, channels,
          pool, ratio, kTileSmemLimit, s));
    case 8:
      return static_cast<int>(launch_tiles<kTile, 8, kThreads, 2, kAligned>(
          lv, num_levels, rois, levels, bounds, grad_out, num_images, rois_per_image, channels,
          pool, ratio, kTileSmemLimit, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Whether the narrow instances take an input: kind 0 K2 fp32, 1 K2 bf16,
// 2 K3 fp32, 3 K3 bf16 (the pre-pass and the tile kernel), 4 the pre-pass
// alone; C already a multiple of 4 (bf16: 8). The rest go the wide route.
bool narrow_takes(int kind, int channels, int pool, int ratio, int num_levels) {
  if (bad_args(num_levels, pool, ratio)) return false;
  switch (kind) {
    case 0: {
      const auto bytes = [](int p, int r, int slice) { return fwd_smem_bytes(p, r, slice, 4); };
      return pick_slice({64, 32, 4}, channels, pool, ratio, kFwdSmemLimit, bytes) != 0;
    }
    case 1:
      return channels % 8 == 0 && bf16_slice(channels, pool, ratio) != 0;
    case 2:
      return pick_slice({32, 16, 8, 4}, channels, pool, ratio, kBwdSmemLimit,
                        bwd_smem_bytes) != 0;
    case 3: {
      if (channels % 8) return false;
      if (channels % kWideSlice == 0 &&
          tile_smem_bytes(kWideTile, pool, kWideSlice) <= kWideSmemLimit) {
        return true;
      }
      const auto bytes = [](int p, int, int slice) { return tile_smem_bytes(kTile, p, slice); };
      return pick_slice({32, 16, 8}, channels, pool, ratio, kTileSmemLimit, bytes) != 0;
    }
    case 4:
      return true;
    default:
      return false;
  }
}

template <typename T, bool kAligned>
int forward_wide_entry(const void* table, int num_levels, const void* rois, const void* levels,
                       void* out, int num_rois, int rois_per_image, int channels, int pool,
                       int ratio, void* stream) {
  const long long total = static_cast<long long>(num_rois) * pool * pool * (channels / 4);
  if (total <= 0) return 0;
  roi_align_forward_wide_kernel<T, kAligned>
      <<<wide_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const long long*>(table), num_levels, static_cast<const float4*>(rois),
          static_cast<const int*>(levels), static_cast<T*>(out), total, rois_per_image,
          channels, pool, ratio);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAligned>
int backward_wide_entry(const void* table, int num_levels, const void* rois,
                        const void* levels, const void* grad_out, int num_rois,
                        int rois_per_image, int channels, int pool, int ratio, void* stream) {
  const long long total = static_cast<long long>(num_rois) * pool * pool * (channels / 4);
  if (total <= 0) return 0;
  roi_align_backward_wide_kernel<T, kAligned>
      <<<wide_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const long long*>(table), num_levels, static_cast<const float4*>(rois),
          static_cast<const int*>(levels), static_cast<const T*>(grad_out), total,
          rois_per_image, channels, pool, ratio);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry that runs a kernel takes `aligned` (0 or 1) before the stream:
// RoIAlign's aligned, which picks the kernels' instance (roi_frame).

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
                                 int ratio, int aligned, void* stream) {
  return aligned ? forward_entry<float, 4, true>(feats, heights, widths, strides, num_levels,
                                                 rois, levels, out, num_rois, rois_per_image,
                                                 channels, pool, ratio, stream)
                 : forward_entry<float, 4, false>(feats, heights, widths, strides, num_levels,
                                                  rois, levels, out, num_rois, rois_per_image,
                                                  channels, pool, ratio, stream);
}

// roi_align_forward for bf16 features and output ([B, Hl, Wl, C] and
// [num_rois, P, P, C] bf16, 16-byte aligned); C a multiple of 8. The
// persistent, warp-specialised kernel (roi_align_forward_bf16_kernel).
extern "C" int roi_align_forward_bf16(const void* const* feats, const int* heights,
                                      const int* widths, const float* strides,
                                      int num_levels, const void* rois,
                                      const void* levels, void* out, int num_rois,
                                      int rois_per_image, int channels, int pool,
                                      int ratio, int aligned, void* stream) {
  return aligned ? forward_bf16_entry<true>(feats, heights, widths, strides, num_levels, rois,
                                            levels, out, num_rois, rois_per_image, channels,
                                            pool, ratio, stream)
                 : forward_bf16_entry<false>(feats, heights, widths, strides, num_levels, rois,
                                             levels, out, num_rois, rois_per_image, channels,
                                             pool, ratio, stream);
}

// How roi_align_forward_bf16 runs C channels at P and S, into plan[6]: the
// slice width (0: refused), the ring's rows, a stage's cells, the dynamic
// shared memory of a block, its threads, and the blocks an SM.
extern "C" void roi_align_forward_bf16_plan(int channels, int pool, int ratio, int* plan) {
  const int slice = bad_args(1, pool, ratio) || channels % 8 ? 0
                                                             : bf16_slice(channels, pool, ratio);
  plan[0] = slice;
  plan[1] = slice ? bf16_ring_rows(pool, ratio, slice) : 0;
  plan[2] = slice ? bf16_stage_cells(pool, ratio, slice) : 0;
  plan[3] = slice ? bf16_smem_bytes(pool, ratio, slice) : 0;
  plan[4] = kBf16Threads;
  plan[5] = kBf16BlocksPerSm;
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
                                  int pool, int ratio, int aligned, void* stream) {
  return aligned ? backward_entry<true>(grads, heights, widths, strides, num_levels, rois,
                                        levels, grad_out, num_rois, rois_per_image, channels,
                                        pool, ratio, stream)
                 : backward_entry<false>(grads, heights, widths, strides, num_levels, rois,
                                         levels, grad_out, num_rois, rois_per_image, channels,
                                         pool, ratio, stream);
}

// K3's pre-pass for a bf16 g, alone: bounds [num_rois] int4 receives each
// RoI's (x first, x last, y first, y last) cell of its nonzero taps on its
// level ((0, -1) for an axis without one). heights/widths/strides: host
// arrays of num_levels entries; rois, levels, pool, ratio and aligned as
// roi_align_forward. Returns the cudaError_t of the launch.
extern "C" int roi_tap_bounds(const int* heights, const int* widths, const float* strides,
                              int num_levels, const void* rois, const void* levels,
                              void* bounds, int num_rois, int pool, int ratio, int aligned,
                              void* stream) {
  return aligned ? tap_bounds_entry<true>(heights, widths, strides, num_levels, rois, levels,
                                          bounds, num_rois, pool, ratio, stream)
                 : tap_bounds_entry<false>(heights, widths, strides, num_levels, rois, levels,
                                           bounds, num_rois, pool, ratio, stream);
}

// K3 for a bf16 grad_out ([num_images * rois_per_image, P, P, C] bf16,
// 16-byte aligned, C a multiple of 8), after roi_tap_bounds wrote `bounds`
// (with the same aligned): writes every cell of the bf16 level gradients
// grads ([B, Hl, Wl, C], 16-byte aligned, not filled), each once. The other
// arguments as roi_align_backward. Returns the cudaError_t of the launch.
extern "C" int roi_align_backward_tiles_bf16(void* const* grads, const int* heights,
                                             const int* widths, const float* strides,
                                             int num_levels, const void* rois,
                                             const void* levels, const void* bounds,
                                             const void* grad_out, int num_images,
                                             int rois_per_image, int channels, int pool,
                                             int ratio, int aligned, void* stream) {
  return aligned ? tiles_entry<true>(grads, heights, widths, strides, num_levels, rois, levels,
                                     bounds, grad_out, num_images, rois_per_image, channels,
                                     pool, ratio, stream)
                 : tiles_entry<false>(grads, heights, widths, strides, num_levels, rois, levels,
                                      bounds, grad_out, num_images, rois_per_image, channels,
                                      pool, ratio, stream);
}

// The wide route (see the section's note): every input the narrow instances
// do not take (roi_align_narrow), any level count, any P * S. table: device
// memory, [4][num_levels] int64 (level pointers, heights, widths, the
// strides' float bits); C a multiple of 4; levels and g 16-byte aligned.
// bf16: 1 for bf16 features and output (K2) or upstream gradient (K3).

// Whether the narrow instances take C channels at P and S over num_levels
// levels: kind 0 K2 float32, 1 K2 bf16, 2 K3 float32, 3 K3 bf16 (pre-pass
// and tile kernel), 4 the pre-pass alone. 1: they do; 0: the wide route.
extern "C" int roi_align_narrow(int kind, int channels, int pool, int ratio, int num_levels) {
  return narrow_takes(kind, channels, pool, ratio, num_levels) ? 1 : 0;
}

// K2 on the wide route: out [num_rois, P, P, C] of the features' type.
extern "C" int roi_align_forward_wide(const void* table, int num_levels, const void* rois,
                                      const void* levels, void* out, int num_rois,
                                      int rois_per_image, int channels, int pool, int ratio,
                                      int bf16, int aligned, void* stream) {
  if (num_levels < 1 || pool < 1 || ratio < 1 || channels % 4 || rois_per_image <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto entry =
      bf16 ? (aligned ? forward_wide_entry<__nv_bfloat16, true>
                      : forward_wide_entry<__nv_bfloat16, false>)
           : (aligned ? forward_wide_entry<float, true> : forward_wide_entry<float, false>);
  return entry(table, num_levels, rois, levels, out, num_rois, rois_per_image, channels, pool,
               ratio, stream);
}

// K3 on the wide route: adds the gradient of every RoI into the zero-filled
// fp32 level gradients of `table`, from grad_out [num_rois, P, P, C] fp32
// or (bf16) bf16.
extern "C" int roi_align_backward_wide(const void* table, int num_levels, const void* rois,
                                       const void* levels, const void* grad_out, int num_rois,
                                       int rois_per_image, int channels, int pool, int ratio,
                                       int bf16, int aligned, void* stream) {
  if (num_levels < 1 || pool < 1 || ratio < 1 || channels % 4 || rois_per_image <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto entry =
      bf16 ? (aligned ? backward_wide_entry<__nv_bfloat16, true>
                      : backward_wide_entry<__nv_bfloat16, false>)
           : (aligned ? backward_wide_entry<float, true> : backward_wide_entry<float, false>);
  return entry(table, num_levels, rois, levels, grad_out, num_rois, rois_per_image, channels,
               pool, ratio, stream);
}

// roi_tap_bounds on the wide route (the table's pointers are not read).
extern "C" int roi_tap_bounds_wide(const void* table, int num_levels, const void* rois,
                                   const void* levels, void* bounds, int num_rois, int pool,
                                   int ratio, int aligned, void* stream) {
  if (num_levels < 1 || pool < 1 || ratio < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rois <= 0) return 0;
  const auto kernel = aligned ? roi_tap_bounds_wide_kernel<true> : roi_tap_bounds_wide_kernel<false>;
  kernel<<<(num_rois + kBoundsWarps - 1) / kBoundsWarps, 32 * kBoundsWarps, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), num_levels, static_cast<const float4*>(rois),
      static_cast<const int*>(levels), static_cast<int4*>(bounds), num_rois, pool, ratio);
  return static_cast<int>(cudaGetLastError());
}

// dst [n] bf16 = src [n] fp32 rounded to nearest even; n a multiple of 4,
// both 16-byte aligned (dst 8-byte). The wide route's K3 bf16 writes its
// level gradients so, each rounded once after every RoI's sum.
extern "C" int cast_bf16(const void* src, void* dst, long long n, void* stream) {
  if (n % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cast_bf16_kernel<<<wide_blocks(n / 4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<uint2*>(dst), n / 4);
  return static_cast<int>(cudaGetLastError());
}
