// Greedy NMS keep mask for many problems at once, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel detectron_tpu/ops/nms_pallas.py::nms_pallas
// (_nms_kernel, _iou_block): greedy suppression over score-sorted boxes,
// suppress j by i when i < j, i is kept and valid, and IoU(i, j) > thresh
// (strict), IoU = inter / max(union, 1e-8) with the `offset` width
// convention. With max_keep, a problem's walk stops once max_keep boxes are
// kept, and every later box's keep flag is 0 (the caller keeps only the
// first max_keep kept boxes in any case).
//
// What bounds it on the H100: not bytes (16 bytes a box, 8 in bf16) and not IoU
// arithmetic (~16 fp32 operations a pair, N^2/2 pairs), but the greedy
// chain itself: box i's fate depends on every kept box before it, so a
// problem is a sequential walk, and the walk's time is the latency of each
// step. The TPU kernel walked 128-box tiles in order on one core. Here the
// work is split in two launches:
//
//   1. nms_mask_kernel, one block of 64 threads per upper-triangle tile
//      (row block rb <= column block cb) of every problem, indexed linearly
//      so that no block is launched only to exit: every IoU the walk can
//      read, in parallel over the whole card. Thread t of tile (rb, cb)
//      takes sorted box i = 64*rb + t against the 64 boxes of column block
//      cb (staged in shared memory) and writes one 64-bit word whose bit j
//      says "i suppresses 64*cb + j"; a full tile's 64 IoUs are unrolled,
//      without bounds tests, so that their latencies overlap (a predicated
//      loop shared with the edge tiles was 10% slower on an H100). Rows are
//      laid out [G, 64*W, W]
//      (W = ceil(N/64) words a row, the row count padded to whole chunks),
//      so a chunk of 64 rows is one contiguous, 16-byte aligned span.
//   2. nms_scan_kernel, one block (one warp) per problem: the greedy walk
//      over 64-box chunks in order. Its time is latency on the chain: rows
//      loaded only after the previous chunk is done pay the device-memory
//      latency once a chunk, and a walk box by box pays a shared-memory
//      load, a bit test and a branch per kept box (~150 ns a kept box on an
//      H100). So each chunk's rows (64*W*8 bytes, at most 64 KB) arrive by
//      one bulk asynchronous copy (cp.async.bulk, completed on an mbarrier)
//      into one of two shared-memory buffers, the copy of chunk rb+1 issued
//      before chunk rb is resolved; the valid flags are packed into one
//      word a chunk once, up front. And a chunk is resolved in rounds, not
//      box by box: its keep set K is the one fixpoint of
//      K = alive & ~(OR of the diagonal words of the rows in K), and each
//      round (one warp-wide OR of the rows still kept, lane l holding rows
//      l and l+32) settles at least the first box still wrong, so a chunk
//      takes as many rounds as its longest suppression chain, plus one.
//      Lane l keeps the removed-bits words l and l+32 (the instance for
//      N <= 4096), or l, l+32, l+64 and l+96 (N <= 8192: RetinaNet's 5000
//      merged candidates), in named registers, and folds the kept rows into
//      them with independent loads. No
//      __syncthreads: one warp, warp-uniform branches. With max_keep, the
//      chunk where the count is reached keeps only its first boxes up to
//      it, and the walk ends.
//   2'. nms_scan_wide_kernel, the same walk past 8192 boxes (W > 128), with
//      no box limit of its own: two whole chunks (2 * 64 * W * 8 bytes) no
//      longer fit a block's shared memory (256 KB at W = 256), and named
//      registers do not scale with W. So the removed-bits words live in
//      shared memory (W * 8 bytes, lane-strided), and only what the walk
//      reads is brought in: the chunk's diagonal words and valid flags,
//      loaded one chunk ahead (they do not depend on the walk), and, once
//      the chunk's keep set is known, each kept row's live words [rb + 1, W)
//      by one bulk asynchronous copy a row (its span widened to 16-byte
//      alignment), all in flight together on one mbarrier into a 64 KB
//      stage, in as many windows of words as the kept rows need to fit it,
//      then folded into the removed words from shared memory. A lane-strided
//      read of the live words straight from L2 (a 20000-box mask is 50 MB,
//      about the L2's size) waits a round trip for every few loads a lane
//      keeps in flight; scripts/k1_wide_ablation.py times both. The chunk
//      fixpoint and the max_keep stop are the register instances'. The
//      limit is shared memory, kWideMaxWords words (1,280,000 boxes): a
//      problem's mask, 64 * W * W * 8 bytes, outgrows the card's memory
//      well before it (205 GB there).
//
// The IoU must be bit-identical to the JAX package's bbox_overlaps and
// _iou_block so that keep sets are equal: the same operation order, IEEE
// division, and the _rn intrinsics, which the compiler never contracts
// into fused multiply-adds.
//
// Boxes come in float32 or bf16, as the JAX kernel takes them in their own
// dtype and computes _iou_block in it. The mask kernel is a template on the
// box type (float4, or four bf16 in a uint2: 8 bytes a box); the scans read
// only bits and are the same for both. bf16 IoUs are what PyTorch's and
// XLA's bf16 elementwise operations give: every step of bbox_overlaps
// computed in fp32 and rounded to bf16 (nearest even) in the same order --
// each difference, each `+ offset`, the intersection, each area, the sum of
// the areas, the union, the 1e-8 floor (itself rounded) and the division.
// Maxima, minima and the clamps at 0 are exact. The threshold is rounded to
// bf16 by the caller, as both frameworks round a Python number compared
// with a bf16 tensor. The float32 instance is the same code as before the
// bf16 one existed (rnd<float4> is the identity).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;
constexpr int kMaxWords = 128;  // the register instances: 4 removed-bits words a lane, 8192 boxes
constexpr int kWideStageWords = 8192;  // the wide scan's stage of live words, 64 KB
constexpr int kWideMaxWords = 20000;   // the wide scan's removed words, 160 KB
constexpr int kMaxDevices = 64;

// A box as four floats: a float4 as it is; four bf16 in a uint2 (x1 in the
// low half of .x) widened exactly (the bf16 bits are the float's top half).
__device__ __forceinline__ float4 load_box(const float4 b) { return b; }

__device__ __forceinline__ float4 load_box(const uint2 b) {
  return make_float4(__uint_as_float(b.x << 16), __uint_as_float(b.x & 0xffff0000u),
                     __uint_as_float(b.y << 16), __uint_as_float(b.y & 0xffff0000u));
}

// An fp32 result rounded to the boxes' type: as it is for float32 boxes, to
// bf16 (nearest even) for bf16 ones.
template <typename Box>
__device__ __forceinline__ float rnd(float x);

template <>
__device__ __forceinline__ float rnd<float4>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float rnd<uint2>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename Box>
__device__ __forceinline__ float box_area(const float4 b, float offset) {
  float w = fmaxf(rnd<Box>(__fadd_rn(rnd<Box>(__fsub_rn(b.z, b.x)), offset)), 0.0f);
  float h = fmaxf(rnd<Box>(__fadd_rn(rnd<Box>(__fsub_rn(b.w, b.y)), offset)), 0.0f);
  return rnd<Box>(__fmul_rn(w, h));
}

// IoU of row box a (the earlier, higher-scored one) and column box b.
template <typename Box>
__device__ __forceinline__ float iou(const float4 a, float area_a,
                                     const float4 b, float area_b,
                                     float offset) {
  float ix1 = fmaxf(a.x, b.x);
  float iy1 = fmaxf(a.y, b.y);
  float ix2 = fminf(a.z, b.z);
  float iy2 = fminf(a.w, b.w);
  float iw = fmaxf(rnd<Box>(__fadd_rn(rnd<Box>(__fsub_rn(ix2, ix1)), offset)), 0.0f);
  float ih = fmaxf(rnd<Box>(__fadd_rn(rnd<Box>(__fsub_rn(iy2, iy1)), offset)), 0.0f);
  float inter = rnd<Box>(__fmul_rn(iw, ih));
  // 0 / max(union, 1e-8) is +0 exactly (in bf16 too); most pairs do not
  // overlap, and the IEEE division would send a zero numerator down its
  // range-checked path
  if (inter == 0.0f) return 0.0f;
  float uni = rnd<Box>(__fsub_rn(rnd<Box>(__fadd_rn(area_a, area_b)), inter));
  return rnd<Box>(__fdiv_rn(inter, fmaxf(uni, rnd<Box>(1e-8f))));
}

// Box: float4 (float32 boxes) or uint2 (bf16 boxes).
template <typename Box>
__global__ void __launch_bounds__(kBlock)
    nms_mask_kernel(const Box* __restrict__ boxes,  // [G, N]
                    u64* __restrict__ mask,          // [G, 64 * W, W]
                    int n, int words, float thresh, float offset) {
  // tile index -> (rb, cb), row by row over the upper triangle
  int rb = 0, rest = blockIdx.x;
  while (rest >= words - rb) {
    rest -= words - rb;
    ++rb;
  }
  const int cb = rb + rest;
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int i = rb * kBlock + t;
  const Box* gboxes = boxes + (size_t)g * n;

  __shared__ float4 col[kBlock];
  __shared__ float col_area[kBlock];
  const int j0 = cb * kBlock;
  const int ncol = min(kBlock, n - j0);
  // the row box's load is in flight with the column boxes'
  const float4 a = i < n ? load_box(gboxes[i]) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t < ncol) {
    float4 b = load_box(gboxes[j0 + t]);
    col[t] = b;
    col_area[t] = box_area<Box>(b, offset);
  }
  __syncthreads();
  if (i >= n) return;

  const float area_a = box_area<Box>(a, offset);
  u64 bits = 0ull;
  if (cb > rb && ncol == kBlock) {  // a full tile right of the diagonal: no bounds
#pragma unroll 16
    for (int k = 0; k < kBlock; ++k) {
      bits |= static_cast<u64>(iou<Box>(a, area_a, col[k], col_area[k], offset) > thresh) << k;
    }
  } else {
    const int start = (cb == rb) ? t + 1 : 0;  // only j > i
    for (int k = start; k < ncol; ++k) {
      if (iou<Box>(a, area_a, col[k], col_area[k], offset) > thresh) bits |= 1ull << k;
    }
  }
  mask[((size_t)g * kBlock * words + i) * words + cb] = bits;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Arrives on `bar`, whose phase then also waits for `bytes` of copies.
__device__ __forceinline__ void expect_bytes(u64* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Starts copying `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory, counted against the phase of `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bulk_copy that alone completes the phase of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          u64* bar) {
  expect_bytes(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Waits until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void bar_wait(u64* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Dynamic shared memory of one scan block: two chunk buffers of 64 rows of
// `words` words, and one valid word a chunk (at kMaxWords: 129 KB).
int scan_smem_bytes(int words) {
  return static_cast<int>((2 * kBlock * words + words) * sizeof(u64));
}

// LANE_WORDS: the removed-bits words a lane holds, 2 (words <= 64) or 4
// (words <= 128). They are named registers, not an array: an array indexed
// by the chunk went to the stack.
template <int LANE_WORDS>
__global__ void __launch_bounds__(32)
    nms_scan_kernel(const u64* __restrict__ mask,         // [G, 64 * W, W]
                    const uint8_t* __restrict__ valid,    // [G, N]
                    uint8_t* __restrict__ keep,           // [G, N]
                    int n, int words, int max_keep) {
  extern __shared__ __align__(128) u64 smem[];
  __shared__ __align__(8) u64 bars[2];
  __shared__ int order[kBlock];  // the kept rows of a chunk, in order
  u64* rows = smem;                          // [2][64 * words]
  u64* vwords = smem + 2 * kBlock * words;   // [words]
  const unsigned full = 0xffffffffu;
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t chunk = static_cast<size_t>(kBlock) * words;  // words a chunk
  const u64* gmask = mask + (size_t)g * chunk * words;
  const uint8_t* gvalid = valid + (size_t)g * n;
  uint8_t* gkeep = keep + (size_t)g * n;
  const uint32_t chunk_bytes = static_cast<uint32_t>(chunk * sizeof(u64));

  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[0]))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[1]))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(rows, gmask, chunk_bytes, &bars[0]);
  }
  // the valid flags, one word of bits a chunk, while chunk 0 is in flight:
  // lane l packs chunks l, l + 32, ... with loads that are all issued together
  for (int c = lane; c < words; c += 32) {
    const uint8_t* v = gvalid + c * kBlock;
    const int m = min(kBlock, n - c * kBlock);
    u64 bits = 0ull;
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      if (j < m && v[j] != 0) bits |= 1ull << j;
    }
    vwords[c] = bits;
  }
  __syncwarp();

  // removed-bits words `lane`, `lane + 32` and (LANE_WORDS 4) `lane + 64`,
  // `lane + 96`, in registers
  u64 removed0 = 0ull, removed1 = 0ull, removed2 = 0ull, removed3 = 0ull;
  int kept = 0;
  bool done = kept >= max_keep;  // warp-uniform
  int rb = 0;
  for (; rb < words && !done; ++rb) {
    if (lane == 0 && rb + 1 < words) {
      // the buffer was last read by chunk rb - 1, before the __syncwarp
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(rows + ((rb + 1) & 1) * chunk, gmask + (rb + 1) * chunk, chunk_bytes,
                &bars[(rb + 1) & 1]);
    }
    bar_wait(&bars[rb & 1], (rb >> 1) & 1);
    const u64* buf = rows + (rb & 1) * chunk;
    const int i0 = rb * kBlock;
    const int nrow = min(kBlock, n - i0);

    // the chunk's boxes that are valid and not removed by an earlier chunk
    // (word rb of the removed bits, held by lane rb % 32, the same value in
    // every lane after the shuffle)
    const int hw = rb >> 5;
    const u64 held = LANE_WORDS == 2 ? (hw ? removed1 : removed0)
                                     : (hw == 0 ? removed0 : hw == 1 ? removed1
                                                  : hw == 2 ? removed2 : removed3);
    const u64 alive = vwords[rb] & ~__shfl_sync(full, held, rb & 31);
    // lane l holds the diagonal words of rows l and l + 32: the later boxes
    // of the chunk that each row suppresses
    const u64 d0 = lane < nrow ? buf[lane * words + rb] : 0ull;
    const u64 d1 = lane + 32 < nrow ? buf[(lane + 32) * words + rb] : 0ull;
    // The chunk's greedy keep set is the one fixpoint of K = alive & ~(OR of
    // the rows of K): row r's bit depends only on the rows before it, so each
    // round settles at least the first box that was still wrong. Rounds: the
    // chunk's longest suppression chain, plus one; each is two warp ORs.
    u64 kept_bits = alive;
    while (true) {  // warp-uniform
      const u64 mine = (((kept_bits >> lane) & 1ull) ? d0 : 0ull) |
                       (((kept_bits >> (lane + 32)) & 1ull) ? d1 : 0ull);
      const u64 sup = (static_cast<u64>(__reduce_or_sync(full, static_cast<unsigned>(mine >> 32)))
                       << 32) |
                      __reduce_or_sync(full, static_cast<unsigned>(mine));
      const u64 next = alive & ~sup;
      if (next == kept_bits) break;
      kept_bits = next;
    }
    if (kept + __popcll(kept_bits) >= max_keep) {  // keep only the first max_keep
      while (kept + __popcll(kept_bits) > max_keep) {
        kept_bits &= ~(1ull << (63 - __clzll(static_cast<long long>(kept_bits))));
      }
      done = true;
    }
    kept += __popcll(kept_bits);
    if (!done) {
      // fold the kept rows into the removed words; their indices go through
      // shared memory so that the rows' loads are independent of each other
      if ((kept_bits >> lane) & 1ull) order[__popcll(kept_bits & ((1ull << lane) - 1))] = lane;
      if ((kept_bits >> (lane + 32)) & 1ull) {
        order[__popcll(kept_bits & ((1ull << (lane + 32)) - 1))] = lane + 32;
      }
      __syncwarp();
      // the later words this lane folds
      const bool own0 = lane > rb && lane < words;
      const bool own1 = lane + 32 > rb && lane + 32 < words;
      const bool own2 = LANE_WORDS > 2 && lane + 64 > rb && lane + 64 < words;
      const bool own3 = LANE_WORDS > 2 && lane + 96 > rb && lane + 96 < words;
      const int count = __popcll(kept_bits);
      u64 a0 = 0ull, a1 = 0ull, a2 = 0ull, a3 = 0ull;
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        const u64* row = buf + order[j] * words;
        if (own0) a0 |= row[lane];
        if (own1) a1 |= row[lane + 32];
        if (LANE_WORDS > 2) {
          if (own2) a2 |= row[lane + 64];
          if (own3) a3 |= row[lane + 96];
        }
      }
      removed0 |= a0;
      removed1 |= a1;
      removed2 |= a2;
      removed3 |= a3;
    }
    if (lane < nrow) gkeep[i0 + lane] = (kept_bits >> lane) & 1ull;
    if (lane + 32 < nrow) gkeep[i0 + 32 + lane] = (kept_bits >> (lane + 32)) & 1ull;
    __syncwarp();  // every lane is done with `buf` before it is refilled
  }
  // after an early stop: the later boxes keep nothing, and the copy still in
  // flight lands before the block's shared memory is given up
  for (int i = rb * kBlock + lane; i < n; i += 32) gkeep[i] = 0;
  if (rb < words) bar_wait(&bars[rb & 1], (rb >> 1) & 1);
}

// Dynamic shared memory of one wide scan block: the stage, then the
// removed-bits words.
int wide_smem_bytes(int words) {
  return static_cast<int>((kWideStageWords + words) * sizeof(u64));
}

// The scan for W > kMaxWords: one warp a problem, as nms_scan_kernel, with
// the removed-bits words in shared memory and only the words the walk reads
// brought in (the header's 2').
__global__ void __launch_bounds__(32)
    nms_scan_wide_kernel(const u64* __restrict__ mask,         // [G, 64 * W, W]
                         const uint8_t* __restrict__ valid,    // [G, N]
                         uint8_t* __restrict__ keep,           // [G, N]
                         int n, int words, int max_keep) {
  extern __shared__ __align__(128) u64 smem[];
  __shared__ __align__(8) u64 bar;
  __shared__ int order[kBlock];  // the kept rows of a chunk, in order
  __shared__ int piece[kBlock];  // where word w of kept row order[k] lies: stage[piece[k] + w]
  u64* stage = smem;                       // [kWideStageWords]
  u64* removed = smem + kWideStageWords;   // [words]
  const unsigned full = 0xffffffffu;
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const u64* gmask = mask + (size_t)g * kBlock * words * words;
  const uint8_t* gvalid = valid + (size_t)g * n;
  uint8_t* gkeep = keep + (size_t)g * n;

  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();

  // chunk rb's diagonal words of rows lane and lane + 32, and their valid
  // bytes, as loaded: the next chunk's are in flight while this one is
  // resolved (used raw, so that nothing waits for them before then)
  auto fetch = [&](int rb, u64& e0, u64& e1, uint8_t& f0, uint8_t& f1) {
    const int i0 = rb * kBlock;
    const int m = min(kBlock, n - i0);
    e0 = lane < m ? gmask[(size_t)(i0 + lane) * words + rb] : 0ull;
    e1 = lane + 32 < m ? gmask[(size_t)(i0 + lane + 32) * words + rb] : 0ull;
    f0 = lane < m ? gvalid[i0 + lane] : 0;
    f1 = lane + 32 < m ? gvalid[i0 + lane + 32] : 0;
  };
  u64 d0, d1;
  uint8_t b0, b1;
  fetch(0, d0, d1, b0, b1);
  uint32_t phase = 0;
  int kept = 0;
  bool done = kept >= max_keep;  // warp-uniform
  int rb = 0;
  for (; rb < words && !done; ++rb) {
    u64 e0 = 0ull, e1 = 0ull;
    uint8_t f0 = 0, f1 = 0;
    if (rb + 1 < words) fetch(rb + 1, e0, e1, f0, f1);
    const int i0 = rb * kBlock;
    const int nrow = min(kBlock, n - i0);
    const u64 vword = (static_cast<u64>(__ballot_sync(full, b1 != 0)) << 32) |
                      __ballot_sync(full, b0 != 0);
    const u64 alive = vword & ~removed[rb];
    // the chunk's keep set: the fixpoint of nms_scan_kernel
    u64 kept_bits = alive;
    while (true) {  // warp-uniform
      const u64 mine = (((kept_bits >> lane) & 1ull) ? d0 : 0ull) |
                       (((kept_bits >> (lane + 32)) & 1ull) ? d1 : 0ull);
      const u64 sup = (static_cast<u64>(__reduce_or_sync(full, static_cast<unsigned>(mine >> 32)))
                       << 32) |
                      __reduce_or_sync(full, static_cast<unsigned>(mine));
      const u64 next = alive & ~sup;
      if (next == kept_bits) break;
      kept_bits = next;
    }
    if (kept + __popcll(kept_bits) >= max_keep) {  // keep only the first max_keep
      while (kept + __popcll(kept_bits) > max_keep) {
        kept_bits &= ~(1ull << (63 - __clzll(static_cast<long long>(kept_bits))));
      }
      done = true;
    }
    kept += __popcll(kept_bits);
    const int count = __popcll(kept_bits);
    if (!done && rb + 1 < words && count > 0) {
      if ((kept_bits >> lane) & 1ull) order[__popcll(kept_bits & ((1ull << lane) - 1))] = lane;
      if ((kept_bits >> (lane + 32)) & 1ull) {
        order[__popcll(kept_bits & ((1ull << (lane + 32)) - 1))] = lane + 32;
      }
      __syncwarp();
      // the kept rows' live words [rb + 1, W), a window of `span` words at a
      // time: row order[k]'s piece goes to stage[k * slot], from the even
      // word at or before the window's first (16-byte alignment) to the even
      // word at or after its end, so a piece takes at most span + 2 words
      const int slot = (kWideStageWords / count) & ~1;
      const int span = slot - 2;
      for (int wa = rb + 1; wa < words; wa += span) {
        const int wb = min(words, wa + span);
        uint32_t bytes[2] = {0u, 0u};
        const u64* src[2] = {nullptr, nullptr};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = lane + 32 * h;
          if (k < count) {
            const size_t row = (size_t)(i0 + order[k]) * words;  // the row's word 0
            const size_t first = (row + wa) & ~static_cast<size_t>(1);
            const size_t end = (row + wb + 1) & ~static_cast<size_t>(1);
            src[h] = gmask + first;
            bytes[h] = static_cast<uint32_t>((end - first) * sizeof(u64));
            piece[k] = k * slot + static_cast<int>(row + wa - first) - wa;
          }
        }
        const uint32_t total = __reduce_add_sync(full, bytes[0] + bytes[1]);
        if (lane == 0) expect_bytes(&bar, total);
        __syncwarp();
        // the stage was last read by this warp's generic loads, before the __syncwarp
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (bytes[h]) bulk_copy(stage + (lane + 32 * h) * slot, src[h], bytes[h], &bar);
        }
        bar_wait(&bar, phase);
        phase ^= 1u;
        for (int w = wa + lane; w < wb; w += 32) {
          u64 acc = 0ull;
#pragma unroll 4
          for (int k = 0; k < count; ++k) acc |= stage[piece[k] + w];
          removed[w] |= acc;
        }
        __syncwarp();  // every lane is done with the stage before it is refilled
      }
    }
    if (lane < nrow) gkeep[i0 + lane] = (kept_bits >> lane) & 1ull;
    if (lane + 32 < nrow) gkeep[i0 + 32 + lane] = (kept_bits >> (lane + 32)) & 1ull;
    __syncwarp();  // `order` and `piece` are read before the next chunk writes them
    d0 = e0;
    d1 = e1;
    b0 = f0;
    b1 = f1;
  }
  // after an early stop: the later boxes keep nothing
  for (int i = rb * kBlock + lane; i < n; i += 32) gkeep[i] = 0;
}

// The scan needs more than the default 48 KB of dynamic shared memory at
// large N; the attribute belongs to each of the kernel's instances on one
// device, so it is set once per device.
cudaError_t allow_scan_smem() {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(nms_scan_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               scan_smem_bytes(64));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(nms_scan_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               scan_smem_bytes(kMaxWords));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(nms_scan_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wide_smem_bytes(kWideMaxWords));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename Box>
int launch_mask(const void* boxes, void* mask, int g, int n, float thresh, float offset,
                void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int words = (n + kBlock - 1) / kBlock;
  if (words > kWideMaxWords || g > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // W (W + 1) / 2 tiles a problem: 200,010,000 at kWideMaxWords, and within
  // gridDim.x's 2^31 - 1 up to W = 65535; the product overflows an int from
  // W = 46341, so it is taken in 64 bits
  dim3 grid(static_cast<unsigned>(static_cast<long long>(words) * (words + 1) / 2), g);
  nms_mask_kernel<Box><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Box*>(boxes), static_cast<u64*>(mask), n, words, thresh, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes: [G, N, 4] float32, score-sorted per problem, 16-byte aligned; mask:
// [G, 64 * ceil(N/64), ceil(N/64)] uint64 output (rows past N are not
// written); N at most 64 * kWideMaxWords. Returns the cudaError_t of the
// launch.
extern "C" int nms_mask(const void* boxes, void* mask, int g, int n, float thresh,
                        float offset, void* stream) {
  return launch_mask<float4>(boxes, mask, g, n, thresh, offset, stream);
}

// nms_mask for bf16 boxes ([G, N, 4] bf16, 8-byte aligned), the IoU rounded
// to bf16 step by step; thresh is a bf16 value (the caller rounds it).
extern "C" int nms_mask_bf16(const void* boxes, void* mask, int g, int n, float thresh,
                             float offset, void* stream) {
  return launch_mask<uint2>(boxes, mask, g, n, thresh, offset, stream);
}

// mask: nms_mask's output, 16-byte aligned; valid: [G, N] uint8; keep: [G, N]
// uint8 output; N at most 64 * kWideMaxWords (the register instances up to
// 64 * kMaxWords, the wide scan past it); max_keep: the walk of a problem stops once that many boxes
// are kept (N or more: no limit). Returns the cudaError_t of the launch.
extern "C" int nms_scan(const void* mask, const void* valid, void* keep, int g, int n,
                        int max_keep, void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int words = (n + kBlock - 1) / kBlock;
  if (words > kWideMaxWords || max_keep < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = allow_scan_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (words > kMaxWords) {
    nms_scan_wide_kernel<<<g, 32, wide_smem_bytes(words), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(keep), n, words, max_keep);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = words <= 64 ? nms_scan_kernel<2> : nms_scan_kernel<4>;
  kernel<<<g, 32, scan_smem_bytes(words), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, words, max_keep);
  return static_cast<int>(cudaGetLastError());
}
