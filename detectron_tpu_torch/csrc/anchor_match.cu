// The RPN's anchor matching as one hand-written pass pair, for Hopper
// (sm_90a): each anchor's best gt, its positive / negative labels by the IoU
// thresholds, and the force-match of every gt's best anchor(s), without the
// [B, N, G] IoU tensor ever in device memory.
//
// Replaces no Pallas kernel. It takes the place of the matching half of
// layers/anchor_target.py (ops/anchor_match.py::anchor_match_plain): the
// IoU of every anchor with every gt slot (ops/boxes.py::bbox_overlaps), the
// padding rows set to -1, the per-anchor max and first argmax, the per-gt
// max over anchors, and the force-match masks. Eager PyTorch runs those as
// a dozen broadcast passes over [B, N, G] float32 (B=16, N=343,728, G=100:
// 2.2e9 B a copy, up to ~22e9 B live at once inside bbox_overlaps).
//
// Two launches on the caller's stream:
//   gt_best_kernel   every gt's best IoU over all anchors, folded into a
//                    [B, G] buffer (zeroed first) by an integer atomicMax
//                    on the float's bits: an IoU is >= +0, whose bit
//                    patterns order as integers. A valid gt that overlaps
//                    nothing keeps +0 and then forces nothing (the iou > 0
//                    guard), as the eager chain's does.
//   match_kernel     each anchor's IoU with every valid gt once more: the
//                    running max and its first index, the first gt it is a
//                    best anchor for (iou >= per_gt_max - tol, iou > 0),
//                    then pos / neg / matched as the eager torch.where chain
//                    leaves them.
// Without force_match the first launch is skipped.
//
// Bit for bit the eager chain. Every IoU follows bbox_overlaps's order with
// the _rn intrinsics, so that no FMA contracts across a rounding:
//   w = max(fl(fl(min(x2) - max(x1)) + offset), 0), h likewise,
//   inter = fl(w * h), union = max(fl(fl(area_a + area_g) - inter), eps),
//   iou = fl(inter / union)  (IEEE division; inter == 0 gives +0 at once),
// the areas as ops/boxes.py::box_area rounds them. The thresholds, eps and
// the tie tolerance arrive as float32 (PyTorch rounds a Python scalar
// against a float32 tensor the same way), and per_gt_max - tol is a float32
// subtract. Padding slots (class <= 0) are skipped: their IoU is -1 in the
// eager chain, below every valid IoU (>= 0), so they never win a max or an
// argmax that a valid slot contests; where no slot is valid the max stays
// -1 and the argmax 0, as argmax over a row of -1 gives. Slots are visited
// in index order and only a strictly larger IoU replaces the best, so ties
// go to the lowest index, as argmax's do. Boxes are taken finite.
//
// What bounds it on the H100: the IoUs, on the FP32 pipes (no tensor-core
// form: each is a handful of min / max / sub / mul and, where two boxes
// overlap, one IEEE division). Bytes are small: the anchors (16 B each) and
// the gt in, 10 B an (image, anchor) out. Design:
//   - a block per (image, tile of kTile anchors); each thread keeps kPer
//     anchors and their areas in registers for the whole pass;
//   - the image's gt slots are staged in shared memory in chunks of
//     kThreads, compacted to the valid ones (a warp ballot and a prefix over
//     the warps), so any G works and padding costs one load a slot;
//   - every thread of a block reads the same staged gt at once (a shared
//     memory broadcast); a pair that does not overlap skips the division;
//   - gt_best_kernel reduces each gt's max over a warp in one instruction
//     (__reduce_max_sync on the bits), over the block in shared memory, and
//     folds the block's max into device memory with one atomic a gt.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;  // anchors a thread
constexpr int kTile = kThreads * kPer;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* anchors;  // [N, 4]
  const float* gt;       // [B, G, 4]
  const void* classes;   // [B, G] int32 or int64; > 0 marks a valid slot
  int classes_int64;
  long long n;
  int g;
  float pos_iou, neg_iou, tie_tol, eps, offset;
  int* best;  // [B, G] float32 bits: each gt's best IoU over the anchors
  long long* matched;  // [B, N]
  unsigned char* pos;  // [B, N] bool
  unsigned char* neg;  // [B, N] bool
};

struct Box {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2, float off) {
  const float w = fmaxf(__fadd_rn(__fsub_rn(x2, x1), off), 0.f);
  const float h = fmaxf(__fadd_rn(__fsub_rn(y2, y1), off), 0.f);
  return __fmul_rn(w, h);
}

__device__ __forceinline__ Box load_anchor(const Params& p, long long i) {
  Box a{0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < p.n) {
    a.x1 = __ldg(p.anchors + 4 * i);
    a.y1 = __ldg(p.anchors + 4 * i + 1);
    a.x2 = __ldg(p.anchors + 4 * i + 2);
    a.y2 = __ldg(p.anchors + 4 * i + 3);
    a.area = box_area(a.x1, a.y1, a.x2, a.y2, p.offset);
  }
  return a;
}

// bbox_overlaps's IoU of one anchor and one gt, rounded as it rounds.
__device__ __forceinline__ float iou(const Box& a, const Box& q, const Params& p) {
  const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(a.x2, q.x2), fmaxf(a.x1, q.x1)), p.offset), 0.f);
  const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(a.y2, q.y2), fmaxf(a.y1, q.y1)), p.offset), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f;  // 0 / union, union >= eps > 0
  const float uni = fmaxf(__fsub_rn(__fadd_rn(a.area, q.area), inter), p.eps);
  return __fdiv_rn(inter, uni);
}

// Stages the valid slots among [c0, c0 + kThreads) of image img, in index
// order: their boxes (with areas), their slot indices and, with kThr, their
// tie thresholds per_gt_max - tol. Returns how many; every thread of the
// block must call it, and the slots stay staged until the next call, which
// a __syncthreads must precede.
template <bool kThr>
__device__ int stage_chunk(const Params& p, int img, int c0, Box* s_box, int* s_idx,
                           float* s_thr, int* s_count) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = c0 + t;
  const long long k = static_cast<long long>(img) * p.g + slot;
  bool valid = false;
  if (slot < p.g) {
    const long long c = p.classes_int64 ? static_cast<const long long*>(p.classes)[k]
                                        : static_cast<const int*>(p.classes)[k];
    valid = c > 0;
  }
  const unsigned ballot = __ballot_sync(kFull, valid);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (valid) {
    const int at = base + __popc(ballot & ((1u << lane) - 1u));
    const float* q = p.gt + 4 * k;
    const float x1 = q[0], y1 = q[1], x2 = q[2], y2 = q[3];
    s_box[at] = Box{x1, y1, x2, y2, box_area(x1, y1, x2, y2, p.offset)};
    s_idx[at] = slot;
    if (kThr) s_thr[at] = __fsub_rn(__int_as_float(p.best[k]), p.tie_tol);
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) gt_best_kernel(Params p) {
  __shared__ Box s_box[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ int s_best[kThreads];
  __shared__ int s_count[kWarps];
  const int img = blockIdx.y, t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kTile + t;
  Box a[kPer];
  int live = 0;  // this thread's anchors below N, a prefix of a[]
  for (int k = 0; k < kPer; ++k) {
    a[k] = load_anchor(p, first + k * kThreads);
    live += first + k * kThreads < p.n;
  }
  for (int c0 = 0; c0 < p.g; c0 += kThreads) {
    s_best[t] = 0;
    const int count = stage_chunk<false>(p, img, c0, s_box, s_idx, nullptr, s_count);
    for (int j = 0; j < count; ++j) {
      const Box q = s_box[j];
      int m = 0;  // +0.0f, the max of a thread with no anchor below N
      for (int k = 0; k < live; ++k) {
        const int bits = __float_as_int(iou(a[k], q, p));
        m = bits > m ? bits : m;
      }
      m = __reduce_max_sync(kFull, m);
      if ((t & 31) == 0 && m > 0) atomicMax(s_best + j, m);
    }
    __syncthreads();
    if (t < count && s_best[t] > 0)
      atomicMax(p.best + static_cast<long long>(img) * p.g + s_idx[t], s_best[t]);
    __syncthreads();
  }
}

template <bool kForce>
__global__ void __launch_bounds__(kThreads) match_kernel(Params p) {
  __shared__ Box s_box[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ float s_thr[kThreads];
  __shared__ int s_count[kWarps];
  const int img = blockIdx.y, t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kTile + t;
  Box a[kPer];
  float best[kPer];
  int arg[kPer], forced[kPer];
  for (int k = 0; k < kPer; ++k) {
    a[k] = load_anchor(p, first + k * kThreads);
    best[k] = -1.f;  // the padding rows' IoU: the max where no slot is valid
    arg[k] = 0;
    forced[k] = -1;
  }
  for (int c0 = 0; c0 < p.g; c0 += kThreads) {
    const int count = stage_chunk<kForce>(p, img, c0, s_box, s_idx, s_thr, s_count);
    for (int j = 0; j < count; ++j) {
      const Box q = s_box[j];
      const int slot = s_idx[j];
      const float thr = kForce ? s_thr[j] : 0.f;
      for (int k = 0; k < kPer; ++k) {
        const float v = iou(a[k], q, p);
        if (v > best[k]) {
          best[k] = v;
          arg[k] = slot;
        }
        if (kForce && forced[k] < 0 && v > 0.f && v >= thr) forced[k] = slot;
      }
    }
    __syncthreads();
  }
  for (int k = 0; k < kPer; ++k) {
    const long long i = first + k * kThreads;
    if (i >= p.n) continue;
    bool is_pos = best[k] >= p.pos_iou;
    bool is_neg = best[k] < p.neg_iou;
    int m = arg[k];
    if (kForce && forced[k] >= 0) {
      if (!is_pos) m = forced[k];
      is_pos = true;
      is_neg = false;
    }
    const long long o = static_cast<long long>(img) * p.n + i;
    p.matched[o] = m;
    p.pos[o] = is_pos;
    p.neg[o] = is_neg;
  }
}

}  // namespace

// Matches anchors [n, 4] against gt [b, g, 4] (classes [b, g], int32 or
// int64 by classes_int64; > 0 marks a valid slot): writes matched [b, n]
// int64, pos and neg [b, n] bool, as ops/anchor_match.py::anchor_match_plain
// gives them. best is [b, g] scratch of 4-byte words (used with
// force_match). Returns a CUDA error code (0: both launches accepted).
extern "C" int anchor_match(const float* anchors, const float* gt, const void* classes,
                            int classes_int64, long long n, int b, int g, float pos_iou,
                            float neg_iou, float tie_tol, float eps, float offset,
                            int force_match, void* best, void* matched, void* pos, void* neg,
                            void* stream) {
  if (n <= 0 || b <= 0) return cudaSuccess;
  const Params p{anchors, gt, classes, classes_int64, n, g, pos_iou, neg_iou, tie_tol, eps,
                 offset, static_cast<int*>(best), static_cast<long long*>(matched),
                 static_cast<unsigned char*>(pos), static_cast<unsigned char*>(neg)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile), static_cast<unsigned>(b));
  const dim3 block(kThreads);
  if (force_match) {
    const size_t bytes = sizeof(int) * static_cast<size_t>(b) * g;
    cudaError_t err = bytes ? cudaMemsetAsync(best, 0, bytes, s) : cudaSuccess;
    if (err != cudaSuccess) return err;
    gt_best_kernel<<<grid, block, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    match_kernel<true><<<grid, block, 0, s>>>(p);
  } else {
    match_kernel<false><<<grid, block, 0, s>>>(p);
  }
  return cudaGetLastError();
}
