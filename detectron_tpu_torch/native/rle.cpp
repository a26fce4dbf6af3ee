// COCO-style run-length-encoded (RLE) mask operations.
//
// The port's copy of detectron_tpu/native/rle.cpp (same C ABI, same code):
// the codec that pycocotools' C maskApi would otherwise provide. Format
// (COCO spec): column-major scan of an H x W binary mask, alternating run
// lengths starting with the count of 0s.
//
// Exposed C ABI (ctypes-bound in detectron_tpu_torch/native/__init__.py):
//   rle_encode      : mask bytes -> counts
//   rle_decode      : counts -> mask bytes
//   rle_area        : sum of 1-runs
//   rle_iou         : pairwise IoU between two RLE sets (crowd flag support)
//   rle_merge       : union/intersection of two RLEs
//   rle_paste       : fused mask paste + encode
//   rle_to_string / rle_from_string : the COCO 6-bit char compression

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Encode a column-major HxW uint8 mask. counts_out must hold >= H*W+1
// entries. Returns the number of runs written.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* counts_out) {
  int64_t n = h * w;
  int64_t m = 0;
  uint8_t prev = 0;  // runs start with zeros
  uint32_t run = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      counts_out[m++] = run;
      run = 0;
      prev = v;
    }
    ++run;
  }
  counts_out[m++] = run;
  return m;
}

// Decode runs into a column-major HxW uint8 mask.
void rle_decode(const uint32_t* counts, int64_t m, int64_t h, int64_t w,
                uint8_t* mask_out) {
  int64_t pos = 0;
  uint8_t v = 0;
  int64_t n = h * w;
  for (int64_t i = 0; i < m && pos < n; ++i) {
    uint32_t run = counts[i];
    for (uint32_t j = 0; j < run && pos < n; ++j) mask_out[pos++] = v;
    v = 1 - v;
  }
  while (pos < n) mask_out[pos++] = 0;
}

uint64_t rle_area(const uint32_t* counts, int64_t m) {
  uint64_t a = 0;
  for (int64_t i = 1; i < m; i += 2) a += counts[i];
  return a;
}

// Intersection area of two RLEs (same H*W extent) via run merging.
static uint64_t rle_intersection(const uint32_t* ca, int64_t ma,
                                 const uint32_t* cb, int64_t mb) {
  uint64_t inter = 0;
  int64_t ia = 0, ib = 0;
  uint64_t enda = ca[0], endb = cb[0];  // absolute end of current run
  uint64_t pos = 0;
  uint8_t va = 0, vb = 0;
  while (ia < ma && ib < mb) {
    uint64_t next = enda < endb ? enda : endb;
    if (va && vb) inter += next - pos;
    pos = next;
    if (enda == next) {
      ++ia;
      if (ia < ma) enda += ca[ia];
      va = 1 - va;
    }
    if (endb == next) {
      ++ib;
      if (ib < mb) endb += cb[ib];
      vb = 1 - vb;
    }
  }
  return inter;
}

// Pairwise IoU between two RLE sets. Flattened counts with offsets.
// iscrowd: per-b flag; if set, IoU = intersection / area(a).
void rle_iou(const uint32_t* counts_a, const int64_t* off_a,
             const int64_t* len_a, int64_t na, const uint32_t* counts_b,
             const int64_t* off_b, const int64_t* len_b, int64_t nb,
             const uint8_t* iscrowd, double* iou_out) {
  for (int64_t i = 0; i < na; ++i) {
    uint64_t area_a = rle_area(counts_a + off_a[i], len_a[i]);
    for (int64_t j = 0; j < nb; ++j) {
      uint64_t area_b = rle_area(counts_b + off_b[j], len_b[j]);
      uint64_t inter = rle_intersection(counts_a + off_a[i], len_a[i],
                                        counts_b + off_b[j], len_b[j]);
      double denom;
      if (iscrowd && iscrowd[j])
        denom = (double)area_a;
      else
        denom = (double)(area_a + area_b - inter);
      iou_out[i * nb + j] = denom > 0 ? (double)inter / denom : 0.0;
    }
  }
}

// Union (mode=0) or intersection (mode=1) of two RLEs -> new counts.
int64_t rle_merge(const uint32_t* ca, int64_t ma, const uint32_t* cb,
                  int64_t mb, int mode, uint32_t* counts_out) {
  int64_t ia = 0, ib = 0, m = 0;
  uint64_t enda = ca[0], endb = cb[0], pos = 0;
  uint8_t va = 0, vb = 0, prev = 0;
  uint32_t run = 0;
  while (ia < ma && ib < mb) {
    uint64_t next = enda < endb ? enda : endb;
    uint8_t v = mode ? (va & vb) : (va | vb);
    if (v != prev) {
      counts_out[m++] = run;
      run = 0;
      prev = v;
    }
    run += (uint32_t)(next - pos);
    pos = next;
    if (enda == next) {
      ++ia;
      if (ia < ma) enda += ca[ia];
      va = 1 - va;
    }
    if (endb == next) {
      ++ib;
      if (ib < mb) endb += cb[ib];
      vb = 1 - vb;
    }
  }
  counts_out[m++] = run;
  return m;
}

// Fused mask paste + RLE encode (the eval path's per-detection
// full-image mask paste).
// Bilinear-resizes an msize x msize float32 mask probability grid into its
// box rectangle on an H x W canvas and emits the COLUMN-MAJOR full-image
// RLE directly, column by column — the canvas is never materialized, so
// the work is O(box area), not O(image area).
//
// The coordinate / clipping / interpolation math replicates
// detectron_tpu_torch.models.mask_rcnn.paste_masks_numpy bit-for-bit for
// float32 boxes (spans subtracted in float32, everything after in double,
// same op order), verified by tests/test_torch_rle.py.
// counts_out must hold >= h*w+1 entries. Returns the number of runs.
int64_t rle_paste(const float* mask, int64_t msize, const float* box,
                  int64_t h, int64_t w, double threshold,
                  uint32_t* counts_out) {
  struct Emitter {
    uint32_t* out;
    int64_t m = 0;
    uint8_t prev = 0;  // runs start with zeros
    uint64_t run = 0;
    void add(uint8_t v, uint64_t n) {
      if (n == 0) return;
      if (v != prev) {
        out[m++] = (uint32_t)run;
        run = 0;
        prev = v;
      }
      run += n;
    }
    int64_t finish() {
      out[m++] = (uint32_t)run;
      return m;
    }
  } e{counts_out};

  float x1 = box[0], y1 = box[1], x2 = box[2], y2 = box[3];
  int64_t x1i = (int64_t)floorf(x1), y1i = (int64_t)floorf(y1);
  int64_t x2i = (int64_t)ceilf(x2), y2i = (int64_t)ceilf(y2);
  // same clamp ORDER as the numpy path: far edge first (vs the unclamped
  // near edge), then the near edge
  x2i = std::min(std::max(x2i, x1i + 1), w);
  y2i = std::min(std::max(y2i, y1i + 1), h);
  x1i = std::min(std::max(x1i, (int64_t)0), w - 1);
  y1i = std::min(std::max(y1i, (int64_t)0), h - 1);
  int64_t bw = x2i - x1i, bh = y2i - y1i;
  if (bw <= 0 || bh <= 0) {
    e.add(0, (uint64_t)h * (uint64_t)w);
    return e.finish();
  }

  // spans in FLOAT32 (numpy: x2 - x1 on float32 scalars), then double
  float spanx_f = x2 - x1, spany_f = y2 - y1;
  double spanx = (double)spanx_f, spany = (double)spany_f;
  double denx = spanx_f > 1e-4f ? spanx : 1e-4;  // max(x2-x1, 1e-4)
  double deny = spany_f > 1e-4f ? spany : 1e-4;

  std::vector<int64_t> v0(bh), v1(bh);
  std::vector<double> fv(bh);
  for (int64_t i = 0; i < bh; ++i) {
    double ys = ((double)i + 0.5) * spany / (double)bh + (double)y1;
    double v = (ys - (double)y1) / deny * (double)msize - 0.5;
    int64_t iv = (int64_t)floor(v);
    int64_t c0 = std::min(std::max(iv, (int64_t)0), msize - 1);
    v0[i] = c0;
    v1[i] = std::min(c0 + 1, msize - 1);
    double f = v - (double)c0;
    fv[i] = f < 0.0 ? 0.0 : (f > 1.0 ? 1.0 : f);
  }

  e.add(0, (uint64_t)x1i * (uint64_t)h);  // whole columns left of the box
  uint64_t bottom = (uint64_t)(h - y1i - bh);
  for (int64_t j = 0; j < bw; ++j) {
    double xs = ((double)j + 0.5) * spanx / (double)bw + (double)x1;
    double u = (xs - (double)x1) / denx * (double)msize - 0.5;
    int64_t iu = (int64_t)floor(u);
    int64_t u0 = std::min(std::max(iu, (int64_t)0), msize - 1);
    int64_t u1 = std::min(u0 + 1, msize - 1);
    double f = u - (double)u0;
    double fu = f < 0.0 ? 0.0 : (f > 1.0 ? 1.0 : f);
    double gu = 1.0 - fu;
    e.add(0, (uint64_t)y1i);  // zeros above the box in this column
    for (int64_t i = 0; i < bh; ++i) {
      double top = (double)mask[v0[i] * msize + u0] * gu +
                   (double)mask[v0[i] * msize + u1] * fu;
      double bot = (double)mask[v1[i] * msize + u0] * gu +
                   (double)mask[v1[i] * msize + u1] * fu;
      double val = top * (1.0 - fv[i]) + bot * fv[i];
      e.add(val >= threshold ? 1 : 0, 1);
    }
    e.add(0, bottom);  // zeros below the box in this column
  }
  e.add(0, (uint64_t)(w - x2i) * (uint64_t)h);  // columns right of the box
  return e.finish();
}

// COCO compressed string form: delta + zigzag + 6-bit chunks offset by 48.
// out must hold >= 6*m+1 bytes. Returns string length.
int64_t rle_to_string(const uint32_t* counts, int64_t m, char* out) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t x = (int64_t)counts[i];
    if (i > 2) x -= (int64_t)counts[i - 2];  // delta vs same-parity prior
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[p++] = (char)(c + 48);
    }
  }
  out[p] = 0;
  return p;
}

int64_t rle_from_string(const char* s, int64_t slen, uint32_t* counts_out) {
  int64_t m = 0, p = 0;
  while (p < slen) {
    int64_t x = 0;
    int64_t k = 0;
    bool more = true;
    while (more && p < slen) {
      int64_t c = (int64_t)s[p++] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++k;
      if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
    }
    if (m > 2) x += (int64_t)counts_out[m - 2];
    counts_out[m++] = (uint32_t)x;
  }
  return m;
}

}  // extern "C"
