"""The card's peaks, and the least time each hand-written kernel could take
on the inputs that the timed path handed it.

A kernel's bound is the larger of its operations over the peak rate and
its bytes over the memory rate; each input byte is counted read once and
each output byte written once, and where the work depends on the data
the count is what these inputs need:

* K1 (greedy NMS): the IoU of each kept box against every later valid
  box, up to the ``max_keep``-th kept box where the walk stops, 16 float32
  operations a pair; bytes: the sorted boxes and valid flags read, the
  keep flags written (``[G, N]`` x (16 + 1 + 1)).
* K2 (multilevel RoIAlign forward): the distinct feature cells that the
  samples read over the batch, the output, the RoIs and their routing;
  operations: per output value, S^2 samples of four corners at a weight
  product and a scaled add each, and the division.
* K3 (its backward): g read once, every level's gradient written once,
  the RoIs and routing; the same operations.
"""

from __future__ import annotations

import torch

from benchmark.reference import ops

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

K1_KERNELS = ("nms_mask_kernel", "nms_scan_kernel", "nms_scan_wide_kernel")
K2_KERNELS = ("roi_align_forward_kernel", "roi_align_forward_bf16_kernel",
              "roi_align_forward_wide_kernel")
K3_KERNELS = ("roi_align_backward_kernel", "roi_tap_bounds_kernel",
              "roi_align_backward_tiles_kernel", "roi_align_backward_wide_kernel",
              "roi_tap_bounds_wide_kernel")


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS)


def k1_pairs(sboxes, svalid, thresh: float, max_keep: int | None) -> int:
    """IoU pairs the greedy walk must test on these sorted problems."""
    keep = ops.greedy_keep(sboxes.float(), svalid, thresh, max_keep=max_keep)
    g, n = svalid.shape
    m = max_keep if max_keep is not None else n
    pos = torch.arange(n, device=svalid.device)[None, :]
    n_valid = svalid.sum(1, keepdim=True)
    last = torch.where(keep, pos, torch.full_like(pos, -1)).amax(1, keepdim=True)
    stop = torch.where(keep.sum(1, keepdim=True) >= m, last, torch.full_like(last, n - 1))
    upto = torch.minimum(n_valid, stop + 1)
    return int(torch.where(keep, upto - 1 - pos, torch.zeros_like(pos)).sum())


def k1_bound_s(sboxes, svalid, thresh: float, max_keep: int | None) -> float:
    g, n = svalid.shape
    return bound_s(g * n * (16 + 1 + 1), 16.0 * k1_pairs(sboxes, svalid, thresh, max_keep))


def roi_ops(b: int, r: int, p: int, c: int, s: int) -> float:
    return float(b * r * p * p * c * (s * s * 4 * 3 + 1))


def k2_bound_s(features, rois, strides, p: int, s: int, max_span) -> float:
    """K2's bound on NHWC ``features`` and ``rois [B, R, 4]``."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    elem = features[0].element_size()
    level_hw = [tuple(f.shape[1:3]) for f in features]
    levels = ops.assign_levels(rois.float(), len(features), 2, max_span)
    base, wrow, ys, xs = ops.sample_geometry(level_hw, rois.float(), levels, strides, p, s)
    inb = ys[4][..., :, None] & xs[4][..., None, :]
    total = sum(h * w for h, w in level_hw)
    image = torch.arange(b, device=rois.device)[:, None, None, None] * total
    cells = torch.unique(torch.cat([(image + idx)[inb] for idx, _ in
                                    ops.corners(base, wrow, ys, xs)])).numel()
    nbytes = cells * c * elem + b * r * p * p * c * elem + b * r * (16 + 4)
    return bound_s(nbytes, roi_ops(b, r, p, c, s))


def k3_bound_s(b: int, r: int, p: int, c: int, level_hw, s: int, elem: int) -> float:
    """K3's bound for a gradient ``[B, R, P, P, C]`` of ``elem`` bytes a value."""
    nbytes = (b * r * p * p * c * elem + sum(b * h * w * c for h, w in level_hw) * elem
              + b * r * (16 + 4))
    return bound_s(nbytes, roi_ops(b, r, p, c, s))
