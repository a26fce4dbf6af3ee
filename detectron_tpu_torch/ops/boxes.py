"""Box geometry: IoU overlaps, encode/decode, clip, validity.

The port of ``detectron_tpu/ops/boxes.py``. Boxes are ``(x1, y1, x2, y2)``
in pixel coordinates, shape ``[..., 4]``; every function broadcasts over
leading dims. The operation order follows the JAX functions one for one,
because NMS compares IoUs against a threshold and a different rounding
could change the keep set. ``offset=1`` selects the legacy ``+1`` width
convention.
"""

from __future__ import annotations

import torch

EPS = 1e-8

# Log-space box size clamp, ln(1000/16): keeps exp() in decode finite
# (Detectron's BBOX_XFORM_CLIP).
BBOX_XFORM_CLIP = 4.135166556742356


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` with IEEE division on every device. PyTorch's CUDA
    kernels turn division by a Python number into multiplication by its
    reciprocal, which rounds differently from the JAX package (and from
    PyTorch on the CPU); a divisor tensor on ``x``'s device does not."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def box_wh(boxes: torch.Tensor, offset: float = 0.0):
    w = boxes[..., 2] - boxes[..., 0] + offset
    h = boxes[..., 3] - boxes[..., 1] + offset
    return w, h


def box_area(boxes: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    w, h = box_wh(boxes, offset)
    return w.clamp_min(0.0) * h.clamp_min(0.0)


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor,
                  offset: float = 0.0) -> torch.Tensor:
    """IoU matrix ``[..., N, K]`` between ``boxes [..., N, 4]`` and
    ``query_boxes [..., K, 4]``."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    lt = torch.maximum(b[..., :2], q[..., :2])
    rb = torch.minimum(b[..., 2:], q[..., 2:])
    wh = (rb - lt + offset).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_b = box_area(boxes, offset)[..., :, None]
    area_q = box_area(query_boxes, offset)[..., None, :]
    union = area_b + area_q - inter
    return inter / union.clamp_min(EPS)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """Elementwise IoU ``[...]`` of two aligned box arrays ``[..., 4]``."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt + offset).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a, offset) + box_area(b, offset) - inter
    return inter / union.clamp_min(EPS)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0), offset: float = 0.0):
    """Encode target ``boxes`` relative to ``anchors`` as weighted
    ``(tx, ty, tw, th)``."""
    aw, ah = box_wh(anchors, offset)
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw, gh = box_wh(boxes, offset)
    gx = boxes[..., 0] + 0.5 * gw
    gy = boxes[..., 1] + 0.5 * gh
    aw = aw.clamp_min(EPS)
    ah = ah.clamp_min(EPS)
    wx, wy, ww, wh_ = weights
    tx = wx * (gx - ax) / aw
    ty = wy * (gy - ay) / ah
    tw = ww * torch.log(gw.clamp_min(EPS) / aw)
    th = wh_ * torch.log(gh.clamp_min(EPS) / ah)
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0), offset: float = 0.0):
    """Inverse of :func:`encode_boxes`, with the exp clamp."""
    aw, ah = box_wh(anchors, offset)
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    wx, wy, ww, wh_ = weights
    tx = true_div(deltas[..., 0], wx)
    ty = true_div(deltas[..., 1], wy)
    tw = true_div(deltas[..., 2], ww).clamp_max(BBOX_XFORM_CLIP)
    th = true_div(deltas[..., 3], wh_).clamp_max(BBOX_XFORM_CLIP)
    cx = tx * aw + ax
    cy = ty * ah + ay
    w = torch.exp(tw) * aw
    h = torch.exp(th) * ah
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w - offset, cy + 0.5 * h - offset],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, height, width, offset: float = 0.0):
    """Clip to ``[0, width-offset] x [0, height-offset]``; ``height`` and
    ``width`` are floats or tensors that broadcast against ``boxes[..., 0]``."""
    def limit(v):
        return torch.as_tensor(v - offset, dtype=boxes.dtype, device=boxes.device)

    hmax, wmax = limit(height), limit(width)
    return torch.stack(
        [torch.minimum(boxes[..., i].clamp_min(0.0), m)
         for i, m in enumerate((wmax, hmax, wmax, hmax))],
        dim=-1,
    )


def valid_box_mask(boxes: torch.Tensor, min_size: float = 0.0, offset: float = 0.0):
    """Boxes with both sides >= ``min_size`` (a mask, so shapes stay fixed)."""
    w, h = box_wh(boxes, offset)
    return (w >= min_size) & (h >= min_size)
