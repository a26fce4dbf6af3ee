"""The RPN's anchor matching: each anchor's best gt and its labels.

The matching half of :func:`detectron_tpu_torch.layers.anchor_target.anchor_target`:
the IoU of every anchor with every gt slot, each anchor's best valid gt
(the first on ties), ``pos`` at or above ``pos_iou`` and ``neg`` below
``neg_iou``, and with ``force_match`` every valid gt's best anchor(s)
forced positive and pointed at that gt. Padding slots (class 0) never
match.

On CUDA tensors :func:`anchor_match` launches the hand-written kernels of
``csrc/anchor_match.cu`` (:func:`anchor_match_cuda`), which never store the
``[B, N, G]`` IoU tensor and take float32 boxes alone; on CPU tensors it
runs :func:`anchor_match_plain`, the eager op sequence. The two agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from detectron_tpu_torch import _build
from detectron_tpu_torch.ops import boxes as box_ops

TIE_TOL = 1e-6  # a gt's best anchors: IoU within this of its max


def anchor_match_plain(anchors, gt_boxes, gt_classes, pos_iou: float, neg_iou: float,
                       force_match: bool = True, offset: float = 0.0):
    """The eager op sequence. anchors ``[N, 4]``; gt_boxes ``[B, G, 4]``;
    gt_classes ``[B, G]`` (0 = padding row). Returns ``(matched, pos, neg)``:
    ``[B, N]`` int64 gt indices and two bool masks."""
    gt_valid = gt_classes > 0  # [B, G]
    iou = box_ops.bbox_overlaps(anchors, gt_boxes, offset=offset)  # [B, N, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))

    max_iou = iou.amax(dim=2)  # [B, N]
    matched = iou.argmax(dim=2)  # first maximum, as jnp.argmax

    pos = max_iou >= pos_iou
    # anchors overlapping nothing (images with zero gt too) are negatives
    neg = max_iou < neg_iou
    if force_match:
        # every valid gt's best anchor(s) become positive, ties included
        per_gt_max = iou.amax(dim=1)  # [B, G]
        is_best = (iou >= per_gt_max[:, None, :] - TIE_TOL) & gt_valid[:, None, :] & (iou > 0.0)
        forced = is_best.any(dim=2)
        # re-point the match at the gt this anchor is best for
        forced_gt = is_best.to(torch.uint8).argmax(dim=2)
        matched = torch.where(forced & ~pos, forced_gt, matched)
        pos = pos | forced
        neg = neg & ~forced
    return matched, pos, neg


@functools.cache
def _anchor_match_lib() -> ctypes.CDLL:
    lib = _build.load("anchor_match")
    i32, i64, f32, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    lib.anchor_match.argtypes = ([ptr] * 3 + [i32, i64, i32, i32] + [f32] * 5 + [i32]
                                 + [ptr] * 5)
    lib.anchor_match.restype = i32
    return lib


def _checked(anchors, gt_boxes, gt_classes):
    what = "anchor_match_cuda"
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 boxes, not {anchors.dtype} and {gt_boxes.dtype}")
    if not (anchors.is_cuda and gt_boxes.device == anchors.device
            and gt_classes.device == anchors.device):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if anchors.dim() != 2 or anchors.shape[1] != 4 or gt_boxes.dim() != 3 \
            or gt_boxes.shape[2] != 4 or gt_classes.shape != gt_boxes.shape[:2]:
        raise ValueError(f"{what}: anchors {tuple(anchors.shape)}, gt {tuple(gt_boxes.shape)}, "
                         f"classes {tuple(gt_classes.shape)}; want [N, 4], [B, G, 4], [B, G]")
    if gt_classes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what} takes int32 or int64 classes, not {gt_classes.dtype}")
    return anchors.contiguous(), gt_boxes.contiguous(), gt_classes.contiguous()


def anchor_match_cuda(anchors, gt_boxes, gt_classes, pos_iou: float, neg_iou: float,
                      force_match: bool = True, offset: float = 0.0):
    """:func:`anchor_match_plain` by the kernels of ``csrc/anchor_match.cu``:
    with ``force_match`` two launches (each gt's best IoU, then the match),
    else the match alone. Never synchronises with the host; counts its
    kernel launches."""
    anchors, gt_boxes, gt_classes = _checked(anchors, gt_boxes, gt_classes)
    (n, _), (b, g, _) = anchors.shape, gt_boxes.shape
    dev = anchors.device
    matched = torch.empty((b, n), dtype=torch.int64, device=dev)
    pos = torch.empty((b, n), dtype=torch.bool, device=dev)
    neg = torch.empty((b, n), dtype=torch.bool, device=dev)
    best = torch.empty((b, g) if force_match else (0,), dtype=torch.int32, device=dev)
    if n and b:
        with torch.cuda.device(dev):
            err = _anchor_match_lib().anchor_match(
                anchors.data_ptr(), gt_boxes.data_ptr(), gt_classes.data_ptr(),
                int(gt_classes.dtype == torch.int64), n, b, g, pos_iou, neg_iou, TIE_TOL,
                box_ops.EPS, offset, int(force_match), best.data_ptr(), matched.data_ptr(),
                pos.data_ptr(), neg.data_ptr(), _build.stream_handle(dev))
        _build.check(err, "anchor_match_cuda")
        anchor_match_cuda.launches += 2 if force_match else 1
    return matched, pos, neg


anchor_match_cuda.launches = 0


def anchor_match(anchors, gt_boxes, gt_classes, pos_iou: float, neg_iou: float,
                 force_match: bool = True, offset: float = 0.0):
    """``(matched, pos, neg)`` of :func:`anchor_match_plain`: the kernels on
    CUDA tensors (float32 boxes; the kernels refuse any other dtype), the
    eager ops on CPU tensors."""
    if anchors.is_cuda:
        return anchor_match_cuda(anchors, gt_boxes, gt_classes, pos_iou, neg_iou,
                                 force_match, offset)
    return anchor_match_plain(anchors, gt_boxes, gt_classes, pos_iou, neg_iou, force_match,
                              offset)
