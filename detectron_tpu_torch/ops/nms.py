"""Static-shape greedy non-maximum suppression.

The port of ``detectron_tpu/ops/nms.py`` with the same contract: every
entry point returns ``(int32 idx[..., max_out], bool valid[..., max_out])``
where ``idx`` points into the input arrays, kept boxes come in descending
score order, and invalid slots hold index 0.

The steps around the greedy walk are plain PyTorch, as they sit outside
``pallas_call`` in the JAX package: a stable descending sort (ties keep the
lower index first, as ``jax.lax.top_k`` does), and the compaction of the
kept boxes into the output slots. The greedy walk itself is
:func:`greedy_keep`: on a CUDA tensor it launches the hand-written kernel
in ``csrc/nms.cu`` (the port of ``detectron_tpu/ops/nms_pallas.py``), on a
CPU tensor it runs :func:`greedy_keep_plain`, the same function in plain
PyTorch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from detectron_tpu_torch import _build
from detectron_tpu_torch.ops.boxes import bbox_overlaps

NEG_INF = -1e10


def sort_desc(x: torch.Tensor):
    """Descending sort along the last dim, ties in index order (the order
    ``jax.lax.top_k`` gives)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def greedy_keep_plain(sboxes: torch.Tensor, svalid: torch.Tensor,
                      thresh: float, offset: float = 0.0) -> torch.Tensor:
    """Greedy keep mask ``[G, N]`` of score-sorted ``sboxes [G, N, 4]``:
    box j is suppressed by an earlier kept valid box i with IoU > thresh;
    invalid boxes neither keep nor suppress."""
    g, n = svalid.shape
    later = torch.ones(n, n, dtype=torch.bool, device=sboxes.device).triu(1)
    sup = (bbox_overlaps(sboxes, sboxes, offset) > thresh) & later
    keep = torch.ones(g, n, dtype=torch.bool, device=sboxes.device)
    for i in range(n):
        alive = keep[:, i] & svalid[:, i]
        keep &= ~(alive[:, None] & sup[:, i])
    return keep & svalid


def _nms_lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    lib.nms_keep.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    lib.nms_keep.restype = ctypes.c_int
    lib.nms_max_boxes.restype = ctypes.c_int
    return lib


def greedy_keep_cuda(sboxes: torch.Tensor, svalid: torch.Tensor,
                     thresh: float, offset: float = 0.0) -> torch.Tensor:
    """:func:`greedy_keep_plain` as the CUDA kernel pair of ``csrc/nms.cu``:
    one launch of all IoU bit masks, one launch of the sequential scans,
    for all G problems at once. Never synchronises with the host."""
    if not (sboxes.is_cuda and svalid.device == sboxes.device):
        raise ValueError("greedy_keep_cuda takes CUDA tensors on one device")
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool:
        raise TypeError("greedy_keep_cuda takes float32 boxes and bool valid")
    if sboxes.dim() != 3 or sboxes.shape[2] != 4 or svalid.shape != sboxes.shape[:2]:
        raise ValueError(f"shapes {tuple(sboxes.shape)} / {tuple(svalid.shape)}: "
                         "want boxes [G, N, 4] and valid [G, N]")
    if not (sboxes.is_contiguous() and svalid.is_contiguous()):
        raise ValueError("greedy_keep_cuda takes contiguous tensors")
    if sboxes.data_ptr() % 16:
        raise ValueError("greedy_keep_cuda reads boxes as float4: 16-byte alignment")
    g, n = svalid.shape
    lib = _nms_lib()
    if n > lib.nms_max_boxes():
        raise ValueError(f"NMS over {n} boxes: the kernel takes at most "
                         f"{lib.nms_max_boxes()}")
    words = -(-n // 64)
    mask = torch.empty((g, n, words), dtype=torch.int64, device=sboxes.device)
    keep = torch.empty((g, n), dtype=torch.bool, device=sboxes.device)
    with torch.cuda.device(sboxes.device):
        err = lib.nms_keep(sboxes.data_ptr(), svalid.data_ptr(), mask.data_ptr(),
                           keep.data_ptr(), g, n, thresh, offset,
                           _build.stream_handle(sboxes.device))
    _build.check(err, "nms_keep")
    greedy_keep_cuda.launches += 1
    return keep


greedy_keep_cuda.launches = 0


def greedy_keep(sboxes: torch.Tensor, svalid: torch.Tensor, thresh: float,
                offset: float = 0.0) -> torch.Tensor:
    """Kernel K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if sboxes.is_cuda:
        return greedy_keep_cuda(sboxes, svalid, thresh, offset)
    return greedy_keep_plain(sboxes, svalid, thresh, offset)


def nms_padded_batched(boxes: torch.Tensor, scores: torch.Tensor,
                       valid: torch.Tensor | None, thresh: float, max_out: int,
                       offset: float = 0.0):
    """Greedy NMS over G independent problems.

    boxes ``[G, N, 4]``, scores ``[G, N]``, valid ``[G, N]`` bool (None =
    all valid). Returns ``(idx [G, max_out] int32, valid [G, max_out])``.
    """
    g, n = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order_scores, order = sort_desc(masked)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(g, n, 4)).contiguous()
    svalid = (order_scores > NEG_INF / 2).contiguous()
    keep = greedy_keep(sboxes, svalid, thresh, offset)
    # kept boxes in sorted order fill the first slots (what top_k of the
    # kept scores gives, ties in index order); the rest are invalid
    m = min(max_out, n)
    rank = keep.cumsum(1) - 1
    slot = torch.where(keep & (rank < m), rank, torch.full_like(rank, m))
    out = torch.zeros((g, m + 1), dtype=order.dtype, device=order.device)
    out.scatter_(1, slot, order)
    out_valid = torch.arange(m, device=keep.device)[None, :] < keep.sum(1, keepdim=True)
    out_idx = torch.where(out_valid, out[:, :m], torch.zeros_like(out[:, :m]))
    if max_out > n:
        pad = max_out - n
        out_idx = torch.cat([out_idx, out_idx.new_zeros((g, pad))], 1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((g, pad))], 1)
    return out_idx.to(torch.int32), out_valid


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_out: int, valid: torch.Tensor | None = None,
               offset: float = 0.0):
    """One problem: boxes ``[N, 4]``, scores ``[N]`` ->
    ``(idx [max_out] int32, valid [max_out] bool)``."""
    idx, ok = nms_padded_batched(
        boxes[None], scores[None], None if valid is None else valid[None],
        iou_threshold, max_out, offset)
    return idx[0], ok[0]


def class_aware_nms(boxes: torch.Tensor, scores: torch.Tensor,
                    classes: torch.Tensor, iou_threshold: float, max_out: int,
                    valid: torch.Tensor | None = None, offset: float = 0.0):
    """Per-class NMS in one pass by the class-offset trick: each box moves
    by ``class * span`` with ``span = max(boxes) - min(boxes) + 1`` (per
    problem), so boxes of different classes never overlap. Takes one
    problem (``boxes [N, 4]``) or a batch (``boxes [G, N, 4]``)."""
    if boxes.dim() == 2:
        idx, ok = class_aware_nms(
            boxes[None], scores[None], classes[None], iou_threshold, max_out,
            None if valid is None else valid[None], offset)
        return idx[0], ok[0]
    span = boxes.amax(dim=(1, 2)) - boxes.amin(dim=(1, 2)) + 1.0  # [G]
    shift = (classes.to(boxes.dtype) * span[:, None])[..., None]
    return nms_padded_batched(boxes + shift, scores, valid, iou_threshold,
                              max_out, offset)


def nms_numpy(dets: np.ndarray, thresh: float, offset: float = 0.0) -> list[int]:
    """Host greedy NMS (a copy of the JAX package's oracle); ``dets`` rows
    are ``(x1, y1, x2, y2, score)``."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + offset) * (y2 - y1 + offset)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + offset)
        h = np.maximum(0.0, yy2 - yy1 + offset)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return keep
