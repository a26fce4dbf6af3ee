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
import functools

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
                      thresh: float, offset: float = 0.0,
                      max_keep: int | None = None) -> torch.Tensor:
    """Greedy keep mask ``[G, N]`` of score-sorted ``sboxes [G, N, 4]``:
    box j is suppressed by an earlier kept valid box i with IoU > thresh;
    invalid boxes neither keep nor suppress. With ``max_keep``, only the
    first ``max_keep`` kept boxes of each problem keep their flag."""
    g, n = svalid.shape
    later = torch.ones(n, n, dtype=torch.bool, device=sboxes.device).triu(1)
    sup = (bbox_overlaps(sboxes, sboxes, offset) > thresh) & later
    keep = torch.ones(g, n, dtype=torch.bool, device=sboxes.device)
    for i in range(n):
        alive = keep[:, i] & svalid[:, i]
        keep &= ~(alive[:, None] & sup[:, i])
    keep &= svalid
    if max_keep is not None:
        keep &= keep.cumsum(1) <= max_keep
    return keep


@functools.cache
def _nms_lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    for fn in (lib.nms_mask, lib.nms_mask_bf16):
        fn.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.nms_scan.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.nms_mask, lib.nms_mask_bf16, lib.nms_scan):
        fn.restype = ctypes.c_int
    return lib


# The box dtypes K1 has an instance for: the JAX config's model.dtype takes
# float32 and bfloat16, and the JAX kernel computes the IoU in the boxes' dtype.
BOX_DTYPES = (torch.float32, torch.bfloat16)


def threshold_in(thresh: float, dtype: torch.dtype) -> float:
    """``thresh`` as ``iou > thresh`` compares it with IoUs of ``dtype``:
    PyTorch and JAX both round a Python number to a bf16 tensor's dtype
    (0.7 -> 0.69921875); float32 is what the kernel's ``float`` gives."""
    return float(torch.tensor(thresh, dtype=dtype)) if dtype == torch.bfloat16 else thresh


def nms_mask_cuda(sboxes: torch.Tensor, thresh: float, offset: float = 0.0) -> torch.Tensor:
    """The first launch of K1: every IoU bit of the upper triangle, as
    ``int64 [G, 64 * W, W]`` words (``W = ceil(N / 64)``; the rows past N
    are padding that the scan never reads), by the instance of the boxes'
    dtype (bf16: the IoU rounded to bf16 step by step, against ``thresh``
    rounded to bf16). Takes what :func:`greedy_keep_cuda` has checked;
    counts nothing (the pair counts as one launch of K1)."""
    g, n = sboxes.shape[:2]
    words = -(-n // 64)
    mask = torch.empty((g, 64 * words, words), dtype=torch.int64, device=sboxes.device)
    lib = _nms_lib()
    entry = lib.nms_mask_bf16 if sboxes.dtype == torch.bfloat16 else lib.nms_mask
    with torch.cuda.device(sboxes.device):
        err = entry(sboxes.data_ptr(), mask.data_ptr(), g, n,
                    threshold_in(thresh, sboxes.dtype), offset,
                    _build.stream_handle(sboxes.device))
    _build.check(err, "nms_mask")
    return mask


def nms_scan_cuda(mask: torch.Tensor, svalid: torch.Tensor,
                  max_keep: int | None = None) -> torch.Tensor:
    """The second launch of K1: the greedy walk over :func:`nms_mask_cuda`'s
    words, one keep flag per sorted box, stopping a problem's walk at
    ``max_keep`` kept boxes. Counts nothing."""
    g, n = svalid.shape
    keep = torch.empty((g, n), dtype=torch.bool, device=svalid.device)
    with torch.cuda.device(svalid.device):
        err = _nms_lib().nms_scan(mask.data_ptr(), svalid.data_ptr(), keep.data_ptr(), g, n,
                                  n if max_keep is None else min(max_keep, n),
                                  _build.stream_handle(svalid.device))
    _build.check(err, "nms_scan")
    return keep


def greedy_keep_cuda(sboxes: torch.Tensor, svalid: torch.Tensor,
                     thresh: float, offset: float = 0.0,
                     max_keep: int | None = None) -> torch.Tensor:
    """:func:`greedy_keep_plain` as the CUDA kernel pair of ``csrc/nms.cu``:
    one launch of all IoU bit masks, one launch of the sequential scans
    (each problem's stops at ``max_keep`` kept boxes), for all G problems
    at once. Never synchronises with the host. Boxes float32 or bfloat16
    (:data:`BOX_DTYPES`; the IoU in the boxes' dtype, as the JAX kernel
    computes it); a view or a misaligned tensor is copied once. N up to
    :data:`NMS_MAX_BOXES`; the mask takes ``G * 64W * W * 8`` bytes
    (about ``G * N**2 / 8``), and its allocation raises where the card's
    memory does not hold it."""
    if sboxes.dtype not in BOX_DTYPES or svalid.dtype != torch.bool:
        raise TypeError(f"greedy_keep_cuda takes float32 or bfloat16 boxes and bool valid, "
                        f"not {sboxes.dtype} boxes and {svalid.dtype} valid")
    if not (sboxes.is_cuda and svalid.device == sboxes.device):
        raise ValueError("greedy_keep_cuda takes CUDA tensors on one device")
    if sboxes.dim() != 3 or sboxes.shape[2] != 4 or svalid.shape != sboxes.shape[:2]:
        raise ValueError(f"shapes {tuple(sboxes.shape)} / {tuple(svalid.shape)}: "
                         "want boxes [G, N, 4] and valid [G, N]")
    # the kernel reads a box as one float4 (float32) or uint2 (bf16)
    if not sboxes.is_contiguous() or sboxes.data_ptr() % (4 * sboxes.element_size()):
        sboxes = sboxes.clone(memory_format=torch.contiguous_format)
    svalid = svalid.contiguous()
    if max_keep is not None and max_keep < 0:
        raise ValueError(f"max_keep={max_keep}: want None or >= 0")
    keep = nms_scan_cuda(nms_mask_cuda(sboxes, thresh, offset), svalid, max_keep)
    greedy_keep_cuda.launches += 1
    return keep


greedy_keep_cuda.launches = 0


# The most boxes K1 takes in one problem: 64 * kWideMaxWords of
# csrc/nms.cu, where the wide scan's removed-bits words fill its shared
# memory. A problem's mask (N**2 / 8 bytes, 205 GB there) outgrows the
# card's memory well before.
NMS_MAX_BOXES = 64 * 20000


def nms_problem_sizes(cfg, retina_levels: int = 5) -> list[tuple[str, int]]:
    """The config keys that set the box counts of ``cfg``'s NMS problems,
    each with the largest count it gives: per (image, level) RPN problems
    of ``rpn.pre_nms_topk_*`` boxes, the detection NMS over
    ``4 * rpn.post_nms_topk_test`` candidates (two-stage, R-FCN), and
    RetinaNet's merged NMS over its ``retina_levels`` levels'
    ``retinanet.pre_nms_topk`` (or ``retinanet.merged_pre_nms_topk``)
    candidates."""
    if cfg.model.name == "retinanet":
        merged = int(cfg.retinanet.merged_pre_nms_topk)
        if merged:
            return [("retinanet.merged_pre_nms_topk", merged)]
        return [("retinanet.pre_nms_topk", retina_levels * int(cfg.retinanet.pre_nms_topk))]
    return [("rpn.pre_nms_topk_train", int(cfg.rpn.pre_nms_topk_train)),
            ("rpn.pre_nms_topk_test", int(cfg.rpn.pre_nms_topk_test)),
            ("rpn.post_nms_topk_test", 4 * int(cfg.rpn.post_nms_topk_test))]


def check_nms_contract(cfg, retina_levels: int = 5) -> None:
    """Raises ``ValueError`` naming the config key where one of ``cfg``'s
    NMS problems would exceed :data:`NMS_MAX_BOXES`, so that a detector on
    the card fails when it is built and not at its first call. The plain
    version, on the CPU, takes any N."""
    for key, n in nms_problem_sizes(cfg, retina_levels):
        if n > NMS_MAX_BOXES:
            raise ValueError(f"{key}: NMS problems of {n} boxes; kernel K1 takes at most "
                             f"{NMS_MAX_BOXES}")


def greedy_keep(sboxes: torch.Tensor, svalid: torch.Tensor, thresh: float,
                offset: float = 0.0, max_keep: int | None = None) -> torch.Tensor:
    """Kernel K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if sboxes.is_cuda:
        return greedy_keep_cuda(sboxes, svalid, thresh, offset, max_keep)
    return greedy_keep_plain(sboxes, svalid, thresh, offset, max_keep)


def nms_padded_batched(boxes: torch.Tensor, scores: torch.Tensor,
                       valid: torch.Tensor | None, thresh: float, max_out: int,
                       offset: float = 0.0, keep_fn=None):
    """Greedy NMS over G independent problems.

    boxes ``[G, N, 4]``, scores ``[G, N]``, valid ``[G, N]`` bool (None =
    all valid). Returns ``(idx [G, max_out] int32, valid [G, max_out])``.
    ``keep_fn`` is the greedy walk over the sorted problems, called as
    :func:`greedy_keep` is, and by default :func:`greedy_keep`
    (``ops/nms_wrapper.py`` names another).
    """
    g, n = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order_scores, order = sort_desc(masked)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(g, n, 4)).contiguous()
    svalid = (order_scores > NEG_INF / 2).contiguous()
    # kept boxes in sorted order fill the first m slots (what top_k of the
    # kept scores gives, ties in index order); the rest are invalid, so the
    # walk may stop at m kept boxes
    m = min(max_out, n)
    keep = (keep_fn or greedy_keep)(sboxes, svalid, thresh, offset, max_keep=m)
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
               offset: float = 0.0, tiled: bool = True, algo: str = "auto"):
    """One problem: boxes ``[N, 4]``, scores ``[N]`` ->
    ``(idx [max_out] int32, valid [max_out] bool)``.

    ``tiled`` and ``algo`` are the JAX signature's: there they pick a TPU
    schedule of the same greedy walk (tiles of 128 boxes, a fixpoint or a
    loop), and the result does not depend on them. The port has one walk
    for every value (:func:`greedy_keep`)."""
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
