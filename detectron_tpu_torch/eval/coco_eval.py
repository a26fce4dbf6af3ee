"""COCO-style detection / instance-segmentation evaluation, self-contained.

The port of ``detectron_tpu/eval/coco_eval.py``, the same numpy code, so
the metrics equal the JAX evaluator's on the same records (the COCO
protocol that pycocotools' COCOeval implements):

  * IoU thresholds .50:.05:.95, 101-point interpolated AP,
  * greedy score-ordered matching, highest-IoU unmatched gt first,
  * crowd/ignore gts may absorb detections without counting as TP/FP,
  * area ranges (all/small/medium/large), maxDets sweep (AR@1/10/100),
  * bbox IoU or mask IoU (dense bool masks, or ``native.RLE`` through the
    C++ codec) per ``iou_type``,
  * gts bucket into area ranges by their ANNOTATION area (COCO's
    ``ann["area"]``, for BOTH bbox and segm eval); detections bucket by
    box area for bbox eval and mask area for segm eval.
"""

from __future__ import annotations

import numpy as np

from detectron_tpu_torch.native import rle_iou

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def box_iou_matrix(a: np.ndarray, b: np.ndarray, crowd: np.ndarray | None = None):
    """IoU [len(a), len(b)]; for crowd gt columns, IoU = intersection/area_det
    (the COCO rule)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    if crowd is not None and crowd.any():
        union = np.where(crowd[None, :], np.maximum(area_a[:, None], 1e-9), union)
    return inter / np.maximum(union, 1e-9)


def mask_iou_matrix(a: list, b: list, crowd: np.ndarray | None = None):
    """IoU between two lists of masks: dense bool [H,W] arrays OR
    ``native.RLE`` objects (dispatched to the C++ codec)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    if hasattr(a[0], "counts"):
        return rle_iou(a, b, iscrowd=crowd)
    out = np.zeros((len(a), len(b)), np.float64)
    for i, ma in enumerate(a):
        sa = ma.sum()
        for j, mb in enumerate(b):
            inter = np.logical_and(ma, mb).sum()
            if crowd is not None and crowd[j]:
                denom = max(sa, 1e-9)
            else:
                denom = sa + mb.sum() - inter
            out[i, j] = inter / max(denom, 1e-9)
    return out


def _match_image(det_scores, ious, gt_ignore, iou_thresholds, max_dets):
    """Greedy COCO matching for one (image, class) — the pycocotools
    ``evaluateImg`` algorithm: detections in score order greedily take the
    highest-IoU available gt; gts are visited real-first then ignore;
    matching an ignore gt marks the detection ignored.

    Vectorized over the threshold and gt axes (one small [T, G] numpy block
    per detection instead of a T*D*G Python triple loop — the per-detection
    greedy state makes the det axis inherently sequential). Semantics are
    identical to the scalar pycocotools loop, including the `>=` tie rule
    (among equal-IoU candidates the LAST gt in real-first order wins);
    tests/test_torch_eval.py holds it equal to the JAX evaluator.

    Returns (matched [T, D], ignored [T, D], det order used, n_valid_gt).
    """
    gt_ignore = np.asarray(gt_ignore, bool)
    d = min(len(det_scores), max_dets)
    order = np.argsort(-det_scores, kind="stable")[:d]
    t = len(iou_thresholds)
    matched = np.zeros((t, d), bool)
    ignored = np.zeros((t, d), bool)
    n_valid = int((~gt_ignore).sum())
    if ious.shape[1] == 0 or d == 0:
        return matched, ignored, order, n_valid
    # real gts first, each group in original (stable) order — the oracle's
    # g_order iteration. Positions below are within these subsets.
    real_idx = np.where(~gt_ignore)[0]
    ig_idx = np.where(gt_ignore)[0]
    thr_eff = np.minimum(np.asarray(iou_thresholds, np.float64), 1.0 - 1e-10)
    n_real = len(real_idx)
    gt_used = np.zeros((t, n_real), bool)
    for di, dd in enumerate(order):
        if n_real:
            iou_r = ious[dd, real_idx]  # [R]
            cand = (iou_r[None, :] >= thr_eff[:, None]) & ~gt_used  # [T, R]
            vals = np.where(cand, iou_r[None, :], -np.inf)
            best = vals.max(axis=1)  # [T]
            has = best > -np.inf
            if has.any():
                # last argmax = the oracle's `>=` update rule
                eq = vals == best[:, None]
                m = (n_real - 1) - np.argmax(eq[:, ::-1], axis=1)
                matched[has, di] = True
                gt_used[has, m[has]] = True
        else:
            has = np.zeros(t, bool)
        if len(ig_idx):
            # an unmatched det may still hit an ignore/crowd gt (reusable,
            # never marked used) at the original threshold
            iou_i = ious[dd, ig_idx]
            hit = (iou_i[None, :] >= thr_eff[:, None]).any(axis=1)
            ignored[~has & hit, di] = True
    return matched, ignored, order, n_valid


def _mask_area(m) -> float:
    """Pixel area of a mask: RLE objects via the C++ codec, dense via sum."""
    return float(m.area() if hasattr(m, "area") else np.asarray(m).sum())


def _accumulate(per_image, iou_thresholds, max_det=None):
    """per_image: list of (scores_sorted, matched [T,D], ignored [T,D], n_gt).
    Returns AP [T] and AR [T].

    ``max_det`` truncates each image's (already score-sorted) detections to
    its first ``max_det`` rows — exactly pycocotools' accumulate(), which
    evaluates once at the largest maxDets and slices ``[:, 0:maxDet]`` per
    sweep entry (greedy matching of a score-ordered prefix is
    prefix-stable, so the truncation IS the smaller-maxDets evaluation).
    """
    if max_det is not None:
        per_image = [(s[:max_det], m[:, :max_det], ig[:, :max_det], n)
                     for s, m, ig, n in per_image]
    total_gt = sum(p[3] for p in per_image)
    t = len(iou_thresholds)
    if total_gt == 0:
        return np.full(t, np.nan), np.full(t, np.nan)
    scores = np.concatenate([p[0] for p in per_image]) if per_image else np.zeros(0)
    # mergesort = pycocotools' stable cross-image tiebreak (earlier image
    # first on equal scores); default quicksort can flip tied rows
    order = np.argsort(-scores, kind="mergesort")
    ap = np.zeros(t)
    ar = np.zeros(t)
    for ti in range(t):
        m = np.concatenate([p[1][ti] for p in per_image])[order]
        ig = np.concatenate([p[2][ti] for p in per_image])[order]
        keep = ~ig
        tp = np.cumsum(m[keep])
        fp = np.cumsum(~m[keep])
        recall = tp / total_gt
        precision = tp / np.maximum(tp + fp, 1e-9)
        # monotone non-increasing precision envelope (right-to-left cummax)
        if len(precision):
            precision = np.maximum.accumulate(precision[::-1])[::-1]
        # 101-point interpolation
        p_at = np.zeros_like(RECALL_POINTS)
        if len(precision):
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            ok = idx < len(precision)
            p_at[ok] = precision[idx[ok]]
        ap[ti] = p_at.mean()
        ar[ti] = recall[-1] if len(recall) else 0.0
    return ap, ar


def evaluate(
    groundtruths: list,
    detections: list,
    num_classes: int,
    iou_type: str = "bbox",
    max_dets: int | tuple = (1, 10, 100),
    area_ranges: dict | None = None,
) -> dict:
    """Full COCO-protocol evaluation.

    groundtruths: per image {boxes [G,4], classes [G], ignore [G] bool,
      (areas [G]: the annotation areas — COCO's ``ann["area"]`` mask area;
      falls back to mask area, then box area),
      (masks: list of bool [H,W] or native RLE)}.
    detections: per image {boxes [D,4], scores [D], classes [D],
      (masks: list of bool [H,W] or native RLE)}.
    Classes are 1-based contiguous.

    ``max_dets`` is the pycocotools maxDets sweep: matching runs once at the
    largest entry; AP/APs/APm/APl/ARs/ARm/ARl are reported at the largest,
    plus one ``AR{k}`` per entry (``AR`` aliases the largest, so the default
    yields the standard AP, AP50, AP75, APs/m/l, AR1/10/100, ARs/m/l).

    Area bucketing follows pycocotools exactly: gts by annotation area in
    BOTH bbox and segm eval; detections by box area (bbox) / mask area
    (segm) for the unmatched-out-of-range ignore rule.
    """
    area_ranges = area_ranges or AREA_RANGES
    if isinstance(max_dets, int):
        max_dets = (max_dets,)
    max_dets = sorted(int(k) for k in max_dets)
    md_max = max_dets[-1]
    results = {}
    per_class_ap = {}

    def _nanmean(x):
        """nanmean that treats all-NaN (class/bucket absent) as NaN silently."""
        x = np.asarray(x, np.float64)
        ok = ~np.isnan(x)
        return float(x[ok].mean()) if ok.any() else float("nan")

    def _gt_eval_areas(gt, g_sel, g_boxes):
        """Annotation area per selected gt — pycocotools buckets gts by
        ``g["area"]`` (the segmentation area from the JSON) in bbox AND
        segm eval alike. Priority: explicit ``areas`` > mask area > box
        area (box-only datasets like VOC have no annotation area)."""
        areas = gt.get("areas")
        if areas is not None:
            return np.asarray(areas, np.float64)[g_sel]
        masks = gt.get("masks")
        if masks is not None and len(masks):
            return np.asarray([_mask_area(masks[i]) for i in g_sel],
                              np.float64)
        return ((g_boxes[:, 2] - g_boxes[:, 0])
                * (g_boxes[:, 3] - g_boxes[:, 1])).astype(np.float64)

    # IoU matrices depend only on (image, class) — computed ONCE and reused
    # across all area ranges (pycocotools structure; 4x fewer IoU/mask-IoU
    # evaluations than the naive range-outermost loop). Matching runs once
    # at the largest maxDets; the sweep truncates in _accumulate.
    ap_per_class = {rn: [] for rn in area_ranges}
    ar_per_class = {rn: {k: [] for k in max_dets} for rn in area_ranges}
    for cls in range(1, num_classes):
        per_image = {rn: [] for rn in area_ranges}
        for gt, det in zip(groundtruths, detections):
            g_sel = np.where(gt["classes"] == cls)[0]
            d_sel = np.where(det["classes"] == cls)[0]
            if len(g_sel) == 0 and len(d_sel) == 0:
                continue
            g_boxes = gt["boxes"][g_sel]
            areas = _gt_eval_areas(gt, g_sel, g_boxes)
            base_ignore = gt.get("ignore")
            base_ignore = (
                base_ignore[g_sel] if base_ignore is not None
                else np.zeros(len(g_sel), bool)
            )
            d_boxes = det["boxes"][d_sel]
            d_scores = det["scores"][d_sel]
            if iou_type == "segm":
                d_masks = [det["masks"][i] for i in d_sel]
                ious = mask_iou_matrix(
                    d_masks,
                    [gt["masks"][i] for i in g_sel],
                    crowd=base_ignore,
                )
                # segm dets bucket by MASK area (pycocotools loadRes)
                d_eval_areas = np.asarray(
                    [_mask_area(m) for m in d_masks], np.float64)
            else:
                ious = box_iou_matrix(d_boxes, g_boxes, crowd=base_ignore)
                d_eval_areas = (d_boxes[:, 2] - d_boxes[:, 0]) * (
                    d_boxes[:, 3] - d_boxes[:, 1]
                )
            for range_name, (lo, hi) in area_ranges.items():
                ignore = base_ignore | (areas < lo) | (areas > hi)
                matched, ignored, order, n_gt = _match_image(
                    d_scores, ious, ignore, IOU_THRESHOLDS, md_max
                )
                # out-of-range unmatched detections are ignored (COCO rule)
                oob = (d_eval_areas[order] < lo) | (d_eval_areas[order] > hi)
                ignored = ignored | (~matched & oob[None, :])
                per_image[range_name].append(
                    (d_scores[order], matched, ignored, n_gt)
                )
        for range_name in area_ranges:
            ap, ar = _accumulate(per_image[range_name], IOU_THRESHOLDS)
            if not np.isnan(ap).all():
                ap_per_class[range_name].append(ap)
                ar_per_class[range_name][md_max].append(ar)
                for k in max_dets[:-1]:
                    if range_name == "all":  # AR@k sweep is area=all only
                        _, ar_k = _accumulate(
                            per_image[range_name], IOU_THRESHOLDS, max_det=k)
                        ar_per_class[range_name][k].append(ar_k)
                if range_name == "all":
                    per_class_ap[cls] = float(_nanmean(ap))
    for range_name in area_ranges:
        if ap_per_class[range_name]:
            aps = np.stack(ap_per_class[range_name])
            ars = np.stack(ar_per_class[range_name][md_max])
        else:
            aps = np.full((1, len(IOU_THRESHOLDS)), np.nan)
            ars = aps
        if range_name == "all":
            results["AP"] = float(_nanmean(aps))
            results["AP50"] = float(_nanmean(aps[:, 0]))
            results["AP75"] = float(_nanmean(aps[:, 5]))
            results["AR"] = float(_nanmean(ars))
            results[f"AR{md_max}"] = results["AR"]
            for k in max_dets[:-1]:
                rows = ar_per_class[range_name][k]
                results[f"AR{k}"] = float(
                    _nanmean(np.stack(rows))) if rows else float("nan")
            results["per_class"] = per_class_ap
        else:
            key = {"small": "APs", "medium": "APm", "large": "APl"}[range_name]
            results[key] = float(_nanmean(aps))
            results["AR" + key[2:]] = float(_nanmean(ars))
    return results
