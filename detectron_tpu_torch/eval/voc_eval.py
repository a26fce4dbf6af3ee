"""Pascal VOC AP evaluation (07 11-point and area-under-curve metrics).

The port of ``detectron_tpu/eval/voc_eval.py``, the same numpy code:
per-class PR from greedy IoU>=0.5 matching with difficult gts excluded;
``use_07_metric`` selects the VOC2007 11-point AP.
"""

from __future__ import annotations

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_voc(
    groundtruths: list,
    detections: list,
    num_classes: int,
    iou_threshold: float = 0.5,
    use_07_metric: bool = False,
) -> dict:
    """groundtruths: per image {boxes, classes, difficult}; detections: per
    image {boxes, scores, classes}. Returns {"mAP", "per_class"}."""
    aps = {}
    for cls in range(1, num_classes):
        records = []  # (score, is_tp)
        n_pos = 0
        for gt, det in zip(groundtruths, detections):
            g_sel = np.where(gt["classes"] == cls)[0]
            difficult = gt.get("difficult")
            difficult = (
                difficult[g_sel] if difficult is not None
                else np.zeros(len(g_sel), bool)
            ).astype(bool)
            n_pos += int((~difficult).sum())
            d_sel = np.where(det["classes"] == cls)[0]
            if len(d_sel) == 0:
                continue
            d_boxes = det["boxes"][d_sel]
            d_scores = det["scores"][d_sel]
            order = np.argsort(-d_scores)
            g_boxes = gt["boxes"][g_sel]
            used = np.zeros(len(g_sel), bool)
            for di in order:
                if len(g_sel) == 0:
                    records.append((d_scores[di], 0))
                    continue
                lt = np.maximum(d_boxes[di, :2], g_boxes[:, :2])
                rb = np.minimum(d_boxes[di, 2:], g_boxes[:, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                a1 = (d_boxes[di, 2] - d_boxes[di, 0]) * (d_boxes[di, 3] - d_boxes[di, 1])
                a2 = (g_boxes[:, 2] - g_boxes[:, 0]) * (g_boxes[:, 3] - g_boxes[:, 1])
                iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
                best = int(np.argmax(iou))
                if iou[best] >= iou_threshold:
                    if difficult[best]:
                        continue  # difficult matches are discarded entirely
                    if not used[best]:
                        used[best] = True
                        records.append((d_scores[di], 1))
                    else:
                        records.append((d_scores[di], 0))
                else:
                    records.append((d_scores[di], 0))
        if n_pos == 0:
            continue
        if not records:
            aps[cls] = 0.0
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.cumsum([r[1] for r in records])
        fp = np.cumsum([1 - r[1] for r in records])
        recall = tp / n_pos
        precision = tp / np.maximum(tp + fp, 1e-9)
        aps[cls] = voc_ap(recall, precision, use_07_metric)
    return {"mAP": float(np.mean(list(aps.values()))) if aps else 0.0,
            "per_class": aps}
