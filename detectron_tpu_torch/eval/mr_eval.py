"""Log-average miss rate (MR^-2) evaluation for pedestrian detection.

The port of ``detectron_tpu/eval/mr_eval.py``, the same numpy code: the
CityPersons/Caltech protocol, greedy IoU>=0.5 matching in score order,
ignore regions absorb detections without counting, miss rate sampled at 9
log-spaced FPPI points in [1e-2, 1], and MR^-2 = exp(mean(log(mr))) (lower
is better).
"""

from __future__ import annotations

import numpy as np

FPPI_POINTS = np.logspace(-2, 0, 9)


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _iof(a, b):
    """Intersection over detection area (ignore-region rule)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    return inter / np.maximum(area_a[:, None], 1e-9)


def evaluate_mr(
    groundtruths: list,
    detections: list,
    iou_threshold: float = 0.5,
) -> dict:
    """groundtruths: per image {boxes [G,4], ignore_boxes [I,4]};
    detections: per image {boxes [D,4], scores [D]}.

    Returns {"MR-2": float, "miss_rates": [...], "fppi": [...]}.
    """
    n_images = len(groundtruths)
    records = []  # (score, is_tp)
    n_gt = 0
    for gt, det in zip(groundtruths, detections):
        g = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
        ig = np.asarray(gt.get("ignore_boxes", np.zeros((0, 4))),
                        np.float32).reshape(-1, 4)
        n_gt += len(g)
        d = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
        s = np.asarray(det["scores"], np.float32)
        order = np.argsort(-s)
        used = np.zeros(len(g), bool)
        ious = _iou(d, g) if len(g) else np.zeros((len(d), 0))
        iofs = _iof(d, ig) if len(ig) else np.zeros((len(d), 0))
        for di in order:
            matched = False
            if len(g):
                cand = np.where(~used & (ious[di] >= iou_threshold))[0]
                if len(cand):
                    best = cand[np.argmax(ious[di][cand])]
                    used[best] = True
                    records.append((s[di], 1))
                    matched = True
            if not matched:
                # absorbed by an ignore region? then drop silently
                if len(ig) and (iofs[di] >= iou_threshold).any():
                    continue
                records.append((s[di], 0))
    if n_gt == 0 or not records:
        return {"MR-2": 1.0, "miss_rates": [1.0] * len(FPPI_POINTS),
                "fppi": list(FPPI_POINTS)}
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records]).astype(np.float64)
    fp = np.cumsum([1 - r[1] for r in records]).astype(np.float64)
    miss = 1.0 - tp / n_gt
    fppi = fp / n_images
    mrs = []
    for p in FPPI_POINTS:
        idx = np.where(fppi <= p)[0]
        mrs.append(float(miss[idx[-1]]) if len(idx) else 1.0)
    # log-average with eps guard
    mr2 = float(np.exp(np.mean(np.log(np.maximum(mrs, 1e-10)))))
    return {"MR-2": mr2, "miss_rates": mrs, "fppi": list(FPPI_POINTS)}
