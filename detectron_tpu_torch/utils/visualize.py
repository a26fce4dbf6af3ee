"""Detection visualization: boxes, class labels, scores and instance masks
drawn onto an image.

A copy of ``detectron_tpu/utils/visualize.py`` (numpy only, nothing of
JAX): the same per-class palette, and the same drawing, through ``cv2``
where it is installed and as numpy box outlines where it is not.
"""

from __future__ import annotations

import numpy as np

# deterministic per-class palette
_PALETTE_SEED = 7


def class_color(cls: int) -> tuple[int, int, int]:
    rng = np.random.RandomState(_PALETTE_SEED + int(cls))
    return tuple(int(x) for x in rng.randint(64, 255, 3))


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray | None = None,
    masks: np.ndarray | None = None,
    class_names: list | None = None,
    score_threshold: float = 0.0,
    mask_alpha: float = 0.45,
) -> np.ndarray:
    """Returns a uint8 RGB copy of ``image`` with detections drawn.

    boxes ``[D, 4]`` xyxy in image coordinates; masks, if given, are
    full-image ``[D, H, W]`` binary masks (``models/mask_rcnn.py``'s paste
    functions).
    """
    out = np.ascontiguousarray(image).astype(np.uint8).copy()
    h, w = out.shape[:2]
    d = len(boxes)
    if valid is None:
        valid = np.ones(d, bool)
    try:
        import cv2
    except ImportError:
        cv2 = None
    for i in range(d):
        if not valid[i] or scores[i] < score_threshold:
            continue
        color = class_color(classes[i])
        x1, y1, x2, y2 = (int(max(0, min(v, lim - 1))) for v, lim in
                          zip(boxes[i], (w, h, w, h)))
        if masks is not None:
            m = masks[i].astype(bool)
            out[m] = (out[m] * (1 - mask_alpha)
                      + np.array(color) * mask_alpha).astype(np.uint8)
        label = (class_names[classes[i]] if class_names
                 and classes[i] < len(class_names) else f"cls{int(classes[i])}")
        text = f"{label} {scores[i]:.2f}"
        if cv2 is not None:
            cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
            cv2.putText(out, text, (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
        else:  # numpy-only box outline
            out[y1:y2 + 1, x1:min(x1 + 2, w)] = color
            out[y1:y2 + 1, max(x2 - 1, 0):x2 + 1] = color
            out[y1:min(y1 + 2, h), x1:x2 + 1] = color
            out[max(y2 - 1, 0):y2 + 1, x1:x2 + 1] = color
    return out
