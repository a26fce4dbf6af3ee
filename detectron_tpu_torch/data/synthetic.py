"""Synthetic dataset: rendered rectangles and ellipses with exact annotations.

A copy of ``detectron_tpu/data/synthetic.py``: the same seeded numpy
batches, in the same fixed-shape batch dict as the real pipelines.
"""

from __future__ import annotations

import numpy as np


def make_batch(
    rng: np.random.RandomState,
    batch_size: int,
    image_size: tuple[int, int],
    num_classes: int,
    max_gt: int = 8,
    max_objects: int = 3,
    mask_size: int = 28,
):
    """Images with solid axis-aligned rectangles (class = intensity bucket).

    Returns the standard batch dict:
      image [B,H,W,3] (zero-mean-ish), image_hw [B,2], gt_boxes [B,G,4],
      gt_classes [B,G] (0 = padding), gt_masks [B,G,M,M].
    """
    h, w = image_size
    b = batch_size
    images = np.full((b, h, w, 3), -0.5, np.float32)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    classes = np.zeros((b, max_gt), np.int32)
    masks = np.zeros((b, max_gt, mask_size, mask_size), np.float32)
    for i in range(b):
        n = rng.randint(1, max_objects + 1)
        for j in range(n):
            bw = rng.randint(w // 8, w // 2)
            bh = rng.randint(h // 8, h // 2)
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            cls = rng.randint(1, num_classes)
            color = np.array(
                [cls / num_classes, 1.0 - cls / num_classes, 0.5], np.float32
            )
            ellipse = j % 2 == 1  # alternate shapes for nontrivial masks
            ys, xs = np.mgrid[0:bh, 0:bw]
            if ellipse:
                cy, cx = (bh - 1) / 2, (bw - 1) / 2
                inside = ((ys - cy) / max(cy, 1)) ** 2 + (
                    (xs - cx) / max(cx, 1)
                ) ** 2 <= 1.0
            else:
                inside = np.ones((bh, bw), bool)
            patch = images[i, y1 : y1 + bh, x1 : x1 + bw]
            patch[inside] = color
            boxes[i, j] = [x1, y1, x1 + bw, y1 + bh]
            classes[i, j] = cls
            # gt-box-frame mask at fixed resolution
            gy = (np.arange(mask_size) + 0.5) / mask_size * bh
            gx = (np.arange(mask_size) + 0.5) / mask_size * bw
            gyi = np.clip(gy.astype(int), 0, bh - 1)
            gxi = np.clip(gx.astype(int), 0, bw - 1)
            masks[i, j] = inside[gyi][:, gxi].astype(np.float32)
    return {
        "image": images,
        "image_hw": np.tile(np.array([[h, w]], np.float32), (b, 1)),
        "gt_boxes": boxes,
        "gt_classes": classes,
        "gt_masks": masks,
    }
