"""Preprocessing and batching: resize, flip, normalize, pad to static shapes.

The port of ``detectron_tpu/data/transforms.py``: resize the shortest side
to ``short_side`` capped by ``max_size``, random horizontal flip,
per-channel normalize, pad to the fixed ``data.image_size`` canvas (or its
transpose for portrait images with ``orientation_buckets``); ``image_hw``
carries the true (resized, pre-pad) size for box clipping.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``; the card's
machine has neither ``cv2`` nor PIL, so :func:`resize_shortest_side` does
the same sampling with ``torch.nn.functional.interpolate`` on the CPU:
bilinear, half-pixel centres, no antialias, edges clamped. For a uint8
image ``cv2`` rounds its result back to uint8 with 11-bit fixed-point
weights; this rounds the float result to the nearest grey level, so the
two agree within 1 grey level (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_shortest_side(
    image: np.ndarray, short_side: int, max_size: int
) -> tuple[np.ndarray, float]:
    """Returns (resized image as float32, scale)."""
    h, w = image.shape[:2]
    scale = short_side / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    chw = x.permute(2, 0, 1) if x.dim() == 3 else x[None]
    out = F.interpolate(chw[None], size=(nh, nw), mode="bilinear", align_corners=False,
                        antialias=False)[0]
    out = out.permute(1, 2, 0) if x.dim() == 3 else out[0]
    resized = out.numpy()
    if image.dtype == np.uint8:  # as cv2 returns uint8 for a uint8 image
        resized = np.clip(np.floor(resized + 0.5), 0, 255)
    return np.ascontiguousarray(resized, np.float32), scale


def normalize(image: np.ndarray, mean, std) -> np.ndarray:
    return (image - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def hflip(image: np.ndarray, boxes: np.ndarray):
    """Horizontal flip of image + boxes (x-coords mirrored)."""
    w = image.shape[1]
    image = image[:, ::-1]
    out = boxes.copy()
    out[:, 0] = w - boxes[:, 2]
    out[:, 2] = w - boxes[:, 0]
    return np.ascontiguousarray(image), out


def pad_to_canvas(image: np.ndarray, canvas_hw: tuple[int, int]) -> np.ndarray:
    h, w = image.shape[:2]
    ch, cw = canvas_hw
    if h > ch or w > cw:
        raise ValueError(f"image {h}x{w} exceeds canvas {ch}x{cw}")
    out = np.zeros((ch, cw) + image.shape[2:], np.float32)
    out[:h, :w] = image
    return out


def canvas_for_image(image_hw, cfg) -> tuple[int, int]:
    """The padded canvas: the configured ``image_size``, transposed for
    portrait images when ``orientation_buckets`` is on (two fixed shapes
    instead of the per-batch maximum)."""
    ch, cw = cfg.data.image_size
    if cfg.data.get("orientation_buckets", False) and image_hw[0] > image_hw[1]:
        return (max(ch, cw), min(ch, cw))
    return (ch, cw)


def preprocess_example(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    cfg,
    rng: np.random.RandomState | None = None,
    train: bool = True,
    gt_masks: np.ndarray | None = None,
    canvas_hw: tuple[int, int] | None = None,
):
    """One image -> fixed-shape example dict (without batch dim).

    boxes are scaled/flipped along with the image; classes/masks pass
    through padded to ``cfg.train.max_gt_boxes``. ``gt_masks`` are gt-box
    frame rasters, so a flip only mirrors them.
    """
    short_side = cfg.data.short_side
    train_scales = tuple(cfg.data.get("train_scales", ()) or ())
    if train and rng is not None and train_scales:
        # scale jitter: a uniform choice per example; the canvas stays
        short_side = int(train_scales[rng.randint(len(train_scales))])
    image, scale = resize_shortest_side(image, short_side, cfg.data.max_size)
    boxes = boxes.astype(np.float32) * scale
    if train and rng is not None and rng.uniform() < cfg.data.hflip_prob:
        image, boxes = hflip(image, boxes)
        if gt_masks is not None:
            gt_masks = gt_masks[:, :, ::-1].copy()
    true_hw = np.asarray(image.shape[:2], np.float32)
    image = normalize(image, cfg.data.pixel_mean, cfg.data.pixel_std)
    image = pad_to_canvas(image, canvas_hw or tuple(cfg.data.image_size))

    g = cfg.train.max_gt_boxes
    n = min(len(boxes), g)
    pad_boxes = np.zeros((g, 4), np.float32)
    pad_cls = np.zeros((g,), np.int32)
    pad_boxes[:n] = boxes[:n]
    pad_cls[:n] = classes[:n]
    out = {
        "image": image,
        "image_hw": true_hw,
        "gt_boxes": pad_boxes,
        "gt_classes": pad_cls,
    }
    if gt_masks is not None:
        m = gt_masks.shape[-1]
        pad_masks = np.zeros((g, m, m), np.float32)
        pad_masks[:n] = gt_masks[:n]
        out["gt_masks"] = pad_masks
    return out
