"""Seeded COCO-like inputs: images with objects, their boxes, classes and
masks.

Every seed gets the same set of sizes and object counts, in its own order,
with its own pixels, positions and classes: the work of a run does not
depend on the seed, its content does.

* Object counts follow COCO's: most images hold a few objects, the mean
  is about 7, and the tail reaches about 50 (quantiles of a log-normal,
  ``COUNT_MU`` and ``COUNT_SIGMA``).
* Sizes are those of COCO images (long side 640), resized as the program
  resizes them (short side 800, long side at most 1333).
* An object's side runs from 12 pixels to most of the image, log-uniform,
  at aspect ratios from 1:2 to 2:1; it is a filled rectangle or ellipse of
  its class's colour, and its mask is that shape in its box's frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

COUNT_MU, COUNT_SIGMA, COUNT_MAX = 1.6, 0.8, 50
# (height, width) of landscape COCO val images, the canvas's orientation
LANDSCAPE = ((480, 640), (427, 640), (360, 640), (425, 640), (512, 640))
MASK_SIZE = 28


def rng_for(seed: int, salt: int) -> np.random.Generator:
    """A numpy generator for one use (``salt``) of ``seed``."""
    return np.random.default_rng([int(seed) % (2 ** 64), salt])


def object_counts(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` object counts: fixed quantiles, in the seed's order."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    counts = np.clip(np.round(np.exp(COUNT_MU + COUNT_SIGMA * z)), 1, COUNT_MAX).astype(int)
    return rng.permutation(counts)


def resized_hw(hw, short_side: int, max_size: int) -> tuple[int, int]:
    """The program's resize: short side to ``short_side``, long side at
    most ``max_size``, rounded."""
    h, w = hw
    scale = short_side / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def image_sizes(n: int, sizes, rng: np.random.Generator) -> list:
    """``n`` sizes: ``sizes`` repeated in turn, in the seed's order."""
    return [sizes[i] for i in rng.permutation([i % len(sizes) for i in range(n)])]


def draw_objects(count: int, hw, num_classes: int, rng: np.random.Generator):
    """``count`` objects inside an image of size ``hw``: boxes ``[n, 4]``
    (x1, y1, x2, y2), classes ``[n]`` (1-based), ellipse flags ``[n]``."""
    h, w = hw
    side = np.exp(rng.uniform(math.log(12.0), math.log(0.8 * min(h, w)), count))
    aspect = np.exp(rng.uniform(math.log(0.5), math.log(2.0), count))
    bw = np.minimum(side * np.sqrt(aspect), w - 1)
    bh = np.minimum(side / np.sqrt(aspect), h - 1)
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    return boxes, rng.integers(1, num_classes, count), rng.random(count) < 0.5


def shape_mask(ellipse: bool, size: int = MASK_SIZE) -> np.ndarray:
    """The object's mask in its box's frame, ``[size, size]``."""
    if not ellipse:
        return np.ones((size, size), np.float32)
    c = (np.arange(size) + 0.5) / size * 2 - 1
    return ((c[:, None] ** 2 + c[None, :] ** 2) <= 1.0).astype(np.float32)


def class_colours(num_classes: int) -> np.ndarray:
    """A fixed colour a class, in normalized units."""
    k = np.arange(num_classes)
    return np.stack([np.sin(k * 1.7), np.cos(k * 2.3), np.sin(k * 0.7 + 1.0)], -1) * 1.5


def coco_like_batches(seed: int, n_batches: int, batch: int, settings: dict, device,
                      max_gt: int = 100) -> list[dict]:
    """``n_batches`` distinct batches on ``device`` on the landscape canvas:
    ``image [B, H, W, 3]`` (normalized, zero outside ``image_hw``),
    ``image_hw [B, 2]``, ``gt_boxes [B, G, 4]``, ``gt_classes [B, G]``
    (0 = padding), ``gt_masks [B, G, 28, 28]`` in the box frame."""
    n = n_batches * batch
    rng = rng_for(seed, 11)
    counts = object_counts(n, rng)
    hws = [resized_hw(s, settings["short_side"], settings["max_size"])
           for s in image_sizes(n, LANDSCAPE, rng)]
    ch, cw = settings["canvas"]
    if any(h > ch or w > cw for h, w in hws):
        raise ValueError(f"resized images {sorted(set(hws))} exceed the canvas {ch}x{cw}")
    colours = torch.tensor(class_colours(settings["num_classes"]), dtype=torch.float32,
                           device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    images = torch.zeros((n, ch, cw, 3), device=device)
    gt_boxes = np.zeros((n, max_gt, 4), np.float32)
    gt_classes = np.zeros((n, max_gt), np.int64)
    gt_masks = np.zeros((n, max_gt, MASK_SIZE, MASK_SIZE), np.float32)
    # background: a coarse random field upsampled, plus fine noise
    coarse = torch.randn((n, 3, ch // 64, cw // 64), generator=gen, device=device)
    field = torch.nn.functional.interpolate(coarse, size=(ch, cw), mode="bilinear",
                                            align_corners=False).permute(0, 2, 3, 1)
    noise = 0.25 * torch.randn((n, ch, cw, 3), generator=gen, device=device)
    images.copy_(field + noise)
    for i, (count, (h, w)) in enumerate(zip(counts, hws)):
        boxes, classes, ellipses = draw_objects(int(count), (h, w), settings["num_classes"], rng)
        gt_boxes[i, :count], gt_classes[i, :count] = boxes, classes
        for j in range(int(count)):
            gt_masks[i, j] = shape_mask(bool(ellipses[j]))
            x1, y1, x2, y2 = (int(v) for v in np.round(boxes[j]))
            if x2 <= x1 or y2 <= y1:
                continue
            patch = images[i, y1:y2, x1:x2]
            if ellipses[j]:
                ys = (torch.arange(y2 - y1, device=device) + 0.5) / (y2 - y1) * 2 - 1
                xs = (torch.arange(x2 - x1, device=device) + 0.5) / (x2 - x1) * 2 - 1
                inside = (ys[:, None] ** 2 + xs[None, :] ** 2) <= 1.0
                patch[inside] = colours[int(classes[j])]
            else:
                patch[:] = colours[int(classes[j])]
        images[i, h:] = 0.0
        images[i, :, w:] = 0.0
    batches = []
    for k in range(n_batches):
        rows = slice(k * batch, (k + 1) * batch)
        batches.append({
            "image": images[rows].contiguous(),
            "image_hw": torch.tensor([hws[r] for r in range(n)][rows], dtype=torch.float32,
                                     device=device),
            "gt_boxes": torch.tensor(gt_boxes[rows], device=device),
            "gt_classes": torch.tensor(gt_classes[rows], device=device),
            "gt_masks": torch.tensor(gt_masks[rows], device=device),
        })
    return batches
