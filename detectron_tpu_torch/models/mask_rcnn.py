"""Mask R-CNN's full-image mask paste, on the host and on the device.

The port of ``detectron_tpu/models/mask_rcnn.py``. ``predict_fn`` returns
each detection's 28x28 mask probabilities in its box frame; the COCO eval
needs them pasted into the full image (bilinear resize into the box
rectangle, threshold ``mask.paste_threshold``) and run-length encoded:

* :func:`paste_masks_rle`, the eval path: the fused paste + RLE of the
  C++ codec (``native/rle.cpp``), O(box area) a detection;
* :func:`paste_masks_numpy`, its dense plain twin, which the tests hold it
  against bit for bit;
* :func:`paste_masks_device`, the paste on tensors, ``[D, H, W]`` bool.
"""

from __future__ import annotations

import numpy as np
import torch

from detectron_tpu_torch.native import RLE, rle_paste


def paste_masks_numpy(
    masks: np.ndarray,  # [D, M, M] probabilities
    boxes: np.ndarray,  # [D, 4]
    valid: np.ndarray,  # [D]
    image_hw: tuple[int, int],
    threshold: float = 0.5,
) -> np.ndarray:
    """Paste each mask into its box rectangle on the full image (host,
    vectorized per detection). Returns [D, H, W] uint8."""
    h, w = image_hw
    d, m, _ = masks.shape
    out = np.zeros((d, h, w), np.uint8)
    for i in range(d):
        if not valid[i]:
            continue
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        x2i, y2i = min(max(x2i, x1i + 1), w), min(max(y2i, y1i + 1), h)
        x1i, y1i = min(max(x1i, 0), w - 1), min(max(y1i, 0), h - 1)
        bw, bh = x2i - x1i, y2i - y1i
        if bw <= 0 or bh <= 0:  # box entirely outside the canvas
            continue
        # bilinear resize mask [M,M] -> [bh,bw]
        ys = (np.arange(bh) + 0.5) * (y2 - y1) / bh + y1
        xs = (np.arange(bw) + 0.5) * (x2 - x1) / bw + x1
        u = (xs - x1) / max(x2 - x1, 1e-4) * m - 0.5
        v = (ys - y1) / max(y2 - y1, 1e-4) * m - 0.5
        u0 = np.clip(np.floor(u).astype(int), 0, m - 1)
        v0 = np.clip(np.floor(v).astype(int), 0, m - 1)
        u1, v1 = np.minimum(u0 + 1, m - 1), np.minimum(v0 + 1, m - 1)
        fu = np.clip(u - u0, 0, 1)
        fv = np.clip(v - v0, 0, 1)
        mk = masks[i]
        top = mk[v0][:, u0] * (1 - fu) + mk[v0][:, u1] * fu
        bot = mk[v1][:, u0] * (1 - fu) + mk[v1][:, u1] * fu
        patch = top * (1 - fv[:, None]) + bot * fv[:, None]
        out[i, y1i:y2i, x1i:x2i] = (patch >= threshold).astype(np.uint8)
    return out


def paste_masks_rle(
    masks: np.ndarray,  # [D, M, M] probabilities
    boxes: np.ndarray,  # [D, 4]
    valid: np.ndarray,  # [D]
    image_hw: tuple[int, int],
    threshold: float = 0.5,
) -> list:
    """Fused paste + RLE encode: each mask's full-image column-major RLE is
    emitted directly from its box patch by the C++ codec (O(box area) per
    detection; the full canvas is never materialized or scanned).

    ``RLE.encode(paste_masks_numpy(...))`` computes the same masks: bit for
    bit for float32 boxes, since the codec replicates the numpy
    interpolation op for op (``tests/test_torch_rle.py``). Boxes are cast to
    float32 here. Returns a list of ``native.RLE`` (invalid rows -> empty
    masks).
    """
    h, w = int(image_hw[0]), int(image_hw[1])
    masks = np.ascontiguousarray(masks, np.float32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    valid = np.asarray(valid, bool)
    buf = np.empty(h * w + 1, np.uint32)  # reused worst-case run buffer
    empty = np.asarray([h * w], np.uint32)
    return [rle_paste(masks[i], boxes[i], (h, w), threshold, buf) if valid[i]
            else RLE(h, w, empty) for i in range(len(masks))]


def paste_masks_device(
    masks: torch.Tensor,  # [D, M, M]
    boxes: torch.Tensor,  # [D, 4]
    valid: torch.Tensor,  # [D]
    image_hw: tuple[int, int],
    threshold: float = 0.5,
) -> torch.Tensor:
    """On-device full-image paste: for each output pixel, inverse-map into
    mask coords and bilinear-sample. Static shapes; [D, H, W] bool."""
    h, w = image_hw
    m = masks.shape[-1]
    dev = masks.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    boxes = boxes.to(torch.float32)
    bw = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-4)
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-4)
    # divide by tensors, not Python numbers: CUDA multiplies by the reciprocal
    u = (xs[None, :] - boxes[:, 0:1]) / bw[:, None] * m - 0.5  # [D, W]
    v = (ys[None, :] - boxes[:, 1:2]) / bh[:, None] * m - 0.5  # [D, H]

    def bil(c):
        inb = (c >= -0.5) & (c <= m - 0.5)
        cc = torch.clamp(c, 0.0, m - 1.0)
        i0 = torch.clamp(torch.floor(cc).long(), 0, m - 1)
        i1 = torch.clamp(i0 + 1, max=m - 1)
        return i0, i1, cc - i0, inb

    u0, u1, fu, uin = bil(u)
    v0, v1, fv, vin = bil(v)

    def gather(rows, cols):  # masks[d, rows[d, :, None], cols[d, None, :]]
        d = masks.shape[0]
        picked = torch.take_along_dim(masks, rows[:, :, None].expand(d, h, m), dim=1)
        return torch.take_along_dim(picked, cols[:, None, :].expand(d, h, w), dim=2)

    top = gather(v0, u0) * (1 - fu)[:, None, :] + gather(v0, u1) * fu[:, None, :]
    bot = gather(v1, u0) * (1 - fu)[:, None, :] + gather(v1, u1) * fu[:, None, :]
    patch = top * (1 - fv)[:, :, None] + bot * fv[:, :, None]
    inside = vin[:, :, None] & uin[:, None, :] & valid.to(torch.bool)[:, None, None]
    return (patch >= threshold) & inside
