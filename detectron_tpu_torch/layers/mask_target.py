"""Mask targets: ground-truth masks cropped to the sampled RoIs.

The port of ``detectron_tpu/layers/mask_target.py``. The data pipeline
rasterizes each gt instance once into an ``M0 x M0`` grid in its own box
frame; the target of a foreground RoI is that grid resampled bilinearly
into the RoI frame, as two batched products with tent-weight
interpolation matrices, then thresholded at 0.5.
"""

from __future__ import annotations

import torch

from detectron_tpu_torch.ops.boxes import true_div


def _interp_matrix(c: torch.Tensor, m0: int) -> torch.Tensor:
    """``[S, r]`` grid coordinates -> ``[S, r, M0]`` tent weights
    ``max(0, 1 - |k - c|)`` of the clipped coordinate, zero for a sample
    outside ``(-1, M0)``."""
    inb = (c > -1.0) & (c < m0)
    cc = c.clamp(0.0, m0 - 1.0)
    grid = torch.arange(m0, dtype=cc.dtype, device=cc.device)
    w = (1.0 - (grid - cc[..., None]).abs()).clamp_min(0.0)
    return torch.where(inb[..., None], w, torch.zeros_like(w))


def crop_gt_masks_batched(gt_masks: torch.Tensor, gt_boxes: torch.Tensor, rois: torch.Tensor,
                          matched_idx: torch.Tensor, resolution: int = 28) -> torch.Tensor:
    """gt_masks ``[B, G, M0, M0]`` in [0, 1] (gt-box frame); gt_boxes
    ``[B, G, 4]``; rois ``[B, S, 4]``; matched_idx ``[B, S]`` gt index per
    RoI. Returns ``[B, S, resolution, resolution]`` targets in {0, 1}."""
    b, s = matched_idx.shape
    m0 = gt_masks.shape[-1]
    idx = matched_idx.long()
    g = torch.gather(gt_boxes, 1, idx[..., None].expand(b, s, 4))  # [B, S, 4]
    gw = (g[..., 2] - g[..., 0]).clamp_min(1e-4)
    gh = (g[..., 3] - g[..., 1]).clamp_min(1e-4)

    r = resolution
    # RoI-frame sample points in image coordinates
    fx = true_div(torch.arange(r, dtype=rois.dtype, device=rois.device) + 0.5, r)
    x = rois[..., 0:1] + fx * (rois[..., 2:3] - rois[..., 0:1])  # [B, S, r]
    y = rois[..., 1:2] + fx * (rois[..., 3:4] - rois[..., 1:2])
    # into gt-frame grid coordinates
    u = (x - g[..., 0:1]) / gw[..., None] * m0 - 0.5
    v = (y - g[..., 1:2]) / gh[..., None] * m0 - 0.5

    wu = _interp_matrix(u, m0).reshape(b * s, r, m0)
    wv = _interp_matrix(v, m0).reshape(b * s, r, m0)
    masks = torch.gather(gt_masks, 1, idx[..., None, None].expand(b, s, m0, m0))
    masks = masks.float().reshape(b * s, m0, m0)
    # t[i, x] = sum_y wv[i, y] masks[y, x]; out[i, j] = sum_x t[i, x] wu[j, x]
    out = torch.bmm(torch.bmm(wv, masks), wu.transpose(1, 2))
    return (out >= 0.5).float().reshape(b, s, r, r)
