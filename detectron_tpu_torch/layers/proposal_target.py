"""RoI sampling (proposal targets) for the box and mask heads.

The port of ``detectron_tpu/layers/proposal_target.py``: the ground-truth
boxes are appended to the proposals, foreground (IoU >= 0.5, at most a
quarter of the sample) and background RoIs are chosen by rank-based random
selection, and the chosen RoIs are compacted to the front slots,
foreground first. Static shapes, batched over images; the uniform draws
come in as tensors (:mod:`detectron_tpu_torch.layers.anchor_target`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from detectron_tpu_torch.layers.anchor_target import rank_select
from detectron_tpu_torch.ops import boxes as box_ops


class RoiTargets(NamedTuple):
    rois: torch.Tensor  # [B, S, 4] sampled proposals
    labels: torch.Tensor  # [B, S] int32: 0 bg (or padding), >0 class
    weights: torch.Tensor  # [B, S] 1.0 where the RoI counts in the cls loss
    box_targets: torch.Tensor  # [B, S, 4]
    box_weights: torch.Tensor  # [B, S] 1.0 for fg RoIs
    matched_idx: torch.Tensor  # [B, S] gt index (for mask targets)
    num_fg: torch.Tensor  # [B]


def sample_rois(rois: torch.Tensor, roi_valid: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, noise_fg: torch.Tensor, noise_bg: torch.Tensor,
                sample_size: int = 512, positive_fraction: float = 0.25,
                positive_iou: float = 0.5, negative_iou_hi: float = 0.5,
                negative_iou_lo: float = 0.0, box_weights=(10.0, 10.0, 5.0, 5.0),
                offset: float = 0.0) -> RoiTargets:
    """rois ``[B, P, 4]``, roi_valid ``[B, P]``, gt_boxes ``[B, G, 4]``,
    gt_classes ``[B, G]`` (0 = padding); noise_fg / noise_bg ``[B, P + G]``
    uniform draws. Returns ``min(sample_size, P + G)`` slots per image, as
    the JAX package's ``argsort(order_key)[:sample_size]`` does."""
    gt_valid = gt_classes > 0
    cand = torch.cat([rois, gt_boxes], dim=1)  # [B, P+G, 4]
    cand_valid = torch.cat([roi_valid, gt_valid], dim=1)
    n = cand.shape[1]

    iou = box_ops.bbox_overlaps(cand, gt_boxes, offset=offset)  # [B, P+G, G]
    masked_iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    # overlap with a padded gt counts as 0, not -1: an image with no valid
    # gt still yields background RoIs
    max_iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou)).amax(dim=2)
    matched = masked_iou.argmax(dim=2)

    fg = cand_valid & (max_iou >= positive_iou) & gt_valid.any(dim=1, keepdim=True)
    bg = cand_valid & (max_iou < negative_iou_hi) & (max_iou >= negative_iou_lo)

    fg_cap = torch.clamp(fg.sum(1), max=int(sample_size * positive_fraction))
    sel_fg = rank_select(fg, fg_cap, noise_fg, max_cap=sample_size)
    bg_cap = sample_size - sel_fg.sum(1)
    sel_bg = rank_select(bg, bg_cap, noise_bg, max_cap=sample_size)

    # compact the selected RoIs to the front slots: fg, then bg, then the
    # rest, each in index order
    sel = sel_fg | sel_bg
    group = torch.where(sel_fg, 0, torch.where(sel_bg, 1, 2))
    order_key = group * (n * 2) + torch.arange(n, device=cand.device)
    order = torch.argsort(order_key, dim=1)[:, :sample_size]
    sel_s = torch.gather(sel, 1, order)
    rois_s = torch.gather(cand, 1, order[..., None].expand(*order.shape, 4))
    rois_s = torch.where(sel_s[..., None], rois_s, torch.zeros_like(rois_s))
    matched_s = torch.gather(matched, 1, order)
    fg_s = torch.gather(sel_fg, 1, order)
    gt_s = torch.gather(gt_boxes, 1, matched_s[..., None].expand(*matched_s.shape, 4))
    labels = torch.where(fg_s, torch.gather(gt_classes, 1, matched_s).to(torch.int32),
                         torch.zeros_like(matched_s, dtype=torch.int32))
    targets = box_ops.encode_boxes(gt_s, rois_s, weights=box_weights, offset=offset)
    targets = torch.where(fg_s[..., None], targets, torch.zeros_like(targets))
    return RoiTargets(
        rois=rois_s,
        labels=labels,
        weights=sel_s.float(),
        box_targets=targets,
        box_weights=fg_s.float(),
        matched_idx=torch.where(fg_s, matched_s, torch.zeros_like(matched_s)).to(torch.int32),
        num_fg=fg_s.float().sum(1),
    )
