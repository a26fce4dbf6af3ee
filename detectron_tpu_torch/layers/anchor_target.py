"""Anchor target assignment with static shapes, batched over images.

The port of ``detectron_tpu/layers/anchor_target.py``: IoU(anchors, gt)
gives positive / negative / ignore labels by thresholds, the best anchor(s)
of every gt are forced positive (ties included), and the 256-anchor RPN
sample is a rank-based random selection under a cap. The matching is
``ops/anchor_match.py`` (a hand-written kernel on CUDA tensors), inside the
span ``anchor match``.

Randomness comes in as tensors: every function that samples takes its
uniform draws in ``[0, 1)`` as an argument (``[B, N]`` per selection), in
place of the JAX package's ``jax.random.uniform(key, (N,))``. Callers make
them from a ``torch.Generator``; tests hand both sides the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from detectron_tpu_torch.ops import anchor_match as matching
from detectron_tpu_torch.ops import boxes as box_ops
from detectron_tpu_torch.ops.nms import sort_desc
from detectron_tpu_torch.utils.spans import span


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # [B, N] int32: -1 ignore, 0 bg, >0 matched gt class
    matched_idx: torch.Tensor  # [B, N] int32 index into the gt arrays
    cls_weights: torch.Tensor  # [B, N] float: 1 where the cls loss counts
    box_targets: torch.Tensor  # [B, N, 4] encoded regression targets
    box_weights: torch.Tensor  # [B, N] float: 1 where the box loss counts
    num_pos: torch.Tensor  # [B] float


def rank_select(eligible: torch.Tensor, cap: torch.Tensor, noise: torch.Tensor,
                max_cap: int = 0) -> torch.Tensor:
    """Selects up to ``cap [B]`` of the ``eligible [B, N]`` entries, the
    ones with the smallest ``noise`` (a uniform draw per entry): a random
    choice without replacement with static shapes. Returns a bool mask.

    With ``max_cap < N`` (a static bound on ``cap``), the selection is a
    bounded top-``max_cap`` of the noise and a scatter, as the JAX
    package's ``top_k`` branch; otherwise a full argsort rank. Ties order
    by index in both, as ``jax.lax.top_k`` and ``jnp.argsort`` do.
    """
    n = eligible.shape[-1]
    cap = cap[..., None]
    if max_cap and max_cap < n:
        score = torch.where(eligible, noise, torch.full_like(noise, -1.0))
        top_v, top_i = sort_desc(score)
        top_v, top_i = top_v[..., :max_cap], top_i[..., :max_cap]
        slot = torch.arange(max_cap, device=noise.device)
        take = (slot < cap) & (top_v > -0.5)
        return torch.zeros_like(eligible).scatter(-1, top_i, take)
    score = torch.where(eligible, noise, torch.full_like(noise, 2.0))
    order = torch.sort(score, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=noise.device).expand_as(order).contiguous())
    return eligible & (rank < cap)


def anchor_target(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                  noise_pos: torch.Tensor | None, noise_neg: torch.Tensor | None,
                  pos_iou: float, neg_iou: float, force_match: bool = True,
                  sample_size: int = 0, pos_fraction: float = 0.5,
                  box_weights=(1.0, 1.0, 1.0, 1.0), offset: float = 0.0) -> AnchorTargets:
    """Batched assignment. anchors ``[N, 4]``; gt_boxes ``[B, G, 4]``;
    gt_classes ``[B, G]`` (0 = padding row); noise_pos / noise_neg
    ``[B, N]`` uniform draws for the positive and the negative sample
    (unused, and may be None, when ``sample_size=0``, as for RetinaNet)."""
    with span("anchor match"):
        matched, pos, neg = matching.anchor_match(anchors, gt_boxes, gt_classes, pos_iou,
                                                  neg_iou, force_match, offset)

    if sample_size:
        pos_cap = torch.clamp(pos.sum(1), max=int(sample_size * pos_fraction))
        sel_pos = rank_select(pos, pos_cap, noise_pos, max_cap=sample_size)
        neg_cap = sample_size - sel_pos.sum(1)
        sel_neg = rank_select(neg, neg_cap, noise_neg, max_cap=sample_size)
        cls_w = (sel_pos | sel_neg).float()
        pos_w = sel_pos.float()
    else:
        cls_w = (pos | neg).float()  # in-between stays ignored
        pos_w = pos.float()

    gt_rows = torch.gather(gt_boxes, 1, matched[..., None].expand(*matched.shape, 4))
    gt_cls = torch.gather(gt_classes, 1, matched).to(torch.int32)
    labels = torch.where(pos, gt_cls, torch.where(neg, 0, -1).to(torch.int32))
    targets = box_ops.encode_boxes(gt_rows, anchors, weights=box_weights, offset=offset)
    targets = torch.where(pos[..., None], targets, torch.zeros_like(targets))
    return AnchorTargets(
        labels=labels,
        matched_idx=matched.to(torch.int32),
        cls_weights=cls_w,
        box_targets=targets,
        box_weights=pos_w,
        num_pos=pos_w.sum(1),
    )
