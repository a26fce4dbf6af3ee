"""Proposal generation: per-level top-k, decode, clip, NMS, cross-level top-k.

The port of ``detectron_tpu/layers/proposal.py`` with the same padded
contract. The pre-NMS cut is an exact top-k (the JAX package's
``approx_max_k`` is exact on the CPU, where it is the reference), ordered
as ``jax.lax.top_k`` orders ties. All (image, level) NMS problems go to
one batched NMS call, which is one launch of kernel K1 on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from detectron_tpu_torch.ops import boxes as box_ops
from detectron_tpu_torch.ops.nms import NEG_INF, nms_padded_batched, sort_desc


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [B, P, 4]
    scores: torch.Tensor  # [B, P]
    valid: torch.Tensor  # [B, P] bool


def topk_desc(x: torch.Tensor, k: int):
    """Top ``k`` along the last dim, descending, ties in index order."""
    values, idx = sort_desc(x)
    return values[..., :k], idx[..., :k]


def generate_proposals(
    scores_per_level: Sequence[torch.Tensor],  # [B, Nl] objectness logits
    deltas_per_level: Sequence[torch.Tensor],  # [B, Nl, 4]
    anchors_per_level: Sequence[torch.Tensor],  # [Nl, 4]
    image_hw: torch.Tensor,  # [B, 2]
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_thresh: float = 0.7,
    min_size: float = 0.0,
) -> Proposals:
    """RPN proposals for a batch. Scores are raw logits for ranking; the
    returned scores are their sigmoids."""
    b = image_hw.shape[0]
    hgt, wid = image_hw[:, 0, None], image_hw[:, 1, None]
    cand_boxes, cand_scores, cand_valid = [], [], []
    for s, d, anc in zip(scores_per_level, deltas_per_level, anchors_per_level):
        k = min(pre_nms_topk, s.shape[1])
        top_s, top_i = topk_desc(s, k)  # [B, k]
        top_d = torch.gather(d, 1, top_i[..., None].expand(b, k, 4))
        boxes = box_ops.decode_boxes(top_d, anc[top_i])
        boxes = box_ops.clip_boxes(boxes, hgt, wid)
        ok = box_ops.valid_box_mask(boxes, min_size)
        pad = pre_nms_topk - k
        if pad:
            boxes = torch.cat([boxes, boxes.new_zeros((b, pad, 4))], 1)
            top_s = torch.cat([top_s, top_s.new_full((b, pad), NEG_INF)], 1)
            ok = torch.cat([ok, ok.new_zeros((b, pad))], 1)
        cand_boxes.append(boxes)
        cand_scores.append(top_s)
        cand_valid.append(ok)
    num_levels = len(cand_boxes)
    boxes = torch.stack(cand_boxes, 1)  # [B, L, K, 4]
    scores = torch.stack(cand_scores, 1)  # [B, L, K]
    valid = torch.stack(cand_valid, 1)

    # one NMS problem per (image, level), all in one batched call
    keep_cap = min(post_nms_topk, pre_nms_topk)
    g = b * num_levels
    idx, keep_valid = nms_padded_batched(
        boxes.reshape(g, pre_nms_topk, 4), scores.reshape(g, pre_nms_topk),
        valid.reshape(g, pre_nms_topk), nms_thresh, keep_cap)
    idx = idx.long()
    kept_boxes = torch.gather(boxes.reshape(g, pre_nms_topk, 4), 1,
                              idx[..., None].expand(g, keep_cap, 4))
    kept_scores = torch.gather(scores.reshape(g, pre_nms_topk), 1, idx)
    kept_scores = torch.where(keep_valid, kept_scores, torch.full_like(kept_scores, NEG_INF))

    # cross-level top-K by score
    flat_boxes = kept_boxes.reshape(b, num_levels * keep_cap, 4)
    flat_scores = kept_scores.reshape(b, num_levels * keep_cap)
    top_s, top_i = topk_desc(flat_scores, post_nms_topk)
    out_valid = top_s > -1e9
    out_boxes = torch.gather(flat_boxes, 1, top_i[..., None].expand(b, post_nms_topk, 4))
    return Proposals(
        boxes=torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes)),
        scores=torch.where(out_valid, torch.sigmoid(top_s), torch.zeros_like(top_s)),
        valid=out_valid,
    )
