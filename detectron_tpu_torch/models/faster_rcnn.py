"""Faster / Mask R-CNN: the two-stage skeleton, its eval and train passes.

The port of ``detectron_tpu/models/faster_rcnn.py``. Eval: backbone + FPN
-> RPN per level -> proposals -> 7x7 RoIAlign -> 2xFC box head -> softmax
+ per-class decode -> class-aware NMS -> (14x14 RoIAlign -> mask head ->
own-class sigmoid); with ``roi.pool_type=pool`` both heads pool with
RoIPool's exact max instead of RoIAlign. Train: the RPN losses on sampled anchors, proposals
from the detached RPN outputs, sampled RoIs, the box losses and the mask
loss on the foreground slots. Every output has a fixed number of slots and
a validity mask, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from detectron_tpu_torch.layers.anchor_target import anchor_target
from detectron_tpu_torch.layers.mask_target import crop_gt_masks_batched
from detectron_tpu_torch.layers.proposal import Proposals, generate_proposals, topk_desc
from detectron_tpu_torch.layers.proposal_target import RoiTargets, sample_rois
from detectron_tpu_torch.models import losses
from detectron_tpu_torch.models.fpn import FPN
from detectron_tpu_torch.models.heads import BoxHead, MaskHead, RPNHead
from detectron_tpu_torch.models.precision import compute_dtype
from detectron_tpu_torch.models.resnet import ResNet
from detectron_tpu_torch.ops import boxes as box_ops
from detectron_tpu_torch.ops.anchors import AnchorGenerator
from detectron_tpu_torch.ops.nms import class_aware_nms
from detectron_tpu_torch.ops.roi_align import (multilevel_roi_align, multilevel_roi_pool,
                                               roi_max_span)

RPN_STRIDES = (4, 8, 16, 32, 64)  # P2..P6
ROI_STRIDES = (4, 8, 16, 32)  # box/mask heads pool from P2..P5


class Detections(NamedTuple):
    """Fixed-size padded detections."""

    boxes: torch.Tensor  # [B, D, 4]
    scores: torch.Tensor  # [B, D]
    classes: torch.Tensor  # [B, D] int32, 1-based (0 = padding)
    valid: torch.Tensor  # [B, D] bool


def rpn_anchor_generator(cfg) -> AnchorGenerator:
    scales = tuple(cfg.anchors.rpn_scales)
    return AnchorGenerator(
        strides=RPN_STRIDES,
        ratios=cfg.anchors.ratios,
        # extra scales as octaves of the first, so anchors/cell matches the
        # head's output channels
        octave_scales=tuple(s / scales[0] for s in scales),
        base_scale=scales[0],
    )


# The layout of the convolutions, per compute dtype, as measured on the
# card with the same weights (PERF.md): cuDNN's float32 kernels are
# NCHW (channels-last took a float32 predict call from 53.2-53.7 to
# 58.7-59.0 ms), its bf16 tensor-core kernels NHWC (channels-last took the
# bench's bf16 predict call at batch 48 from 216 to 171 ms and its training
# step at batch 16 from 166 to 122 ms; at batch 2, where the host sets the
# pace, it is 3-4% faster).
CHANNELS_LAST = {torch.float32: False, torch.bfloat16: True}


class TwoStageDetector(nn.Module):
    """Backbone + FPN + RPN + box head (+ mask head), with the JAX module's
    methods: ``features``, ``rpn``, ``box``, ``mask``. ``forward`` is the
    whole eval pass (:func:`faster_rcnn_eval_forward`) or, given targets,
    the training pass (:func:`faster_rcnn_train_forward`).

    ``dtype`` (``model.dtype``) is the compute dtype of every layer; the
    parameters stay float32. The proposals, the detection boxes and the
    RoIs stay float32 whatever the dtype (decode promotes against the
    float32 anchors and RoIs), so K1 and the level routing see float32;
    objectness, deltas, class and mask logits, scores and pooled features
    come in ``dtype``."""

    def __init__(self, cfg, include_mask: bool = False):
        super().__init__()
        self.cfg = cfg
        self.include_mask = include_mask
        self.dtype = dt = compute_dtype(cfg.model.dtype)
        ch = cfg.model.fpn_channels
        # model.dilate_c5 is R-FCN's alone: the JAX two-stage detector does
        # not read it (its FPN takes c5 at stride 32)
        self.backbone = ResNet(
            depth=cfg.model.backbone, frozen_stages=cfg.model.frozen_stages,
            norm=cfg.model.norm, stem=cfg.model.stem, remat=cfg.model.remat, dtype=dt)
        self.fpn = FPN(self.backbone.out_channels, ch, levels="p2p6", dtype=dt)
        self.rpn_head = RPNHead(ch, len(cfg.anchors.ratios) * len(cfg.anchors.rpn_scales),
                                dtype=dt)
        p = cfg.roi.pool_size
        self.box_head = BoxHead(ch * p * p, cfg.model.num_classes,
                                class_agnostic=cfg.roi.class_agnostic_regression, dtype=dt)
        if include_mask:
            self.mask_head = MaskHead(ch, cfg.model.num_classes, dtype=dt)
        self.set_channels_last(CHANNELS_LAST[dt])
        self._anchors = {}

    def set_channels_last(self, on: bool) -> None:
        """Runs the convolutions channels-last (NHWC in memory) or NCHW. The
        levels are NHWC for RoIAlign either way: channels-last hands them
        to RoIAlign and the RPN head without a copy, NCHW copies each level
        once a call each way."""
        self.memory_format = torch.channels_last if on else torch.contiguous_format
        for m in self.modules():
            if m is not self and hasattr(m, "memory_format"):
                m.memory_format = self.memory_format

    def anchors(self, image_shape, device) -> list[torch.Tensor]:
        """Per-level RPN anchors of a padded canvas, made once per shape."""
        key = (tuple(image_shape), str(device))
        if key not in self._anchors:
            gen = rpn_anchor_generator(self.cfg)
            self._anchors[key] = [torch.as_tensor(a, device=device)
                                  for a in gen.grid_anchors(tuple(image_shape))]
        return self._anchors[key]

    def features(self, images):
        """NHWC images ``[B, H, W, 3]`` (float32) -> NHWC levels P2..P6 in the
        compute dtype."""
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=self.memory_format)
        return [p.permute(0, 2, 3, 1).contiguous()
                for p in self.fpn(self.backbone(x))]

    def rpn(self, levels):
        outs = [self.rpn_head(p.permute(0, 3, 1, 2).contiguous(
            memory_format=self.memory_format)) for p in levels]
        return [o[0] for o in outs], [o[1] for o in outs]

    def _pool(self, levels, rois, size):
        pooled = levels[: len(ROI_STRIDES)]
        if self.cfg.roi.pool_type == "pool":
            # exact dynamic-bin max RoIPool (plain PyTorch, no kernel), with
            # the JAX model's window of 32 cells whatever roi.window says
            return multilevel_roi_pool(pooled, rois.contiguous(), ROI_STRIDES,
                                       output_size=size)
        span = roi_max_span(self.cfg, pooled[-1].shape[1:3])
        return multilevel_roi_align(pooled, rois.contiguous(), ROI_STRIDES,
                                    output_size=size,
                                    sampling_ratio=self.cfg.roi.sampling_ratio,
                                    max_span=span)

    def box(self, levels, rois):
        return self.box_head(self._pool(levels, rois, self.cfg.roi.pool_size))

    def mask(self, levels, rois):
        return self.mask_head(self._pool(levels, rois, self.cfg.roi.mask_pool_size))

    def forward(self, images, image_hw, with_masks: bool = False, targets=None, draws=None,
                mark=None):
        """The eval pass, or with ``targets`` (``gt_boxes``, ``gt_classes``
        and optionally ``gt_masks``) and ``draws`` the training pass's
        loss dict (``mark``: see :func:`faster_rcnn_train_forward`)."""
        if targets is not None:
            return faster_rcnn_train_forward(
                self, images, image_hw, targets["gt_boxes"], targets["gt_classes"],
                draws, self.cfg, gt_masks=targets.get("gt_masks"), mark=mark)
        return faster_rcnn_eval_forward(self, images, image_hw, self.cfg,
                                        with_masks=with_masks)


def build_two_stage(cfg, include_mask: bool) -> TwoStageDetector:
    return TwoStageDetector(cfg, include_mask=include_mask)


def proposals_from_rpn(scores_pl, deltas_pl, anchors_pl, image_hw, cfg,
                       train: bool = False) -> Proposals:
    return generate_proposals(
        scores_pl, deltas_pl, anchors_pl, image_hw,
        pre_nms_topk=cfg.rpn.pre_nms_topk_train if train else cfg.rpn.pre_nms_topk_test,
        post_nms_topk=cfg.rpn.post_nms_topk_train if train else cfg.rpn.post_nms_topk_test,
        nms_thresh=cfg.rpn.nms_thresh,
        min_size=cfg.rpn.min_size,
    )


def detection_candidates(cls_logits, reg, rois, roi_valid, image_hw, cfg):
    """The candidates that enter the detection NMS: softmax, per-class
    decode, clip, score threshold, top ``min(post_nms_topk_test*4, R*K)``.
    Returns ``(boxes [B, T, 4], scores [B, T], classes [B, T], valid [B, T])``."""
    b, r, kp1 = cls_logits.shape
    k = kp1 - 1
    weights = cfg.roi.bbox_reg_weights
    topk_cand = min(cfg.rpn.post_nms_topk_test * 4, r * k)
    probs = torch.softmax(cls_logits, dim=-1)[..., 1:]  # [B, R, K]
    if reg.shape[2] == 1:
        boxes = box_ops.decode_boxes(reg[:, :, 0], rois, weights)
        boxes = boxes[:, :, None, :].expand(b, r, k, 4)
    else:
        boxes = box_ops.decode_boxes(reg[:, :, 1:], rois[:, :, None, :], weights)
    boxes = box_ops.clip_boxes(boxes, image_hw[:, 0, None, None],
                               image_hw[:, 1, None, None])
    flat_scores = probs.reshape(b, r * k)
    flat_boxes = boxes.reshape(b, r * k, 4)
    flat_cls = torch.arange(1, kp1, dtype=torch.int32, device=rois.device).repeat(r)
    flat_valid = (roi_valid.repeat_interleave(k, dim=1)
                  & (flat_scores > cfg.test.score_thresh))
    top_s, top_i = topk_desc(
        torch.where(flat_valid, flat_scores, torch.full_like(flat_scores, -1.0)),
        topk_cand)
    cand_boxes = torch.gather(flat_boxes, 1, top_i[..., None].expand(b, topk_cand, 4))
    return cand_boxes, top_s, flat_cls[top_i], top_s > 0.0


def fastrcnn_inference(cls_logits, reg, rois, roi_valid, image_hw, cfg) -> Detections:
    """Detection post-processing: :func:`detection_candidates`, then
    class-aware NMS to ``test.detections_per_image`` slots."""
    cand_boxes, cand_scores, cand_cls, cand_valid = detection_candidates(
        cls_logits, reg, rois, roi_valid, image_hw, cfg)
    d = cfg.test.detections_per_image
    idx, keep = class_aware_nms(cand_boxes, cand_scores, cand_cls,
                                cfg.test.nms_thresh, d, valid=cand_valid)
    idx = idx.long()
    boxes = torch.gather(cand_boxes, 1, idx[..., None].expand(-1, d, 4))
    return Detections(
        boxes=torch.where(keep[..., None], boxes, torch.zeros_like(boxes)),
        scores=torch.where(keep, torch.gather(cand_scores, 1, idx),
                           torch.zeros_like(keep, dtype=cand_scores.dtype)),
        classes=torch.where(keep, torch.gather(cand_cls, 1, idx),
                            torch.zeros_like(keep, dtype=cand_cls.dtype)),
        valid=keep,
    )


class TrainDraws(NamedTuple):
    """The uniform draws in ``[0, 1)`` that one training forward samples
    with: the RPN's positive and negative anchor samples ``[B, N]`` (N
    anchors) and the RoI head's foreground and background samples
    ``[B, P + G]`` (P proposals, G gt slots)."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor


def make_train_draws(generator: torch.Generator, batch: int, num_anchors: int,
                     num_candidates: int) -> TrainDraws:
    """Draws for one step from ``generator``, on its device."""
    def draw(n):
        return torch.rand((batch, n), generator=generator, device=generator.device)

    return TrainDraws(draw(num_anchors), draw(num_anchors), draw(num_candidates),
                      draw(num_candidates))


def rpn_losses(scores_pl, deltas_pl, anchors, gt_boxes, gt_classes, draws: TrainDraws, cfg):
    """RPN objectness and box losses on a ``rpn.batch_per_image`` anchor
    sample per image."""
    scores = torch.cat(scores_pl, dim=1)  # [B, N]
    deltas = torch.cat(deltas_pl, dim=1)  # [B, N, 4]
    tgt = anchor_target(
        anchors, gt_boxes, gt_classes, draws.rpn_pos, draws.rpn_neg,
        pos_iou=cfg.rpn.positive_iou, neg_iou=cfg.rpn.negative_iou,
        force_match=True, sample_size=cfg.rpn.batch_per_image,
        pos_fraction=cfg.rpn.positive_fraction)
    labels = (tgt.labels > 0).to(scores.dtype)
    ce = losses.optax_sigmoid_ce(scores, labels)
    norm = tgt.cls_weights.sum().clamp_min(1.0)
    cls_loss = (ce * tgt.cls_weights).sum() / norm
    box_l = losses.smooth_l1(deltas, tgt.box_targets, sigma=cfg.rpn.smooth_l1_sigma)
    box_loss = (box_l.sum(-1) * tgt.box_weights).sum() / norm
    return {"loss_rpn_cls": cls_loss, "loss_rpn_box": box_loss}


def frcnn_box_losses(cls_logits, reg, roi_targets: RoiTargets, cfg):
    """Softmax cross-entropy and class-aware smooth-L1 over the sampled RoIs."""
    b, s = cls_logits.shape[:2]
    norm = roi_targets.weights.sum().clamp_min(1.0)
    cls_loss = losses.softmax_cross_entropy(
        cls_logits.reshape(b * s, -1), roi_targets.labels.reshape(-1),
        weights=roi_targets.weights.reshape(-1), normalizer=norm)
    if reg.shape[2] == 1:
        sel = reg[:, :, 0]
    else:
        k = torch.clamp(roi_targets.labels.long(), 0, reg.shape[2] - 1)
        sel = torch.take_along_dim(reg, k[..., None, None], dim=2)[:, :, 0]
    box_l = losses.smooth_l1(sel, roi_targets.box_targets, sigma=cfg.roi.smooth_l1_sigma)
    box_loss = (box_l.sum(-1) * roi_targets.box_weights).sum() / norm
    return {"loss_cls": cls_loss, "loss_box": box_loss}


def _no_mark(stage: str) -> None:
    pass


def faster_rcnn_train_forward(model: TwoStageDetector, images, image_hw, gt_boxes,
                              gt_classes, draws, cfg, anchors_pl=None, gt_masks=None,
                              mark=None):
    """One training forward: the loss dict of the RPN, the box head and,
    with ``gt_masks``, the mask head. ``draws`` is a :class:`TrainDraws`
    or a ``torch.Generator`` to make one from. ``mark``, if given, is
    called with each stage's name once the stage's work has been issued,
    so that a caller can time the stages (with CUDA events, say)."""
    mark = mark or _no_mark
    if anchors_pl is None:
        anchors_pl = model.anchors(images.shape[1:3], images.device)
    anchors_all = torch.cat(anchors_pl, dim=0)
    if isinstance(draws, torch.Generator):
        draws = make_train_draws(
            draws, images.shape[0], anchors_all.shape[0],
            cfg.rpn.post_nms_topk_train + gt_boxes.shape[1])
    mark("anchors+draws")

    levels = model.features(images)
    mark("backbone+fpn")
    scores_pl, deltas_pl = model.rpn(levels)
    mark("rpn head")
    loss_dict = rpn_losses(scores_pl, deltas_pl, anchors_all, gt_boxes, gt_classes,
                           draws, cfg)
    mark("rpn targets+loss")
    props = proposals_from_rpn([s.detach() for s in scores_pl],
                               [d.detach() for d in deltas_pl],
                               anchors_pl, image_hw, cfg, train=True)
    mark("proposals (K1)")
    tgt = sample_rois(
        props.boxes, props.valid, gt_boxes, gt_classes, draws.roi_fg, draws.roi_bg,
        sample_size=cfg.roi.batch_per_image,
        positive_fraction=cfg.roi.positive_fraction,
        positive_iou=cfg.roi.positive_iou,
        negative_iou_hi=cfg.roi.negative_iou_hi,
        negative_iou_lo=cfg.roi.negative_iou_lo,
        box_weights=cfg.roi.bbox_reg_weights)
    mark("roi sampling")
    cls_logits, reg = model.box(levels, tgt.rois)
    loss_dict.update(frcnn_box_losses(cls_logits, reg, tgt, cfg))
    mark("box: align (K2) + head + loss")

    if model.include_mask and gt_masks is not None:
        # the mask loss sees only fg RoIs, and the sampler puts the selected
        # fg in the front slots: the mask head runs on the fg capacity
        cap = max(int(cfg.roi.batch_per_image * cfg.roi.positive_fraction), 1)
        rois_m = tgt.rois[:, :cap]
        mask_logits = model.mask(levels, rois_m)
        mask_targets = crop_gt_masks_batched(gt_masks, gt_boxes, rois_m,
                                             tgt.matched_idx[:, :cap],
                                             resolution=cfg.mask.resolution)
        b, s = tgt.labels[:, :cap].shape
        loss_dict["loss_mask"] = losses.mask_bce_loss(
            mask_logits.reshape(b * s, *mask_logits.shape[2:]),
            mask_targets.reshape(b * s, *mask_targets.shape[2:]),
            tgt.labels[:, :cap].reshape(-1), tgt.box_weights[:, :cap].reshape(-1))
        mark("mask: targets + align (K2) + head + loss")
    return loss_dict


def faster_rcnn_eval_forward(model: TwoStageDetector, images, image_hw, cfg,
                             anchors_pl=None, with_masks: bool = False):
    """One eval pass: ``(Detections, mask probabilities [B, D, 28, 28] |
    None)``. ``images`` are NHWC ``[B, H, W, 3]``, ``image_hw`` ``[B, 2]``."""
    if anchors_pl is None:
        anchors_pl = model.anchors(images.shape[1:3], images.device)
    levels = model.features(images)
    scores_pl, deltas_pl = model.rpn(levels)
    props = proposals_from_rpn(scores_pl, deltas_pl, anchors_pl, image_hw, cfg)
    cls_logits, reg = model.box(levels, props.boxes)
    dets = fastrcnn_inference(cls_logits, reg, props.boxes, props.valid,
                              image_hw, cfg)
    if not (with_masks and model.include_mask):
        return dets, None
    mask_logits = model.mask(levels, dets.boxes)  # [B, D, 28, 28, K-1]
    k = torch.clamp(dets.classes.long() - 1, 0, mask_logits.shape[-1] - 1)
    own = torch.take_along_dim(mask_logits, k[:, :, None, None, None], dim=-1)[..., 0]
    return dets, torch.sigmoid(own)
