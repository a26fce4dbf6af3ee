"""Faster / Mask R-CNN inference: the two-stage skeleton.

The port of the eval path of ``detectron_tpu/models/faster_rcnn.py``:
backbone + FPN -> RPN per level -> proposals -> 7x7 RoIAlign -> 2xFC box
head -> softmax + per-class decode -> class-aware NMS -> (14x14 RoIAlign ->
mask head -> own-class sigmoid). Every output has a fixed number of slots
and a validity mask, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from detectron_tpu_torch.layers.proposal import Proposals, generate_proposals, topk_desc
from detectron_tpu_torch.models.fpn import FPN
from detectron_tpu_torch.models.heads import BoxHead, MaskHead, RPNHead
from detectron_tpu_torch.models.resnet import ResNet
from detectron_tpu_torch.ops import boxes as box_ops
from detectron_tpu_torch.ops.anchors import AnchorGenerator
from detectron_tpu_torch.ops.nms import class_aware_nms
from detectron_tpu_torch.ops.roi_align import multilevel_roi_align, roi_max_span

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


class TwoStageDetector(nn.Module):
    """Backbone + FPN + RPN + box head (+ mask head), with the JAX module's
    methods: ``features``, ``rpn``, ``box``, ``mask``. ``forward`` is the
    whole eval pass (:func:`faster_rcnn_eval_forward`)."""

    def __init__(self, cfg, include_mask: bool = False):
        super().__init__()
        if cfg.model.dtype != "float32":
            raise NotImplementedError(
                f"model.dtype={cfg.model.dtype!r}: the port runs float32 only; "
                "bf16 kernels are ROADMAP.md, Queue 2")
        self.cfg = cfg
        self.include_mask = include_mask
        ch = cfg.model.fpn_channels
        self.backbone = ResNet(
            depth=cfg.model.backbone, frozen_stages=cfg.model.frozen_stages,
            norm=cfg.model.norm, stem=cfg.model.stem,
            dilate_c5=cfg.model.dilate_c5, remat=cfg.model.remat)
        self.fpn = FPN(self.backbone.out_channels, ch, levels="p2p6")
        self.rpn_head = RPNHead(ch, len(cfg.anchors.ratios) * len(cfg.anchors.rpn_scales))
        p = cfg.roi.pool_size
        self.box_head = BoxHead(ch * p * p, cfg.model.num_classes,
                                class_agnostic=cfg.roi.class_agnostic_regression)
        if include_mask:
            self.mask_head = MaskHead(ch, cfg.model.num_classes)
        self._anchors = {}

    def anchors(self, image_shape, device) -> list[torch.Tensor]:
        """Per-level RPN anchors of a padded canvas, made once per shape."""
        key = (tuple(image_shape), str(device))
        if key not in self._anchors:
            gen = rpn_anchor_generator(self.cfg)
            self._anchors[key] = [torch.as_tensor(a, device=device)
                                  for a in gen.grid_anchors(tuple(image_shape))]
        return self._anchors[key]

    # The convolutions run on contiguous NCHW tensors: cuDNN's float32
    # kernels are NCHW, and channels-last inputs made it transpose around
    # every convolution. The NHWC levels the RoIAlign kernel reads are one
    # copy per level, made once per call.
    def features(self, images):
        """NHWC images ``[B, H, W, 3]`` -> NHWC levels P2..P6."""
        x = images.permute(0, 3, 1, 2).contiguous()
        return [p.permute(0, 2, 3, 1).contiguous()
                for p in self.fpn(self.backbone(x))]

    def rpn(self, levels):
        outs = [self.rpn_head(p.permute(0, 3, 1, 2).contiguous()) for p in levels]
        return [o[0] for o in outs], [o[1] for o in outs]

    def _pool(self, levels, rois, size):
        pooled = levels[: len(ROI_STRIDES)]
        span = roi_max_span(self.cfg, pooled[-1].shape[1:3])
        return multilevel_roi_align(pooled, rois.contiguous(), ROI_STRIDES,
                                    output_size=size,
                                    sampling_ratio=self.cfg.roi.sampling_ratio,
                                    max_span=span)

    def box(self, levels, rois):
        return self.box_head(self._pool(levels, rois, self.cfg.roi.pool_size))

    def mask(self, levels, rois):
        return self.mask_head(self._pool(levels, rois, self.cfg.roi.mask_pool_size))

    def forward(self, images, image_hw, with_masks: bool = False):
        return faster_rcnn_eval_forward(self, images, image_hw, self.cfg,
                                        with_masks=with_masks)


def build_two_stage(cfg, include_mask: bool) -> TwoStageDetector:
    return TwoStageDetector(cfg, include_mask=include_mask)


def proposals_from_rpn(scores_pl, deltas_pl, anchors_pl, image_hw, cfg,
                       train: bool = False) -> Proposals:
    if train:
        raise NotImplementedError("training is not ported yet: ROADMAP.md, "
                                  "Queue 1, slice B")
    return generate_proposals(
        scores_pl, deltas_pl, anchors_pl, image_hw,
        pre_nms_topk=cfg.rpn.pre_nms_topk_test,
        post_nms_topk=cfg.rpn.post_nms_topk_test,
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
